"""Port parity for the voxel serving slice: voxel CenterPoint
(tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml, MeanVFE +
VoxelResBackBone8x) at full widths, predict + recall counters against the JAX
eval step on the same numpy weights, on a 12.8 m range (128 × 128 × 40 grid)
with a voxel cap of 2048 that binds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.train.train_state import TrainState
from dfu3d_tpu.train.train_state import make_eval_step as j_make_eval_step
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.train.train_state import make_eval_step
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
from dfu3d_tpu_torch.zoo import VOXEL_CFG, VOXEL_TINY_RANGE, voxel_centerpoint

from test_torch_port_models import numpy_variables
from test_torch_port_sparse import ground_points
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

THRESH = (0.3, 0.5, 0.7)
MAX_VOXELS = 2048


@pytest.fixture(scope="module")
def slice_outputs():
    """One JAX eval step and one port eval step on the same batch and weights."""
    jcfg = j_cfg_from_yaml_file(VOXEL_CFG, JCfgDict())
    jcfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(VOXEL_TINY_RANGE)
    jgrid = JVoxelGrid.create(VOXEL_TINY_RANGE, [0.1, 0.1, 0.2])
    jmodel = j_build_network(jcfg.MODEL, jcfg.CLASS_NAMES, jgrid, dtype=jnp.float32,
                             max_voxels=MAX_VOXELS)
    pts, valid = ground_points(np.random.RandomState(3), 2)
    gt = np.zeros((2, 32, 8), np.float32)
    gt_valid = np.zeros((2, 32), bool)
    gt_valid[:, :16] = True
    batch = PointBatch.from_numpy(pts, valid, gt, gt_valid)
    jbatch = JPointBatch(*(t.numpy() for t in batch))
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=11, gains={"backbone_3d/conv_input/SubMConv3d_0/kernel": 0.5,
                        "dense_head/fused_heads/out/kernel": 0.4})
    # boxes of a few metres (exp(dim) ≈ e) so that NMS suppresses and the
    # recall counters count; branch b of head h sits at out channels
    # 3·(6h + b) (center, center_z, dim, rot, vel, hm)
    out_bias = np.array(variables["params"]["dense_head"]["fused_heads"]["out"]["bias"])
    for h in range(6):
        out_bias[3 * (6 * h + 2):3 * (6 * h + 3)] += 1.0
    variables["params"]["dense_head"]["fused_heads"]["out"]["bias"] = out_bias
    cfg, grid, model = voxel_centerpoint(tiny=True, device="cpu")
    assert tuple(grid) == tuple(jgrid) and grid.grid_size == (128, 128, 40)
    assert model.vfe.max_voxels == 60000   # MAX_NUMBER_OF_VOXELS['test']
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device="cpu", max_voxels=MAX_VOXELS)
    params_from_jax(variables, model)

    # the valid gt slots become kept predictions shifted along x by 0 .. 0.75
    # of their length, so the recall counters see IoUs on both sides of
    # every threshold (predict does not read the gt; the second JAX call
    # reuses the first one's compile)
    state = TrainState(jnp.zeros((), jnp.int32), variables["params"],
                       variables["batch_stats"], None)
    j_step = jax.jit(j_make_eval_step(jmodel, recall_thresh=THRESH))
    boxes, _, _, kept_valid, _ = jax.device_get(j_step(state, jbatch))
    gt = batch.gt_boxes.clone()
    for i in range(2):
        kept = torch.from_numpy(np.asarray(boxes[i][kept_valid[i]]))
        for j in range(16):
            gt[i, j, :7] = kept[(7 * j) % len(kept), :7]
            gt[i, j, 0] += 0.05 * j * gt[i, j, 3]
    batch = batch._replace(gt_boxes=gt)
    want = jax.device_get(j_step(state, JPointBatch(*(t.numpy() for t in batch))))
    got = make_eval_step(model, recall_thresh=THRESH, device="cpu")(batch)
    return batch, model, got, want


def test_voxel_slice_matches_jax(slice_outputs):
    _, _, (gb, gs, gl, gv, grec), (wb, ws, wl, wv, wrec) = slice_outputs
    gb, gs, gl, gv = (t.numpy() for t in (gb, gs, gl, gv))
    wb, ws, wl, wv = (np.asarray(a) for a in (wb, ws, wl, wv))
    assert gb.shape == wb.shape == (2, 6 * 83, 9)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 100
    np.testing.assert_array_equal(gl[gv], wl[wv])
    # kept boxes as sets per sample, matched by position: near-equal scores
    # may order differently across the two frameworks
    for i in range(2):
        g_rows = np.concatenate([gb[i][gv[i]], gs[i][gv[i], None]], -1)
        w_rows = np.concatenate([wb[i][wv[i]], ws[i][wv[i], None]], -1)
        dist = np.abs(g_rows[:, None, :] - w_rows[None, :, :]).max(-1)
        match = dist.argmin(0)
        assert len(set(match.tolist())) == len(match)
        assert dist[match, np.arange(len(match))].max() <= 1e-4
    assert {k: int(v) for k, v in grec.items()} == {k: int(v) for k, v in wrec.items()}
    assert int(wrec["gt_num"]) == 32
    assert 32 > int(wrec["recall_rcnn_0.3"]) > int(wrec["recall_rcnn_0.7"]) > 0


def test_voxel_slice_stages(slice_outputs):
    """The workload is the one the test means: a voxel cap that binds, and
    submanifold neighbourhoods that are mostly not empty."""
    batch, model, _, _ = slice_outputs
    with torch.no_grad():
        _, vox = model.vfe(batch.points, batch.points_valid)
        levels = model.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
    assert (vox.num_unique > MAX_VOXELS).all() and bool(vox.voxel_valid.all())
    taps = (levels[0].subm_nbr < MAX_VOXELS).sum(-1).float()[levels[0].valid]
    assert taps.mean() >= 4.0
    assert [lv.grid.nz for lv in levels] == [40, 20, 10, 5, 3]
    assert model.backbone_2d.block0_down.Conv_0.weight.shape[1] == 3 * 128


def test_voxel_config_matches_jax_side():
    assert cfg_from_yaml_file(VOXEL_CFG, CfgDict()) == j_cfg_from_yaml_file(VOXEL_CFG, JCfgDict())
