"""Port parity for the whole serving slice: the flagship CenterPoint-pillar at
full widths on the 64 × 128 grid, predict + recall counters against the JAX
eval step on the same numpy weights; plus the port's rules (no JAX import,
no quiet CPU fallback)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.train.train_state import TrainState
from dfu3d_tpu.train.train_state import make_eval_step as j_make_eval_step
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data.batch import synthetic_batch
from dfu3d_tpu_torch.flagship import FLAGSHIP_CFG, flagship
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.train.eval_utils import eval_batches
from dfu3d_tpu_torch.train.train_state import TrainState as PortTrainState
from dfu3d_tpu_torch.train.train_state import make_eval_step, make_train_step
from dfu3d_tpu_torch.train.trainer import train_model
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_models import numpy_variables

REPO = Path(__file__).resolve().parents[1]
THRESH = (0.3, 0.5, 0.7)


@pytest.fixture(scope="module")
def slice_outputs():
    """One JAX eval step and one port eval step on the same batch and weights."""
    _, _, jmodel = graft._flagship(dtype=jnp.float32, tiny=True)
    batch = synthetic_batch(2, 2048, 32, 12.0, seed=3)
    jbatch = JPointBatch(*(t.numpy() for t in batch))
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=7, gains={"vfe/pfn_0/Dense_0/kernel": 0.3,
                       "dense_head/fused_heads/out/kernel": 0.4})
    # boxes of a few metres (exp(dim) ≈ e) so that NMS suppresses and the
    # recall counters count; branch b of head h sits at out channels
    # 3·(5h + b) (center, center_z, dim, rot, hm)
    out_bias = np.array(variables["params"]["dense_head"]["fused_heads"]["out"]["bias"])
    for h in range(6):
        out_bias[3 * (5 * h + 2):3 * (5 * h + 3)] += 1.0
    variables["params"]["dense_head"]["fused_heads"]["out"]["bias"] = out_bias
    _, _, model = flagship(tiny=True, device="cpu")
    params_from_jax(variables, model)

    # the valid gt slots become kept predictions shifted along x by 0 .. 0.75
    # of their length, so the recall counters see IoUs on both sides of
    # every threshold (predict does not read the gt)
    boxes, _, _, valid = make_eval_step(model, device="cpu")(batch)
    gt = batch.gt_boxes.clone()
    for i in range(2):
        kept = boxes[i][valid[i]]
        for j in range(16):
            gt[i, j, :7] = kept[(7 * j) % len(kept)]
            gt[i, j, 0] += 0.05 * j * gt[i, j, 3]
    batch = batch._replace(gt_boxes=gt)
    jbatch = JPointBatch(*(t.numpy() for t in batch))

    state = TrainState(jnp.zeros((), jnp.int32), variables["params"],
                       variables["batch_stats"], None)
    want = jax.device_get(jax.jit(j_make_eval_step(jmodel, recall_thresh=THRESH))(state, jbatch))
    got = make_eval_step(model, recall_thresh=THRESH, device="cpu")(batch)
    return batch, model, got, want


def test_whole_slice_matches_jax(slice_outputs):
    _, _, (gb, gs, gl, gv, grec), (wb, ws, wl, wv, wrec) = slice_outputs
    gb, gs, gl, gv = (t.numpy() for t in (gb, gs, gl, gv))
    wb, ws, wl, wv = (np.asarray(a) for a in (wb, ws, wl, wv))
    assert gb.shape == wb.shape == (2, 6 * 83, 7)
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


def test_eval_batches_sums_the_steps(slice_outputs):
    batch, model, (*_, grec), _ = slice_outputs
    second = synthetic_batch(2, 2048, 32, 12.0, seed=4)
    res = eval_batches(model, [batch, second], THRESH, device="cpu")
    rec2 = make_eval_step(model, THRESH, device="cpu")(second)[-1]
    assert res.metric == {k: int(grec[k]) + int(rec2[k]) for k in grec}
    assert len(res.preds) == len(res.batch_seconds) == 2
    assert res.preds[0][0].shape == (2, 498, 7) and res.preds[0][0].device.type == "cpu"


def test_synthetic_batch_and_config_match_jax_side():
    want = graft._synthetic_batch(2, 100, 8, 12.0)
    for got, w in zip(synthetic_batch(2, 100, 8, 12.0, seed=0), want):
        np.testing.assert_array_equal(got.numpy(), w)
    # the velocity columns come after every other draw: the rest is unchanged
    wide = synthetic_batch(2, 100, 8, 12.0, seed=0, velocity=True)
    assert wide.gt_boxes.shape == (2, 8, 10)
    np.testing.assert_array_equal(wide.gt_boxes[..., [*range(7), 9]].numpy(), want[2])
    assert wide.gt_boxes[..., 7:9].abs().max() <= 5 and wide.gt_boxes[..., 7:9].std() > 1
    assert cfg_from_yaml_file(FLAGSHIP_CFG, CfgDict()) == j_cfg_from_yaml_file(
        FLAGSHIP_CFG, JCfgDict())


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_from_yaml_file(FLAGSHIP_CFG, CfgDict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship(tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg.MODEL, cfg.CLASS_NAMES, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(None, THRESH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_batches(None, [], THRESH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model(PortTrainState(None, None), [], 1, "unused")


def test_port_imports_nothing_of_jax():
    """No module of the port (the train slice's too) and not chip_smoke.py
    imports JAX, flax, optax, the JAX package, or tqdm, tensorboard and PIL,
    which the card's machine lacks; the one exception is nuscenes2kitti's
    JPEG -> PNG step, which imports PIL where it runs and raises without it."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|flax|optax|dfu3d_tpu|tqdm|tensorboard|torch\.utils\.tensorboard"
        r"|PIL)"
        r"(\.|\s|$)", re.M)
    sources = sorted((REPO / "dfu3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {p.relative_to(REPO).as_posix() for p in sources}
    assert {"dfu3d_tpu_torch/models/losses.py", "dfu3d_tpu_torch/train/optimization.py",
            "dfu3d_tpu_torch/train/checkpoint.py", "dfu3d_tpu_torch/train/trainer.py",
            "dfu3d_tpu_torch/profile_train.py", "dfu3d_tpu_torch/utils/common.py",
            "dfu3d_tpu_torch/core/geometry/calibration.py", "dfu3d_tpu_torch/data/np_geometry.py",
            "dfu3d_tpu_torch/data/kitti_io.py", "dfu3d_tpu_torch/data/point_feature_encoder.py",
            "dfu3d_tpu_torch/data/augmentor_utils.py", "dfu3d_tpu_torch/data/data_augmentor.py",
            "dfu3d_tpu_torch/data/database_sampler.py", "dfu3d_tpu_torch/data/processor.py",
            "dfu3d_tpu_torch/data/dataset.py", "dfu3d_tpu_torch/data/kitti_dataset.py",
            "dfu3d_tpu_torch/data/loader.py", "dfu3d_tpu_torch/data/kitti_synthetic.py",
            "dfu3d_tpu_torch/eval/kitti_eval.py", "dfu3d_tpu_torch/eval/native.py",
            "dfu3d_tpu_torch/train/eval_utils.py", "dfu3d_tpu_torch/tools/common.py",
            "dfu3d_tpu_torch/tools/create_infos.py", "dfu3d_tpu_torch/tools/train.py",
            "dfu3d_tpu_torch/tools/test.py", "dfu3d_tpu_torch/tools/evolve.py",
            "dfu3d_tpu_torch/tools/e2e_synthetic.py", "dfu3d_tpu_torch/tools/nuscenes2kitti.py",
            "dfu3d_tpu_torch/data/nuscenes_tables.py",
            "dfu3d_tpu_torch/train/torch_convert.py"} <= names
    for path in sources:
        text = path.read_text()
        if path.name == "nuscenes2kitti.py":
            # its JPEG -> PNG step imports PIL inside the one function that
            # needs it, which runs only when a source image exists
            assert "\nfrom PIL" not in text and "\nimport PIL" not in text
            text = text.replace("        from PIL import Image\n", "", 1)
        hits = pattern.findall(text)
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
