"""Port parity: VoxelBackBone8x (the sparse backbone of `e2e_synthetic
--model voxel`) against the JAX package's, fp32 on both sides, weights
carried across by `params_from_jax`:

* eval forward at narrow widths with a stage cap that binds: every stage's
  coordinate set equal, the output features and height_compression within
  1e-4, and the BEV tensor's shape (the z extent after conv_out) equal;
* one train step (BN on batch statistics, loss = Σ height_compression · R):
  the loss within 1e-5 relative, every parameter's gradient within 1e-4 of
  its largest entry, the BN running statistics within 1e-5. Every BN bias
  is shifted by +3 on both sides, as in the train slice test: a ReLU input
  within fp32 rounding of 0 takes the other side of the kink under another
  summation order and moves upstream gradients by ~1 %;
* B2's calls in that step: 12 forward, then 11 for dX (conv_input's input
  needs no gradient);
* the detector's dispatch on BACKBONE_3D.FORMULATION (absent and gather
  build it, column builds ColumnVoxelBackBone8x with the same parameters,
  another value raises, the port reads no environment variable) and the
  2D backbone's input width of `e2e_synthetic.build_cfg(model="voxel")`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel, sparse_ops
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models.column_sparse import ColumnVoxelBackBone8x
from dfu3d_tpu_torch.models import sparse_backbone as sb
from dfu3d_tpu_torch.tools import e2e_synthetic
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_models import numpy_variables
from test_torch_port_sparse import PCR, VS, ground_points
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

GRID = sparse_ops.SparseGrid(128, 128, 40)
MAX_VOXELS = 4096         # the voxelizer's cap
VOXEL_CAP = 1200          # the backbone's: stage caps 600 / 300 / 150
CHANS, OUT_CH = (4, 8, 8, 16, 16), 8
BN_SHIFT = 3.0


@pytest.fixture(scope="module")
def setup():
    pts, valid = ground_points(np.random.RandomState(30), 2)
    vox = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), MAX_VOXELS)
    cap = MAX_VOXELS
    feats = np.random.RandomState(31).normal(0, 1, (2, cap, 4)).astype(np.float32)
    feats *= vox.voxel_valid.numpy()[..., None]
    jc, jv = jnp.asarray(vox.voxel_coords.numpy()), jnp.asarray(vox.voxel_valid.numpy())
    jmod = jsb.VoxelBackBone8x(grid=jsp.SparseGrid(*GRID), voxel_cap=VOXEL_CAP, channels=CHANS,
                               out_channels=OUT_CH, dtype=jnp.float32)
    variables = numpy_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jc, jv, train=False),
        seed=3)
    return vox, feats, jc, jv, jmod, variables


def port_backbone(variables, train=False):
    bb = sb.VoxelBackBone8x(GRID, VOXEL_CAP, in_channels=4, channels=CHANS,
                            out_channels=OUT_CH)
    return params_from_jax(variables, bb.train(train))


def test_forward_matches_jax(setup):
    vox, feats, jc, jv, jmod, variables = setup
    want = jax.jit(lambda f: jmod.apply(variables, f, jc, jv, train=False))(jnp.asarray(feats))
    bb = port_backbone(variables)
    with torch.no_grad():
        levels = bb.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
        got = bb(torch.from_numpy(feats), levels)
        bev = sb.height_compression(got)
    c, v, g = jc, jv, jsp.SparseGrid(*GRID)
    for i, lv in enumerate(levels[1:]):
        z_only = i == 3
        g = g.down_z() if z_only else g.down()
        c, v, _ = jax.vmap(lambda cc, vv: jsp.downsample_coords(
            g, cc, vv, lv.coords.shape[1], z_only=z_only))(c, v)
        assert tuple(lv.grid) == tuple(g)
        np.testing.assert_array_equal(lv.coords.numpy(), np.asarray(c))
        np.testing.assert_array_equal(lv.valid.numpy(), np.asarray(v))
    # the stride-2 cap binds; the later stages keep all their parents here
    assert (levels[1].num_unique > levels[1].coords.shape[1]).all()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=1e-4)
    jbev = np.asarray(jsb.height_compression(want))
    assert [lv.grid.nz for lv in levels] == [40, 20, 10, 5, 3]
    assert bev.shape == jbev.shape == (2, 16, 16, 3 * OUT_CH)
    assert bb.out_grid.nz * OUT_CH == jbev.shape[-1]
    np.testing.assert_allclose(bev.numpy(), jbev, atol=1e-4)
    assert np.abs(jbev).max() > 0.1


def _shift_bn_biases(variables):
    """Every bias of the backbone is a BN's (its convs have none)."""
    return {"params": jax.tree_util.tree_map_with_path(
                lambda path, x: x + BN_SHIFT if path[-1].key == "bias" else x,
                variables["params"]),
            "batch_stats": variables["batch_stats"]}


def test_train_step_matches_jax(setup, monkeypatch):
    vox, feats, jc, jv, jmod, variables = setup
    variables = _shift_bn_biases(variables)
    shifted = [k for k, v in jax.tree_util.tree_leaves_with_path(variables["params"])
               if k[-1].key == "bias"]
    assert len(shifted) == 12                                 # every BN of the 12 convs
    r = np.random.RandomState(32).normal(0, 1, (2, 16, 16, 3 * OUT_CH)).astype(np.float32)

    def j_loss(params):
        out, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(feats), jc, jv, train=True, mutable=["batch_stats"])
        return (jsb.height_compression(out) * jnp.asarray(r)).sum(), upd

    (j_val, j_upd), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])

    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(tuple(args[3].shape))
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    bb = port_backbone(variables, train=True)
    levels = bb.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique, transpose=True)
    st = bb(torch.from_numpy(feats), levels)
    assert len(calls) == 12
    loss = (sb.height_compression(st) * torch.from_numpy(r)).sum()
    loss.backward()
    assert len(calls) == 23
    # dX runs over the transposed weights, 11 convs in reverse order
    fwd = calls[:12]
    assert calls[12:] == [(k, co, ci) for k, ci, co in reversed(fwd[1:])]

    j_val = float(j_val)
    assert abs(loss.item() - j_val) <= 1e-5 * abs(j_val)
    want = params_from_jax({"params": jax.device_get(j_grads)}, None)
    got = {k: p.grad for k, p in bb.named_parameters()}
    assert set(got) == set(want) and len(got) == 12 + 2 * 12
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(w).max() > 1e-3, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    stats = params_from_jax({"batch_stats": jax.device_get(j_upd["batch_stats"])}, None)
    own = bb.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_init_draws_like_jax():
    """The sparse kernels start from JAX's initializer (truncated normal at
    fan-in K · Cin), not from zeros: a model trained from scratch through the
    CLIs learns."""
    torch.manual_seed(0)
    bb = sb.VoxelBackBone8x(GRID, 4000, in_channels=4)
    for name, p in bb.named_parameters():
        if p.dim() == 3:
            std = np.sqrt(1.0 / (p.shape[0] * p.shape[1]))
            assert abs(p.std().item() / std - 1) < 0.15, name
            assert p.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6, name


def synthetic_cfg(tmp_path, formulation):
    cfg_file = e2e_synthetic.build_cfg(tmp_path / "data", tmp_path, model="voxel")
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    if formulation is not None:
        cfg.MODEL.BACKBONE_3D.FORMULATION = formulation
    return cfg


@pytest.mark.parametrize("formulation", [None, "gather", "column", "other"])
def test_detector_dispatch(tmp_path, monkeypatch, formulation):
    monkeypatch.setenv("DFU3D_SPARSE_FORMULATION", "column")   # not read by the port
    cfg = synthetic_cfg(tmp_path, formulation)
    grid = voxel.VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                  cfg.DATA_CONFIG.DATA_PROCESSOR[-1].VOXEL_SIZE)
    build = lambda: build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device="cpu",  # noqa: E731
                                  max_voxels=32000)
    if formulation == "other":
        with pytest.raises(ValueError, match="FORMULATION"):
            build()
        return
    model = build()
    want = ColumnVoxelBackBone8x if formulation == "column" else sb.VoxelBackBone8x
    assert type(model.backbone_3d) is want
    if formulation == "column":
        gather = sb.VoxelBackBone8x(model.backbone_3d.grid, 32000, in_channels=4)
        assert {k: v.shape for k, v in model.backbone_3d.state_dict().items()} == \
            {k: v.shape for k, v in gather.state_dict().items()}
    assert grid.grid_size == (512, 512, 40)
    assert model.backbone_3d.out_grid == sparse_ops.SparseGrid(64, 64, 3)
    # height_compression's width is the YAML's NUM_BEV_FEATURES here
    assert model.backbone_2d.block0_down.Conv_0.weight.shape[1] == \
        cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES == 384
    assert model.backbone_3d.caps == [16000, 8000, 4000]
