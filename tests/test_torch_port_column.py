"""Port parity: the column formulation of VoxelBackBone8x
(`models/column_sparse.py`, BACKBONE_3D.FORMULATION column) against the JAX
package's, fp32 on both sides, from the same numpy inputs and weights (the
flax layout carried across by `params_from_jax`; JAX's variables are shaped
with `jax.eval_shape` and filled from numpy, never initialised eagerly):

* each function on a 16 x 16 x 8 grid, B=2, ~230 voxels a frame:
  `columns_from_voxels` (also at a column cap that binds, which pins the
  drop order), the neighbour columns, `downsample_columns` (also capped),
  `column_subm_conv`, `column_down_conv` and `column_zdown_conv` at even
  and odd z: indices and masks exactly equal, features within 1e-5;
* `ColumnVoxelBackBone8x`: the eval forward where a stage cap binds (the
  output coords and valid slot for slot, so every drop order and the final
  compaction's, features within 1e-4), and at caps that do not bind the
  train forward (features 1e-4, the BN running statistics 1e-5) and the
  gradient of sum(height_compression(out)^2) for every parameter (1e-3 of
  each leaf's largest entry), as tests/test_column_sparse.py holds the JAX
  forms;
* the port's column form against its gather form at caps that do not bind
  (torch only): the output set slot for slot (so the column form keeps the
  column-major slot order that VoxelNeXt's compact path and
  height_compression read), features, BN statistics and gradients, and no
  gather-GEMM launch;
* one served request of SECONDNet with the column trunk at
  tests/test_pointpillar.py's reduced grid against JAX's predict (keep
  masks and labels exact, boxes and scores within 1e-4);
* BACKBONE_3D.FORMULATION at the five JAX call sites of select_backbone8x
  (voxel CenterPoint, SECONDNet, MPPNet, BevFusion, VoxelNeXt's compact
  trunk): the port builds the class JAX builds, and raises ValueError where
  JAX does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import column_sparse as jcs
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid, gather_gemm_kernel
from dfu3d_tpu_torch.core.voxel.sparse_ops import SparseGrid, column_major_index
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import column_sparse as cs
from dfu3d_tpu_torch.models import sparse_backbone as sb
from dfu3d_tpu_torch.tools.common import _voxel_processor, build_model, model_grid
from dfu3d_tpu_torch.train.train_state import make_eval_step
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_model import make_batch
from test_pointpillar import CLASSES, second_grid, second_model_cfg
from test_torch_port_catalog import setup_tree
from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_voxel8x import synthetic_cfg

GRID = SparseGrid(16, 16, 8)
ODD = SparseGrid(16, 16, 5)
B, V, CIN = 2, 256, 4
CHANS, OUT_CH = (4, 8, 8, 16, 16), 8


def scene(seed, grid=GRID):
    """Seeded voxels: distinct cells, ~10 % invalid, in the voxelizer's
    column-major slot order, valid first; features zero where invalid."""
    rng = np.random.RandomState(seed)
    coords = np.stack([rng.randint(0, n, (B, V)) for n in grid], axis=-1).astype(np.int32)
    valid = np.zeros((B, V), bool)
    for e in range(B):
        lin = (coords[e, :, 2] * grid.ny + coords[e, :, 1]) * grid.nx + coords[e, :, 0]
        valid[e, np.unique(lin, return_index=True)[1]] = True
        valid[e, rng.rand(V) < 0.1] = False
        key = (coords[e, :, 1].astype(np.int64) * grid.nx + coords[e, :, 0]) * grid.nz \
            + coords[e, :, 2]
        order = np.argsort(np.where(valid[e], key, grid.num_cells), kind="stable")
        coords[e], valid[e] = coords[e][order], valid[e][order]
    feats = rng.randn(B, V, CIN).astype(np.float32)
    feats[~valid] = 0.0
    return feats, coords, valid


def t(a):
    return torch.from_numpy(np.array(a))


def jgrid(grid):
    return jsp.SparseGrid(*grid)


def columns(grid, cap, seed=0):
    """The scene's columns through the port, as numpy (colf, xy, valid, zmask)."""
    f, c, v = scene(seed, grid)
    return [x.numpy() for x in cs.columns_from_voxels(grid, t(f), t(c), t(v), cap)]


@pytest.mark.parametrize("cap", [V, 64])   # no cap binds / ~130 columns a frame, 64 kept
def test_columns_from_voxels_matches_jax(cap):
    f, c, v = scene(0)
    want = jcs.columns_from_voxels(jgrid(GRID), jnp.asarray(f), jnp.asarray(c), jnp.asarray(v),
                                   cap)
    got = cs.columns_from_voxels(GRID, t(f), t(c), t(v), cap)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    n_cols = got[2].sum(1)
    assert (n_cols == 64).all() if cap == 64 else (n_cols < cap).all()
    src, *_, num_cols = cs.column_slots(GRID, t(c), t(v), cap)
    assert ((num_cols > cap) == (cap == 64)).all()
    assert int(got[3].sum()) == (int(v.sum()) if cap == V else int((src < V).sum()))


@pytest.mark.parametrize("cap", [V, 32])
def test_neighbors_and_parents_match_jax(cap):
    _, xy, valid, _ = columns(GRID, V)
    jxy, jv = jnp.asarray(xy), jnp.asarray(valid)
    np.testing.assert_array_equal(
        cs._col_neighbors(GRID, t(xy), t(valid), t(xy), t(valid)).numpy(),
        np.asarray(jcs._col_neighbors(jgrid(GRID), jxy, jv, jxy, jv)))
    oxy, ovalid, num = cs.downsample_columns(GRID, t(xy), t(valid), cap)
    wxy, wvalid = jcs.downsample_columns(jgrid(GRID), jxy, jv, cap)
    np.testing.assert_array_equal(oxy.numpy(), np.asarray(wxy))
    np.testing.assert_array_equal(ovalid.numpy(), np.asarray(wvalid))
    assert ((num > cap) == (cap == 32)).all()
    got = cs._col_neighbors(GRID, oxy * 2, ovalid, t(xy), t(valid)).numpy()
    want = np.asarray(jcs._col_neighbors(jgrid(GRID), wxy * 2, wvalid, jxy, jv))
    np.testing.assert_array_equal(got, want)
    assert (got < V).any() and (got == V).any()   # found columns and the sentinel P


def test_column_subm_conv_matches_jax():
    colf, xy, valid, zm = columns(GRID, V)
    nbr = cs._col_neighbors(GRID, t(xy), t(valid), t(xy), t(valid))
    w = np.random.RandomState(5).normal(0, 0.3, (27, CIN, 6)).astype(np.float32)
    got = cs.column_subm_conv(t(colf), t(valid), t(zm), nbr, t(w))
    want = jcs.column_subm_conv(jnp.asarray(colf), jnp.asarray(valid), jnp.asarray(zm),
                                jnp.asarray(nbr.numpy()), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.5


@pytest.mark.parametrize("grid", [GRID, ODD], ids=["z8", "z5"])
def test_column_down_conv_matches_jax(grid):
    colf, xy, valid, zm = columns(grid, V)
    w = np.random.RandomState(6).normal(0, 0.3, (27, CIN, 6)).astype(np.float32)
    got = cs.column_down_conv(t(colf), t(valid), t(zm), t(xy), grid, 96, t(w))
    want = jcs.column_down_conv(jnp.asarray(colf), jnp.asarray(valid), jnp.asarray(zm),
                                jnp.asarray(xy), jgrid(grid), 96, jnp.asarray(w))
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    assert got[3].shape[-1] == -(-grid.nz // 2) and got[3].any()


@pytest.mark.parametrize("grid", [GRID, ODD], ids=["z8", "z5"])
def test_column_zdown_conv_matches_jax(grid):
    colf, _, valid, zm = columns(grid, V)
    w = np.random.RandomState(7).normal(0, 0.3, (3, CIN, 6)).astype(np.float32)
    got = cs.column_zdown_conv(t(colf), t(valid), t(zm), t(w))
    want = jcs.column_zdown_conv(jnp.asarray(colf), jnp.asarray(valid), jnp.asarray(zm),
                                 jnp.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)


def backbone_pair(cap, seed=3):
    """(JAX ColumnVoxelBackBone8x, its numpy variables, the port's with them)."""
    f, c, v = scene(0)
    jmod = jcs.ColumnVoxelBackBone8x(grid=jgrid(GRID), voxel_cap=cap, channels=CHANS,
                                     out_channels=OUT_CH)
    variables = numpy_variables(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), False), seed=seed)
    port = cs.ColumnVoxelBackBone8x(GRID, cap, CIN, channels=CHANS, out_channels=OUT_CH)
    return jmod, variables, params_from_jax(variables, port)


def test_backbone_eval_with_a_binding_cap_matches_jax():
    """voxel_cap 96: the frames' 154 and 160 columns meet the input cap of
    96 (the stage caps 48 / 24 / 16 hold their 40 / 12 / 4 parents)."""
    f, c, v = scene(0)
    jmod, variables, port = backbone_pair(96)
    want = jax.jit(lambda vs: jmod.apply(vs, jnp.asarray(f), jnp.asarray(c), jnp.asarray(v),
                                         False))(variables)
    with torch.no_grad():
        plan = port.eval().plan(t(c), t(v))
        got = port(t(f), plan)
    assert (plan.levels[0].num_cols > 96).all()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), rtol=0,
                               atol=1e-4)
    assert tuple(got.grid) == tuple(want.grid) == tuple(port.out_grid)
    assert np.abs(np.asarray(want.features)).max() > 0.1


def test_backbone_train_step_matches_jax():
    f, c, v = scene(0)
    jmod, variables, port = backbone_pair(2 * V)

    def j_loss(params):
        out, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), True,
                              mutable=["batch_stats"])
        return (jsb.height_compression(out) ** 2).sum(), (out, upd)

    (_, (j_out, j_upd)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    port.train()
    got = port(t(f), port.plan(t(c), t(v)))
    (sb.height_compression(got) ** 2).sum().backward()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(j_out.valid))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(j_out.coords))
    np.testing.assert_allclose(got.features.detach().numpy(), np.asarray(j_out.features),
                               rtol=0, atol=1e-4)
    stats = params_from_jax({"batch_stats": jax.device_get(j_upd["batch_stats"])}, None)
    own = port.state_dict()
    assert len(stats) == 2 * 12
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    want = params_from_jax({"params": jax.device_get(j_grads)}, None)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(want) and len(grads) == 12 + 2 * 12
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)


def test_column_form_equals_the_gather_form(monkeypatch):
    """At caps that do not bind, the two forms of one set of weights give the
    same output set slot for slot, features, BN statistics and gradients;
    the column form launches no gather-GEMM. BN biases +3 (no ReLU input
    within rounding of its kink under the two summation orders)."""
    f, c, v = scene(1)
    torch.manual_seed(0)
    gather = sb.VoxelBackBone8x(GRID, 2 * V, CIN, channels=CHANS, out_channels=OUT_CH)
    column = cs.ColumnVoxelBackBone8x(GRID, 2 * V, CIN, channels=CHANS, out_channels=OUT_CH)
    with torch.no_grad():
        for name, p in gather.named_parameters():
            if name.endswith("bias"):
                p += 3.0
    column.load_state_dict(gather.state_dict())
    calls = []
    kernel = gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm",
                        lambda *a: calls.append(1) or kernel(*a))
    r = torch.from_numpy(np.random.RandomState(8).normal(
        0, 1, (B, 2, 2, column.out_grid.nz * OUT_CH)).astype(np.float32))
    outs = []
    for bb in (gather, column):
        bb.train()
        out = bb(t(f), bb.plan(t(c), t(v), None, transpose=True))
        (sb.height_compression(out) * r).sum().backward()
        outs.append(out)
        if bb is gather:
            n_gather, calls[:] = len(calls), []
    assert n_gather == 23 and not calls
    (go, co) = outs
    np.testing.assert_array_equal(co.valid.numpy(), go.valid.numpy())
    np.testing.assert_array_equal(co.coords.numpy(), go.coords.numpy())
    assert tuple(co.grid) == tuple(go.grid)
    np.testing.assert_allclose(co.features.detach().numpy(), go.features.detach().numpy(),
                               rtol=0, atol=1e-4)
    # the valid slots first, then in ascending column-major order
    key = column_major_index(co.grid, co.coords, co.valid)[co.valid]
    n = co.valid.sum(1)
    assert all(co.valid[b, :n[b]].all() for b in range(B))
    assert (key.view(-1).diff() != 0).all()
    gs, cs_ = gather.state_dict(), column.state_dict()
    for k in gs:
        np.testing.assert_allclose(cs_[k].numpy(), gs[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    gp = dict(gather.named_parameters())
    for k, p in column.named_parameters():
        w = gp[k].grad.numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-3), err_msg=k)


def test_second_column_request_matches_jax():
    """SECONDNet with FORMULATION column at tests/test_pointpillar.py's grid
    (64 x 64 x 16, the column caps 16,000 / 8,000 / ... do not bind): one
    request through the port's eval step against JAX's predict."""
    jcfg = second_model_cfg()
    jcfg["BACKBONE_3D"]["FORMULATION"] = "column"
    g = second_grid()
    jmodel = j_build_network(jcfg, CLASSES, g)
    batch = make_batch(np.random.RandomState(4), b=2, n=512)
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, batch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=1, gains={"dense_head/conv_box/kernel": 0.1})
    want = jax.device_get(jax.jit(lambda vs, b: jmodel.apply(
        vs, b, method=lambda m, b: m.predict(b)))(variables, batch))
    model = build_network(CfgDict(jcfg), CLASSES, VoxelGrid.create(g.point_cloud_range,
                                                                   g.voxel_size), device="cpu")
    assert type(model.backbone_3d) is cs.ColumnVoxelBackBone8x
    params_from_jax(variables, model)
    got = make_eval_step(model, device="cpu")(PointBatch.from_numpy(*batch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 8
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)


def site_cfg(site, tmp_path):
    """The config of each JAX call site of select_backbone8x, with a
    VoxelBackBone8x trunk (BevFusion's named one: JAX builds
    select_backbone8x whatever BACKBONE_3D names, the port the named trunk)."""
    if site == "centerpoint":
        return synthetic_cfg(tmp_path, None)
    if site == "voxelnext_compact":
        return zoo.option_cfg("voxelnext_compact")
    cfg = cfg_from_yaml_file(zoo.CFGS / {"second": "kitti_models/second.yaml",
                                         "mppnet": "waymo_models/mppnet_4frames.yaml",
                                         "bevfusion": "nuscenes_models/bevfusion.yaml"}[site],
                             CfgDict())
    if site == "bevfusion":
        cfg.MODEL.BACKBONE_3D = CfgDict({"NAME": "VoxelBackBone8x"})
    return cfg


@pytest.mark.parametrize("site", ["centerpoint", "second", "mppnet", "bevfusion",
                                  "voxelnext_compact"])
def test_formulation_routing_matches_jax(site, tmp_path, monkeypatch):
    monkeypatch.delenv("DFU3D_SPARSE_FORMULATION", raising=False)
    monkeypatch.chdir(zoo.CFGS.parent)   # the shipped files name their bases from tools/
    cfg = site_cfg(site, tmp_path)
    grid = model_grid(cfg)
    cap = int(_voxel_processor(cfg).MAX_NUMBER_OF_VOXELS["test"])
    for form in (None, "gather", "column", "other"):
        cfg.MODEL.BACKBONE_3D.FORMULATION = form
        jbuild = lambda: setup_tree(j_build_network(  # noqa: E731
            JCfgDict(cfg.MODEL), cfg.CLASS_NAMES,
            JVoxelGrid.create(grid.point_cloud_range, grid.voxel_size),
            max_voxels=cap).bind({}))
        pbuild = lambda: build_model(cfg, "test", "cpu")  # noqa: E731
        if form == "other":
            with pytest.raises(ValueError, match="FORMULATION"):
                jbuild()
            with pytest.raises(ValueError, match="FORMULATION"):
                pbuild()
            continue
        want = jbuild()["backbone_3d"]
        assert want == ("ColumnVoxelBackBone8x" if form == "column" else "VoxelBackBone8x")
        assert type(pbuild().backbone_3d).__name__ == want, (site, form)
