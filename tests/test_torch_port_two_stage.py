"""Port parity: the two-stage voxel detectors' modules and serving
(SECONDNetIoU, VoxelRCNN, PVRCNN) against the JAX package, on the CPU, fp32
on both sides, from the same numpy inputs and weights (flax layout, carried
across by `params_from_jax`), at tests/test_pointpillar.py's and
tests/test_pvrcnn*.py's test-scale configs:

* SparseEncoder: every stage's coordinate set and mask exactly equal, the
  features within 1e-4; `voxel_centers_of` exactly equal; one backward (BN
  biases +3 on both sides, as in the VoxelBackBone8x test) with every
  gradient within 1e-4 of its largest entry, B2 called 9 times forward and
  8 times for dX (conv_in's input needs no gradient);
* `dense_grid_points` in the reference order (x slowest, z fastest),
  `global_grid_points` within 1e-6;
* NeighborVoxelSA and SAFromSource: the ball query's `idx` and `has`
  exactly equal (empty balls and invalid queries included), the outputs
  within 1e-5 in eval and in train mode, the train-mode gradients within
  1e-4 of their largest entry;
* `bev_roi_align` within 1e-5, RoIs over the map's edge included (those
  taps read 0);
* the FC stacks' dropout placement (`make_fc_stack`: after block 0;
  `shared_fc_stack`: between blocks), JAX's bernoulli masks handed over:
  outputs within 1e-5.

tests/test_torch_port_two_stage_serve.py holds each detector's `predict`,
_ckpt.py its checkpoint mapping and the shipped configs, _train.py and
_cli.py the train steps. The configs and `pair` here serve all of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic

from dfu3d_tpu.core import pointnet2 as jP
from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import pvrcnn as jpv
from dfu3d_tpu.models import roi_head as jroi
from dfu3d_tpu.models import second_iou as jsiou
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel, sparse_ops
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import pvrcnn as ppv
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.models import second_iou as psiou
from dfu3d_tpu_torch.models import sparse_backbone as sb
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import CLASS_NAMES, make_batch
from test_pointpillar import second_grid, second_model_cfg
from test_pvrcnn import pv_cfg, pv_grid
from test_pvrcnn_pp import _pool_layer
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_sparse import PCR, VS, ground_points

GRID = sparse_ops.SparseGrid(128, 128, 40)
MAX_VOXELS = 4096
VOXEL_CAP = 1200
CHANS, OUT_CH = (4, 8, 8, 16, 16), 8
BN_SHIFT = 3.0
TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """TEST_THREADS intra-op threads for each module that imports this
    fixture: with several test workers on the machine, each process's
    default thread pool makes the many small ops of these test-scale models
    tens of times slower (a loop of FPS steps, the keep-scans)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def second_iou_cfg():
    """tests/test_pointpillar.py's SECONDNetIoU config: SECONDHead at test
    scale (SHARED_FC 32, 32; IOU_FC 16; a 7 x 7 lattice at stride 8)."""
    cfg = second_model_cfg()
    cfg["NAME"] = "SECONDNetIoU"
    cfg["ROI_HEAD"] = {
        "NAME": "SECONDHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": [32, 32], "IOU_FC": [16], "DP_RATIO": 0.3,
        "NMS_CONFIG": pv_cfg()["ROI_HEAD"]["NMS_CONFIG"],
        "ROI_GRID_POOL": {"GRID_SIZE": 7, "DOWNSAMPLE_RATIO": 8},
        "TARGET_CONFIG": pv_cfg()["ROI_HEAD"]["TARGET_CONFIG"],
        "LOSS_CONFIG": {"IOU_LOSS": "BinaryCrossEntropy",
                        "LOSS_WEIGHTS": {"rcnn_iou_weight": 1.0}},
    }
    return cfg


def voxel_rcnn_cfg():
    """tests/test_pvrcnn_pp.py's VoxelRCNN config: the reference
    ROI_GRID_POOL schema over x_conv2..4 at test scale."""
    cfg = pv_cfg()
    cfg["NAME"] = "VoxelRCNN"
    rh = dict(cfg["ROI_HEAD"])
    rh["NAME"] = "VoxelRCNNHead"
    rh["ROI_GRID_POOL"] = {
        "GRID_SIZE": 4, "FEATURES_SOURCE": ["x_conv2", "x_conv3", "x_conv4"],
        "POOL_LAYERS": {"x_conv2": _pool_layer(0.4), "x_conv3": _pool_layer(0.8),
                        "x_conv4": _pool_layer(1.6)}}
    cfg["ROI_HEAD"] = rh
    return cfg


MODELS = {"second_iou": (second_iou_cfg, second_grid),
          "voxel_rcnn": (voxel_rcnn_cfg, pv_grid),
          "pv_rcnn": (pv_cfg, pv_grid)}


def pair(name, seed=1, bn_shift=0.0, train=False):
    """(JAX model, flax variables, port model, JAX cfg) of MODELS[name]
    (`build_pair`)."""
    cfg_fn, grid_fn = MODELS[name]
    return build_pair(cfg_fn(), grid_fn(), seed, bn_shift, train)


def build_pair(jcfg, jgrid, seed=1, bn_shift=0.0, train=False):
    """(JAX model, flax variables, port model, JAX cfg): numpy weights with
    the RPN's box conv at a tenth of its He scale, drawn in the flax tree
    of the port model's state_dict (the tree the JAX model's init makes)."""
    from test_torch_port_train_slice import _shift_bn_biases

    jmodel = j_build_network(jcfg, CLASS_NAMES, jgrid)
    grid = voxel.VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size)
    model = build_network(CfgDict(jcfg), CLASS_NAMES, grid, device="cpu", train=train)
    variables = numpy_variables(lambda: flax_variables_like(model), seed=seed,
                                gains={"dense_head/conv_box/kernel": 0.1})
    if bn_shift:
        variables = _shift_bn_biases(variables, bn_shift)
    params_from_jax(variables, model)
    return jmodel, variables, model, jcfg


def port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


# --------------------------------------------------------------------------
# SparseEncoder
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoder_setup():
    pts, valid = ground_points(np.random.RandomState(40), 2)
    vox = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), MAX_VOXELS)
    feats = np.random.RandomState(41).normal(0, 1, (2, MAX_VOXELS, 4)).astype(np.float32)
    feats *= vox.voxel_valid.numpy()[..., None]
    jc, jv = jnp.asarray(vox.voxel_coords.numpy()), jnp.asarray(vox.voxel_valid.numpy())
    jmod = jsb.SparseEncoder(grid=jsp.SparseGrid(*GRID), voxel_cap=VOXEL_CAP, channels=CHANS,
                             out_channels=OUT_CH, dtype=jnp.float32)
    variables = numpy_variables(lambda: flax_variables_like(
        sb.SparseEncoder(GRID, VOXEL_CAP, in_channels=4, channels=CHANS, out_channels=OUT_CH)),
        seed=5)
    return vox, feats, jc, jv, jmod, variables


def port_encoder(variables, train=False):
    enc = sb.SparseEncoder(GRID, VOXEL_CAP, in_channels=4, channels=CHANS, out_channels=OUT_CH)
    return params_from_jax(variables, enc.train(train))


def test_sparse_encoder_matches_jax(encoder_setup):
    """Eval: the four stages and the conv_out tensor (coordinates and masks
    exact, features within 1e-4, the stride-2 cap binding) and each stage's
    voxel centres."""
    vox, feats, jc, jv, jmod, variables = encoder_setup
    wbev, wstages = jax.jit(lambda f: jmod.apply(variables, f, jc, jv, train=False))(
        jnp.asarray(feats))
    enc = port_encoder(variables)
    with torch.no_grad():
        levels = enc.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
        bev, stages = enc(torch.from_numpy(feats), levels)
    assert (levels[1].num_unique > levels[1].coords.shape[1]).all()
    assert len(stages) == len(wstages) == 4
    for i, (got, want) in enumerate(zip(stages + [bev], list(wstages) + [wbev])):
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords), err_msg=i)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg=i)
        np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=1e-4,
                                   err_msg=i)
        assert np.abs(np.asarray(want.features)).max() > 0.1
    for i, stride in enumerate((1, 2, 4, 8)):
        want = jsb.voxel_centers_of(wstages[i], GRID, PCR, VS, stride)
        got = sb.voxel_centers_of(stages[i], PCR, VS, stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [lv.grid.nz for lv in levels] == [40, 20, 10, 5, 3]
    assert bev.features.shape[-1] * enc.out_grid.nz == OUT_CH * 3


def test_sparse_encoder_backward_matches_jax(encoder_setup, monkeypatch):
    """loss = Σ over the stages and conv_out of features · R: the value
    within 1e-5 relative, every gradient within 1e-4 of its largest entry,
    the BN running statistics within 1e-5; B2 runs 9 times forward and 8
    times for dX, in reverse order."""
    vox, feats, jc, jv, jmod, variables = encoder_setup
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda path, x: x + BN_SHIFT if path[-1].key == "bias" else x, variables["params"]),
        "batch_stats": variables["batch_stats"]}
    rng = np.random.RandomState(42)
    # R has each stage's shape, which the eval test holds equal to JAX's
    with torch.no_grad():
        enc = port_encoder(variables)
        _, stages = enc(torch.from_numpy(feats),
                        enc.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique))
    rs = [rng.normal(0, 1, tuple(s.features.shape)).astype(np.float32) for s in stages]

    def j_loss(params):
        (bev, stages), upd = jmod.apply({"params": params,
                                         "batch_stats": variables["batch_stats"]},
                                        jnp.asarray(feats), jc, jv, train=True,
                                        mutable=["batch_stats"])
        total = jnp.sum(bev.features)
        for s, r in zip(stages, rs):
            total = total + jnp.sum(s.features * r)
        return total, upd

    (j_val, j_upd), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(tuple(args[3].shape))
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    enc = port_encoder(variables, train=True)
    levels = enc.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique, transpose=True)
    bev, stages = enc(torch.from_numpy(feats), levels)
    assert len(calls) == 9
    loss = bev.features.sum() + sum((s.features * t(r)).sum() for s, r in zip(stages, rs))
    loss.backward()
    assert len(calls) == 17
    assert calls[9:] == [(k, co, ci) for k, ci, co in reversed(calls[1:9])]
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    want = params_from_jax({"params": jax.device_get(j_grads)})
    got = {k: p.grad for k, p in enc.named_parameters()}
    assert set(got) == set(want) and len(got) == 9 + 2 * 5
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(w).max() > 1e-3, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    stats = params_from_jax({"batch_stats": jax.device_get(j_upd["batch_stats"])})
    own = enc.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# RoI grid points, NeighborVoxelSA, SAFromSource, bev_roi_align, FC stacks
# --------------------------------------------------------------------------

def random_rois(rng, b, r, extent=6.0):
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-extent, extent, (b, r, 2))
    rois[..., 2] = rng.uniform(-1, 1, (b, r))
    rois[..., 3:6] = rng.uniform(0.5, 4.0, (b, r, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    return rois


def test_grid_points_match_jax():
    rng = np.random.RandomState(0)
    rois = random_rois(rng, 2, 5)
    unit = np.zeros((1, 7), np.float32)
    unit[0, 3:6] = 3.0
    local = proi.dense_grid_points(t(unit), 3)[0].numpy()
    # (idx + 0.5) / 3 · 3 - 1.5 = idx - 1: x slowest, z fastest
    want = np.array([[x, y, z] for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)],
                    np.float32)
    np.testing.assert_array_equal(local, want)
    for g in (3, 4, 6):
        np.testing.assert_array_equal(proi.dense_grid_points(t(rois), g).numpy(),
                                      np.asarray(jroi.dense_grid_points(jnp.asarray(rois), g)))
        np.testing.assert_allclose(proi.global_grid_points(t(rois), g).numpy(),
                                   np.asarray(jroi.global_grid_points(jnp.asarray(rois), g)),
                                   rtol=0, atol=1e-6)


def sa_scene(rng, b=2, n=300, m=60, c=8):
    """Sources in a 4 m cube (the last 20 invalid), features N(0, 1); queries
    among them, a tenth far outside (empty balls), the last 5 invalid."""
    src = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    src_valid = np.ones((b, n), bool)
    src_valid[:, -20:] = False
    feats = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    q = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    q[:, :m // 10] += 20.0
    q_valid = np.ones((b, m), bool)
    q_valid[:, -5:] = False
    return q, q_valid, src, feats, src_valid


def _grads(fn, params, *args):
    return jax.device_get(jax.grad(lambda p: fn(p, *args))(params))


@pytest.mark.parametrize("train", [False, True])
def test_neighbor_voxel_sa_matches_jax(train):
    rng = np.random.RandomState(1)
    q, qv, src, feats, sv = sa_scene(rng)
    jmod = jroi.NeighborVoxelSA(mlp_spec=(16, 8), radius=0.6, nsample=8)
    args = tuple(map(jnp.asarray, (q, qv, src, feats, sv)))
    variables = numpy_variables(lambda: jmod.init(jax.random.PRNGKey(0), *args, train=False),
                                seed=2)
    widx, whas = jax.vmap(lambda x, v, nx, nv: jP.ball_query(0.6, 8, x, v, nx, nv))(
        args[2], args[4], args[0], args[1])
    port = params_from_jax(variables, proi.NeighborVoxelSA(8, (16, 8), 0.6, 8)).train(train)
    idx, has = port.query(t(q), t(qv), t(src), t(sv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(has.numpy(), np.asarray(whas))
    assert (~has.numpy() & qv).sum() >= 10 and has.numpy().sum() > 50
    r = rng.normal(0, 1, (2, 60, 8)).astype(np.float32)

    def jfn(params, f):
        out, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            args[0], args[1], args[2], f, args[4], train=train,
                            mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, want), (wg, wf) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        variables["params"], args[3])
    f = t(feats).requires_grad_(True)
    out = port(t(q), t(qv), t(src), f, t(sv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.1
    if train:
        (out * t(r)).sum().backward()
        wg = params_from_jax({"params": jax.device_get(wg)})
        for k, p in port.named_parameters():
            w = wg[k].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
        wf = np.asarray(wf)
        np.testing.assert_allclose(f.grad.numpy(), wf, rtol=0, atol=1e-4 * np.abs(wf).max())


@pytest.mark.parametrize("with_feats", [False, True])
def test_sa_from_source_matches_jax(with_feats):
    """Empty balls (queries far away) and invalid queries give 0; in train
    mode the gradients (tied maxima from repeated slots shared) match."""
    rng = np.random.RandomState(3)
    q, qv, src, feats, sv = sa_scene(rng, c=5)
    jmod = jpv.SAFromSource(radius=0.7, nsample=8, mlp=(16, 12))
    jf = jnp.asarray(feats) if with_feats else None
    args = tuple(map(jnp.asarray, (q, qv, src)))
    variables = numpy_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), *args, jf, jnp.asarray(sv), train=False), seed=4)
    port = params_from_jax(variables, ppv.SAFromSource(5 if with_feats else 0, 0.7, 8, (16, 12)))
    port.train()
    idx, has = port.query(t(q), t(qv), t(src), t(sv))
    widx, whas = jax.vmap(lambda x, v, nx, nv: jP.ball_query(0.7, 8, x, v, nx, nv))(
        args[2], jnp.asarray(sv), args[0], args[1])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(has.numpy(), np.asarray(whas))
    r = rng.normal(0, 1, (2, 60, 12)).astype(np.float32)

    def jfn(params):
        out, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            *args, jf, jnp.asarray(sv), train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, want), wg = jax.value_and_grad(jfn, has_aux=True)(variables["params"])
    out = port(t(q), t(qv), t(src), t(feats) if with_feats else None, t(sv))
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    empty = ~(has.numpy() & qv)
    assert empty.sum() >= 10 and (want[empty] == 0).all()
    assert (out.detach().numpy()[empty] == 0).all()
    (out * t(r)).sum().backward()
    wg = params_from_jax({"params": jax.device_get(wg)})
    for k, p in port.named_parameters():
        w = wg[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_bev_roi_align_matches_jax():
    """Random rotated RoIs on a 20 x 16 map, some straddling its edges or
    wholly outside: within 1e-5 of JAX's (the lattice's linspace differs
    from jnp.linspace by an ulp at most), outside taps 0."""
    rng = np.random.RandomState(5)
    feats = rng.normal(0, 1, (2, 16, 20, 5)).astype(np.float32)
    pcr, vs, stride = [0.0, -6.4, -3.0, 8.0, 6.4, 1.0], [0.1, 0.2, 0.25], 4.0
    rois = np.zeros((2, 12, 7), np.float32)
    rois[..., 0] = rng.uniform(-1.0, 9.0, (2, 12))
    rois[..., 1] = rng.uniform(-8.0, 8.0, (2, 12))
    rois[..., 3:6] = rng.uniform(0.5, 4.0, (2, 12, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (2, 12))
    rois[0, 0, :2] = [0.0, -6.4]         # centred on the map's corner
    rois[1, 0, :2] = [20.0, 20.0]        # wholly outside
    for g in (4, 7):
        want = jax.vmap(lambda f, r: jsiou.bev_roi_align(
            f, r, g, jnp.asarray(pcr, jnp.float32), jnp.asarray(vs, jnp.float32), stride))(
            jnp.asarray(feats), jnp.asarray(rois))
        got = psiou.bev_roi_align(t(feats), t(rois), g, pcr, vs, stride)
        assert got.shape == (2, 12, g, g, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        assert (got[1, 0] == 0).all() and (got[0, 0] != 0).any()


class DropoutMasks:
    """Replaces flax's jax.random for Dropout: each bernoulli mask is kept,
    by its call's index at trace time, through a debug callback."""

    def __init__(self, monkeypatch):
        self.masks = {}
        masks = self.masks

        class Shim:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            @staticmethod
            def bernoulli(key, p, shape):
                out = jax.random.bernoulli(key, p, shape)
                i = len(masks)
                masks[i] = None
                jax.debug.callback(lambda m, i=i: masks.__setitem__(i, np.asarray(m)), out)
                return out

        monkeypatch.setattr(stochastic, "random", Shim())

    def hand_over(self, monkeypatch):
        """The port's `dropout_keep` returns the kept masks in call order."""
        order = [self.masks[i] for i in sorted(self.masks)]

        def keep(generator, shape, keep_prob, device):
            m = order.pop(0)
            assert tuple(m.shape) == tuple(shape)
            return torch.from_numpy(m.copy()).to(device)

        monkeypatch.setattr(proi, "dropout_keep", keep)
        return order


@pytest.mark.parametrize("layout", ["make", "shared"])
def test_fc_stack_dropout_matches_jax(layout, monkeypatch):
    """Three blocks: make_fc_stack drops after block 0 only and ends in a
    biased out layer, shared_fc_stack drops after blocks 0 and 1 and has no
    out layer; with JAX's masks handed over the outputs agree."""
    x = np.random.RandomState(6).normal(0, 1, (64, 24)).astype(np.float32)
    widths = (32, 16, 16)
    if layout == "make":
        jmod = jroi.make_fc_stack(widths, 3, 0.3)
        port = proi.make_fc_stack(24, widths, 3, 0.3)
    else:
        jmod = jroi.shared_fc_stack(widths, 0.3)
        port = proi.shared_fc_stack(24, widths, 0.3)
    variables = numpy_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  train=False), seed=7)
    capture = DropoutMasks(monkeypatch)
    want, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(3)})
    want = np.asarray(want)
    assert len(capture.masks) == (1 if layout == "make" else 2)
    left = capture.hand_over(monkeypatch)
    params_from_jax(variables, port).eval()
    np.testing.assert_allclose(port(t(x), torch.Generator()).detach().numpy(),
                               np.asarray(jmod.apply(variables, jnp.asarray(x), train=False)),
                               rtol=0, atol=1e-5)
    got = port.train()(t(x), torch.Generator().manual_seed(0)).detach().numpy()
    assert not left
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert port.dropout_after == ((0,) if layout == "make" else (0, 1))
