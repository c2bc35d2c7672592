"""Port parity: the DSVT trunk (DynVoxelVFE, ingroup_inds, the pillar and
voxel set partitions, the set attention, the attention pooling, both
backbones) and the two DSVT CenterPoints against the JAX package, on the
CPU, fp32 on both sides, from the same numpy inputs and weights (flax
layout, carried across by `params_from_jax`), at narrow widths: d_model 32,
8 heads (the reduction's fixed count), FFN 64, a 24 x 24 (x 8) grid,
windows of 6 x 6 (x 8 / 2 / 1), 400 points of 5 channels per frame, B=2.

* `ingroup_inds`, the set ids and slots of both partitions (both majors,
  both geometries, with the pooled B · MAX_SETS cap binding and not) and
  the pools' coords, batch ids and valid: exactly equal;
* features within 1e-5 of the larger of 1 and the reference's largest
  |entry| (TOL), gradients of the set attention within 1e-4 of their
  largest entry, finite with an empty set in the batch;
* both backbones in train mode (their BN statistics too) and the BEV map;
* each config's `predict`: keep masks and labels equal, boxes and scores
  within 1e-4;
* the flax tree of JAX's init equals the port's state_dict leaf for leaf
  (so `params_from_jax` loads it strictly), and a reference-keyed state
  through the JAX package's `dsvt_mapping` / `dsvt_voxel_mapping` equals
  the same state through the port's mapping.

The train steps are in tests/test_torch_port_dsvt_train.py.
"""
import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.core.voxel import sparse_ops as jsops
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import dsvt as jdsvt
from dfu3d_tpu.models import vfe as jvfe
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.core.voxel.sparse_ops import ingroup_inds
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import dsvt
from dfu3d_tpu_torch.models.vfe import DynVoxelVFE
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import CLASS_NAMES, tiny_model_cfg
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR = [0, -4.8, -3, 9.6, 4.8, 1]
PILLAR_VS, VOXEL_VS = [0.4, 0.4, 4.0], [0.4, 0.4, 0.5]   # 24 x 24 x 1, 24 x 24 x 8
MAX_VOXELS = 256
DIM, HEADS, FFN = 32, 8, 64
PILLAR_WINDOW, PILLAR_SET = (6, 6), 9
VOXEL_WINDOWS = ((6, 6, 8), (6, 6, 2), (6, 6, 1))
VOXEL_STRIDES = ((1, 1, 4), (1, 1, 2))
VOXEL_SET = 16
# per frame: the pooled cap B · MAX_SETS binds at 8 (the first frame takes
# every set) and not at 128
MAX_SETS = {"binding": 8, "free": 128}
# the whole models: the second frame gets part of its sets (0.4-0.9 of its
# voxels reach one, by layer)
WHOLE_MAX_SETS = {False: 24, True: 16}
TOL = 1e-5
# the heads' out conv at 0.1 of He-normal: logits O(1), where at full scale
# the heat-map loss of a seeded model is 1e2 and its gradient norm 5e3
GAINS = {"dense_head/fused_heads/out/kernel": 0.1}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def points(seed, b=2, n=400, m=8):
    """Points of 5 channels (x, y, z, intensity, elongation): half in 12
    clusters (many share a voxel), half uniform, some outside the range,
    the last 20 of each frame invalid; m gt boxes of the three classes, the
    last 2 invalid."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(PCR[:3]) - 0.3, np.array(PCR[3:]) + 0.3
    pts = np.zeros((b, n, 5), np.float32)
    for i in range(b):
        ctr = rng.uniform(PCR[:3], PCR[3:], (12, 3))
        half = n // 2
        pts[i, :half, :3] = ctr[rng.randint(0, 12, half)] + rng.normal(0, 0.4, (half, 3))
        pts[i, half:, :3] = rng.uniform(lo, hi, (n - half, 3))
    pts[..., 3:] = rng.uniform(0, 1, (b, n, 2))
    valid = np.ones((b, n), bool)
    valid[:, -20:] = False
    gt = np.zeros((b, m, 8), np.float32)
    gt[..., 0] = rng.uniform(1, 8.6, (b, m))
    gt[..., 1] = rng.uniform(-3.8, 3.8, (b, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (b, m))
    gt[..., 3:6] = rng.uniform(0.5, 3, (b, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    gt[..., 7] = rng.randint(1, 4, (b, m))
    gt_valid = np.ones((b, m), bool)
    gt_valid[:, -2:] = False
    return pts, valid, gt, gt_valid


def dsvt_cfg(voxel: bool, max_sets=None):
    """tiny_model_cfg with DynamicVoxelVFE and DSVT in the reference's
    set_info schema, a stride-1 2D backbone and the head at stride 1, as
    the shipped Waymo configs have them."""
    cfg = tiny_model_cfg()
    cfg["VFE"] = {"NAME": "DynamicVoxelVFE", "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
                  "USE_NORM": True, "NUM_FILTERS": [DIM, DIM]}
    if voxel:
        stages = len(VOXEL_WINDOWS)
        il = {"sparse_shape": [24, 24, 8], "downsample_stride": [list(s) for s in VOXEL_STRIDES],
              "window_shape": [list(w) for w in VOXEL_WINDOWS]}
        set_info = [[VOXEL_SET, 1]] * stages
    else:
        stages = 1
        il = {"sparse_shape": [24, 24, 1], "downsample_stride": [],
              "window_shape": [[*PILLAR_WINDOW, 1]]}
        set_info = [[PILLAR_SET, 2]]
    il.update({"d_model": [DIM] * stages, "set_info": set_info, "hybrid_factor": [2, 2, 1],
               "shifts_list": [[[0, 0, 0], [3, 3, 0]]] * stages, "normalize_pos": False})
    cfg["BACKBONE_3D"] = {"NAME": "DSVT", "INPUT_LAYER": il, "set_info": set_info,
                          "d_model": [DIM] * stages, "nhead": [HEADS] * stages,
                          "dim_feedforward": [FFN] * stages,
                          "MAX_SETS": max_sets or WHOLE_MAX_SETS[voxel]}
    cfg["MAP_TO_BEV"] = {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": DIM}
    cfg["BACKBONE_2D"] = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1],
                          "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [16, 16],
                          "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [16, 16]}
    cfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["FEATURE_MAP_STRIDE"] = 1
    return cfg


def voxel_size(voxel: bool):
    return VOXEL_VS if voxel else PILLAR_VS


def variables_like(model):
    """`flax_variables_like` with DenseGeneral q / k / v kernels (C, H, D)
    and biases (H, D)."""
    v = flax_variables_like(model)
    for path, mod in model.named_modules():
        if not isinstance(mod, (dsvt.SetAttention, dsvt.StageReductionAtt)):
            continue
        node = v["params"]
        for key in path.split(".") if path else ():
            node = node[key]
        h = mod.num_heads
        for name in ("q", "k", "v"):
            c = node[name]["kernel"].shape[0]
            node[name]["kernel"] = jnp.zeros((c, h, c // h))
            node[name]["bias"] = jnp.zeros((h, c // h))
    return v


def pair(voxel: bool, seed=1, train=False, max_sets=None):
    """(JAX CenterPoint, flax variables, port CenterPoint with those weights)."""
    jcfg = dsvt_cfg(voxel, max_sets)
    jmodel = j_build_network(JCfgDict(jcfg), CLASS_NAMES,
                             JVoxelGrid.create(PCR, voxel_size(voxel)), max_voxels=MAX_VOXELS)
    model = build_network(CfgDict(jcfg), CLASS_NAMES, VoxelGrid.create(PCR, voxel_size(voxel)),
                          device="cpu", train=train, max_voxels=MAX_VOXELS,
                          num_point_features=5)
    variables = numpy_variables(lambda: variables_like(model), seed=seed, gains=GAINS)
    params_from_jax(variables, model)
    return jmodel, variables, model


def jax_batch(seed, **kw):
    from dfu3d_tpu.data.dataset import PointBatch as JPointBatch

    return JPointBatch(*points(seed, **kw))


def port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


def sub(variables, *path):
    out = {}
    for col, tree in variables.items():
        node = tree
        for k in path:
            node = node.get(k, {})
        if node:
            out[col] = node
    return out


def module_of(model, name):
    return dict(model.named_modules())[name]


# --------------------------------------------------------------------------
# ingroup_inds and the partitions
# --------------------------------------------------------------------------

def test_ingroup_inds_matches_jax():
    rng = np.random.RandomState(0)
    groups = rng.randint(0, 23, 500).astype(np.int32)
    valid = rng.uniform(size=500) > 0.2
    for v in (valid, None):
        want = np.asarray(jsops.ingroup_inds(jnp.asarray(groups),
                                             None if v is None else jnp.asarray(v)))
        got = ingroup_inds(t(groups), None if v is None else t(v)).numpy()
        np.testing.assert_array_equal(got, want)
    # ties by original order: the first of a group ranks 0
    got = ingroup_inds(t(groups), t(valid)).numpy()
    for g in (0, 7):
        idx = np.flatnonzero((groups == g) & valid)
        np.testing.assert_array_equal(got[idx], np.arange(len(idx)))
    assert (got[~valid] == -1).all()


def voxel_lists(voxel: bool, seed=3):
    """The VFE's (B·V, 3) coords, batch ids and valid of a `points` batch."""
    from dfu3d_tpu_torch.core.voxel import dynamic_voxelize

    pts, valid, *_ = points(seed)
    vox = dynamic_voxelize(VoxelGrid.create(PCR, voxel_size(voxel)), t(pts), t(valid),
                           MAX_VOXELS)
    b, p = vox.voxel_valid.shape
    return (vox.voxel_coords.reshape(b * p, 3).numpy(), np.repeat(np.arange(b), p),
            vox.voxel_valid.reshape(b * p).numpy())


GEOMS_2D = ((PILLAR_WINDOW, (0, 0)), ((12, 12), (3, 3)))


@pytest.mark.parametrize("cap", sorted(MAX_SETS))
def test_partition_2d_matches_jax(cap):
    coords, batch_idx, valid = voxel_lists(False)
    jmod = jdsvt.DSVTBackbone(dim=DIM, window_shape=PILLAR_WINDOW, set_size=PILLAR_SET,
                              max_sets=MAX_SETS[cap], grid_size=(24, 24))
    shares = []
    for wshape, shift in GEOMS_2D:
        for x_major in (False, True):
            want_ids, want_slot, _ = jmod._partition(
                jnp.asarray(coords[:, :2]), jnp.asarray(batch_idx, jnp.int32), jnp.asarray(valid),
                x_major, wshape, shift, 2)
            ids, slot = dsvt.partition_2d(t(coords[:, :2]), t(batch_idx), t(valid), x_major,
                                          wshape, shift, (24, 24), PILLAR_SET, 2 * MAX_SETS[cap])
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            in_set = ids.numpy() < 2 * MAX_SETS[cap]
            np.testing.assert_array_equal(slot.numpy()[in_set], np.asarray(want_slot)[in_set])
            shares.append([in_set[valid & (batch_idx == i)].mean() for i in range(2)])
    shares = np.array(shares)
    if cap == "binding":   # the first frame takes every set: the second reaches none
        assert (shares[:, 1] == 0).all() and (shares[:, 0] > 0.5).all()
    else:
        assert (shares == 1).all()


@pytest.mark.parametrize("cap", sorted(MAX_SETS))
def test_partition_3d_matches_jax(cap):
    coords, batch_idx, valid = voxel_lists(True)
    geoms = [((6, 6, 8), (0, 0, 0)), ((12, 12, 8), (3, 3, 0)), ((6, 6, 2), (0, 0, 0))]
    shares = []
    for wshape, shift in geoms:
        for x_major in (False, True):
            args = (x_major, wshape, shift, (24, 24, 8), VOXEL_SET, 2 * MAX_SETS[cap])
            want_ids, want_slot = jdsvt.set_partition3d(
                jnp.asarray(coords), jnp.asarray(batch_idx, jnp.int32), jnp.asarray(valid),
                *args)
            ids, slot = dsvt.partition_3d(t(coords), t(batch_idx), t(valid), *args)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            in_set = ids.numpy() < 2 * MAX_SETS[cap]
            np.testing.assert_array_equal(slot.numpy()[in_set], np.asarray(want_slot)[in_set])
            shares.append([in_set[valid & (batch_idx == i)].mean() for i in range(2)])
    shares = np.array(shares)
    if cap == "binding":
        assert (shares[:, 1] == 0).all() and (shares[:, 0] > 0).all()
    else:
        assert (shares == 1).all()


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------

def test_dyn_voxel_vfe_matches_jax():
    """Train mode (BN over every point of the batch): features within TOL,
    coords and valid equal, the BN statistics within 1e-6."""
    jgrid = JVoxelGrid.create(PCR, VOXEL_VS)
    jmod = jvfe.DynVoxelVFE(num_filters=(DIM, DIM), grid=jgrid, max_voxels=MAX_VOXELS)
    port = DynVoxelVFE((DIM, DIM), VoxelGrid.create(PCR, VOXEL_VS), num_point_features=5,
                       max_voxels=MAX_VOXELS).train()
    variables = numpy_variables(lambda: flax_variables_like(port), seed=3)
    params_from_jax(variables, port)
    pts, valid, *_ = points(5)
    (wf, wc, wv), upd = jax.jit(lambda v, p, pv: jmod.apply(
        v, p, pv, True, mutable=["batch_stats"]))(variables, pts, valid)
    feats, coords, ok = port(t(pts), t(valid))
    assert feats.shape == (2, MAX_VOXELS, DIM) and port.pfn_0.Dense_0.in_features == 11
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(coords.numpy()[ok.numpy()], np.asarray(wc)[np.asarray(wv)])
    close(feats.detach().numpy(), wf)
    assert np.asarray(wv).sum() > 300
    stats = params_from_jax({"batch_stats": jax.device_get(upd["batch_stats"])})
    own = port.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_set_attention_matches_jax():
    """Sets with empty slots and one set with none: the outputs within TOL,
    and the gradients of sum(out · r) with respect to the weights, the sets
    and the positions within 1e-4 of their largest entry, all finite."""
    rng = np.random.RandomState(4)
    s, length = 5, 9
    sets = rng.normal(0, 1, (s, length, DIM)).astype(np.float32)
    pos = rng.normal(0, 1, (s, length, DIM)).astype(np.float32)
    mask = rng.uniform(size=(s, length)) > 0.4
    mask[2] = False
    sets[~mask] = 0.0
    r = rng.normal(0, 1, (s, length, DIM)).astype(np.float32)
    jmod = jdsvt._SetAttention(DIM, HEADS, dim_ff=FFN)
    port = dsvt.SetAttention(DIM, HEADS, FFN)
    variables = numpy_variables(lambda: variables_like(port), seed=5)
    params_from_jax(variables, port)

    def jloss(params, x, p):
        out = jmod.apply({"params": params}, x, jnp.asarray(mask), p)
        return jnp.sum(out * r), out

    (_, want), (gp, gx, gpos) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], sets, pos)
    x, p = t(sets).requires_grad_(), t(pos).requires_grad_()
    out = port(x, t(mask), p)
    (out * t(r)).sum().backward()
    close(out.detach().numpy(), want)
    assert (out.detach().numpy()[2] == 0).all()
    grads = params_from_jax({"params": jax.device_get(gp)})
    got = {k: v.grad for k, v in port.named_parameters()}
    assert set(grads) == set(got)
    for k, w in [*grads.items(), ("sets", t(gx)), ("pos", t(gpos))]:
        g = got.get(k, x.grad if k == "sets" else p.grad)
        assert torch.isfinite(g).all(), k
        close(g.numpy(), w.numpy(), 1e-4, err_msg=k)


def test_stage_reduction_and_pool_match_jax():
    """_StageReductionAtt on zero-filled pools, and the whole `_pool`
    (z-stride 4 on the 24 x 24 x 8 grid): the pooled features within TOL,
    their coords, batch ids and valid equal."""
    coords, batch_idx, valid = voxel_lists(True)
    n = coords.shape[0]
    rng = np.random.RandomState(6)
    x = np.where(valid[:, None], rng.normal(0, 1, (n, DIM)), 0).astype(np.float32)
    port = dsvt.StageReductionAtt(DIM, 4)
    variables = numpy_variables(lambda: variables_like(port), seed=7)
    params_from_jax(variables, port)
    pooled = np.where(rng.uniform(size=(64, 4, 1)) > 0.3, rng.normal(0, 1, (64, 4, DIM)), 0)
    pooled = pooled.astype(np.float32)
    want = jdsvt._StageReductionAtt(DIM, 4).apply(variables, pooled)
    close(port(t(pooled)).detach().numpy(), want)

    class Pool(jdsvt.DSVTVoxelBackbone):
        @jnn.compact
        def __call__(self, x, coords, batch_idx, valid):
            return self._pool(x, coords, batch_idx, valid, (1, 1, 4), (24, 24, 8),
                              name="stage0_reduction")

    jpool = Pool(dim=DIM)
    wred, wcoords, wbatch, wvalid = jpool.apply({"params": {"stage0_reduction": variables[
        "params"]}}, x, coords, jnp.asarray(batch_idx, jnp.int32), valid)
    plan = dsvt.pool_plan(t(coords), t(batch_idx), t(valid), (1, 1, 4), (24, 24, 8))
    red = dsvt.pool(port, t(x), plan, 4)
    np.testing.assert_array_equal(plan.valid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(plan.coords.numpy(), np.asarray(wcoords))
    np.testing.assert_array_equal(plan.batch_idx.numpy(), np.asarray(wbatch))
    close(red.detach().numpy(), wred)
    assert 0 < plan.valid.sum() < valid.sum()


def backbone_inputs(voxel: bool, seed=8):
    coords, batch_idx, valid = voxel_lists(voxel)
    rng = np.random.RandomState(seed)
    feats = np.where(valid[:, None], rng.normal(0, 1, (len(valid), DIM)), 0).astype(np.float32)
    b = 2
    return (feats.reshape(b, -1, DIM), coords.reshape(b, -1, 3), valid.reshape(b, -1))


@pytest.mark.parametrize("voxel", [False, True], ids=["pillar", "voxel"])
def test_backbone_and_bev_match_jax(voxel):
    """Each backbone in train mode, its pooled set cap binding for part of
    the second frame: the output within TOL (the voxel model's coords,
    batch ids and valid equal), the pos-embedding BN statistics within
    1e-5; then the dense BEV map of the output within TOL of a numpy
    scatter of JAX's."""
    jmodel, variables, model = pair(voxel, seed=2, train=True)
    jbb = jmodel.bind(variables).backbone_3d.clone(parent=None)
    bb_vars = sub(variables, "backbone_3d")
    feats, coords, valid = backbone_inputs(voxel)
    port = model.backbone_3d
    if voxel:
        (wx, wxy, wb, wv), upd = jbb.apply(bb_vars, feats, coords, valid, True,
                                           mutable=["batch_stats"])
        x, xy, bidx, ok = port(t(feats), t(coords), t(valid))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(xy.numpy()[ok.numpy()], np.asarray(wxy)[np.asarray(wv)])
        np.testing.assert_array_equal(bidx.numpy()[ok.numpy()], np.asarray(wb)[np.asarray(wv)])
        close(x.detach().numpy(), wx)
        want_xy, want_b, want_v, want_x = (np.asarray(a) for a in (wxy, wb, wv, wx))
    else:
        wx, upd = jbb.apply(bb_vars, feats, coords[..., :2], valid, True,
                            mutable=["batch_stats"])
        out = port(t(feats), t(coords[..., :2]), t(valid))
        close(out.detach().numpy(), wx)
        x, xy = out.reshape(-1, DIM), t(coords[..., :2].reshape(-1, 2))
        bidx, ok = t(np.repeat(np.arange(2), feats.shape[1])), t(valid.reshape(-1))
        want_xy, want_b, want_v = xy.numpy(), bidx.numpy(), ok.numpy()
        want_x = np.asarray(wx).reshape(-1, DIM)
    stats = params_from_jax({"batch_stats": jax.device_get(upd["batch_stats"])})
    own = port.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    bev = dsvt.scatter_bev(x, xy, bidx, ok, 2, 24, 24)
    want = np.zeros((2, 24, 24, DIM), np.float32)
    want[want_b[want_v], want_xy[want_v, 1], want_xy[want_v, 0]] = want_x[want_v]
    close(bev.detach().numpy(), want)
    # some voxels of the second frame reach no set in some layer
    pts, pvalid, *_ = points(3)
    plans = dsvt.dsvt_plan(model.vfe, port, t(pts), t(pvalid))
    shares = np.array(dsvt.set_shares(plans, 2))
    assert (shares[:, 0] == 1).all() and (shares[:, 1] < 1).any()


@pytest.mark.parametrize("voxel", [False, True], ids=["pillar", "voxel"])
def test_predict_matches_jax(voxel):
    """The decode end to end from points (DynVoxelVFE, the DSVT trunk, the
    BEV scatter, BaseBEVBackbone, CenterHead at stride 1, rotated NMS
    through B1's twin): keep masks and labels equal, boxes and scores
    within 1e-4."""
    jmodel, variables, model = pair(voxel, seed=4)
    jbatch = jax_batch(9)
    want = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, method=lambda m, bb: m.predict(bb)))(variables, jbatch))
    with torch.no_grad():
        got = model.eval().predict(port_batch(jbatch))
    boxes, scores, labels, keep = (x.numpy() for x in got)
    np.testing.assert_array_equal(keep, np.asarray(want[3]))
    np.testing.assert_array_equal(labels, np.asarray(want[2]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-4)
    assert keep.sum() > 2 and np.isfinite(boxes).all()


@pytest.mark.parametrize("voxel", [False, True], ids=["pillar", "voxel"])
def test_flax_tree_matches_state_dict(voxel):
    """The flax tree of JAX's init has exactly the port state_dict's leaves in
    flax shapes: `params_from_jax` loads the JAX weights strictly (as `pair`
    does) and no port parameter is left out."""
    jmodel, _, model = pair(voxel)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jax_batch(3, n=64), train=False))

    def leaves(tree):
        return {"/".join(k.key for k in p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert leaves(shapes) == leaves(variables_like(model))


@pytest.mark.parametrize("voxel", [False, True], ids=["pillar", "voxel"])
def test_reference_mapping_matches_jax(voxel):
    """A reference-keyed DSVT state (stage_{s}.{blk}.encoder_list.{li}.
    win_attn..., input_layer.posembed_layers..., residual_norm_stage_{s},
    stage_{s}_reduction) through the JAX package's mapping into flax
    variables and `params_from_jax` equals the same state through the port's
    mapping; the model's `reference_mapping` covers every key of its VFE,
    trunk, 2D backbone and head."""
    _, variables, model = pair(voxel)
    own = model.state_dict()
    if voxel:
        set_info = ((VOXEL_SET, 1),) * 3
        jmap, mapping = jtc.dsvt_voxel_mapping(set_info), torch_convert.dsvt_voxel_mapping(set_info)
    else:
        jmap, mapping = jtc.dsvt_mapping(2), torch_convert.dsvt_mapping(2)
    rng = np.random.RandomState(8)
    ref = {}
    for ours, (ref_key, transform) in mapping.items():
        shape = tuple(own[ours].shape)
        if ref_key.endswith("in_proj_weight"):
            shape = (3 * shape[0], shape[1])
        elif ref_key.endswith("in_proj_bias"):
            shape = (3 * shape[0],)
        ref.setdefault(ref_key, rng.normal(0, 1, shape).astype(np.float32))
    new, report = jtc.apply_mapping(variables, ref, jmap)
    assert not report["missing_in_torch"]
    via_jax = params_from_jax({"params": new["params"], "batch_stats": new["batch_stats"]})
    got, preport = torch_convert.apply_mapping(own, {k: t(v) for k, v in ref.items()}, mapping)
    assert not preport["missing_in_torch"]
    trunk = [k for k in own if k.startswith("backbone_3d.")]
    assert set(trunk) == set(mapping)
    for k in trunk:
        np.testing.assert_array_equal(got[k].numpy(), via_jax[k].numpy(), err_msg=k)
    full = model.reference_mapping()
    assert not [k for k in own if k not in full]
