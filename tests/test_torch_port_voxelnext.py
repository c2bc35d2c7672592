"""Port parity: VoxelNeXt's modules and serving against the JAX package, on
the CPU, fp32 on both sides, from the same numpy inputs and weights (flax
layout, carried across by `params_from_jax`), at tests/test_voxelnext.py's
config and grid (`vn_cfg`, `vn_grid`):

* `sparse_bev_collapse`: coordinates exactly equal, sums within 1e-6;
* `assign_targets`: nearest-voxel indices (ties included) and masks exactly
  equal, heat-map and regression targets within 1e-6;
* `aligned_iou3d` within 1e-6;
* the flax tree of JAX's init equals the port's state_dict leaf for leaf.

`predict` is in tests/test_torch_port_voxelnext_serve.py; the train step,
and with it VoxelResBackBone8xVoxelNeXt's forward and backward with its B2
calls, is in tests/test_torch_port_voxelnext_train.py; both take `pair`
from here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.geometry import iou as jiou
from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu.models import voxelnext as jvn
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.geometry.iou import aligned_iou3d
from dfu3d_tpu_torch.core.voxel import VoxelGrid, sparse_ops
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import sparse_backbone as sb
from dfu3d_tpu_torch.models import voxelnext as pvn
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import CLASS_NAMES, make_batch
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_voxelnext import vn_cfg, vn_grid

MAX_VOXELS = 2048
BRANCHES = ("hm", "center", "center_z", "dim", "rot", "iou")
# the heads' out layers at 0.1 of He-normal: logits O(1), no saturated ties
HEAD_GAINS = {f"head_{g}/{n}_out/kernel": 0.1 for g in range(3) for n in BRANCHES}


def t(a):
    return torch.from_numpy(np.array(a))


def model_cfg(variant):
    cfg = vn_cfg()
    if variant == "double_flip":
        cfg["DENSE_HEAD"]["DOUBLE_FLIP"] = True
    elif variant == "iou":
        cfg["DENSE_HEAD"]["IOU_BRANCH"] = True
        cfg["DENSE_HEAD"]["RECTIFIER"] = [0.68, 0.71, 0.65]
    return cfg


def pair(variant, seed=1, train=False, edit=None):
    """(JAX model, flax variables, port model with those weights); `edit`
    changes the config first."""
    jcfg, jgrid = model_cfg(variant), vn_grid()
    if edit is not None:
        jcfg = edit(jcfg)
    jmodel = j_build_network(jcfg, CLASS_NAMES, jgrid, max_voxels=MAX_VOXELS)
    grid = VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size)
    model = build_network(CfgDict(jcfg), CLASS_NAMES, grid, device="cpu", train=train,
                          max_voxels=MAX_VOXELS)
    variables = numpy_variables(lambda: flax_variables_like(model), seed=seed, gains=HEAD_GAINS)
    params_from_jax(variables, model)
    return jmodel, variables, model


def port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


# --------------------------------------------------------------------------
# BEV collapse, targets, IoU
# --------------------------------------------------------------------------

def random_sets(rng, b, grid, counts):
    """(coords (B, V, 3) int32, valid (B, V)) of distinct random cells per
    sample, count[i] valid of each block of slots."""
    v = sum(counts)
    coords = np.zeros((b, v, 3), np.int32)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        lin = rng.choice(grid[0] * grid[1] * grid[2], v, replace=False)
        coords[i] = np.stack([lin % grid[0], lin // grid[0] % grid[1],
                              lin // (grid[0] * grid[1])], -1)
        valid[i] = rng.uniform(0, 1, v) > 0.15
    return coords, valid


@pytest.mark.parametrize("out_cap", [512, 60])
def test_sparse_bev_collapse_matches_jax(out_cap):
    """Three stride sets scaled onto the stride-8 grid (duplicate (x, y)
    cells across z and across sets), collapsed: coordinates and masks
    exactly equal, with and without the cap binding; sums within 1e-6."""
    rng = np.random.RandomState(0)
    grid = (24, 20, 6)
    c8, v8 = random_sets(rng, 2, grid, [300])
    c16, v16 = random_sets(rng, 2, (12, 10, 3), [120])
    c32, v32 = random_sets(rng, 2, (6, 5, 2), [40])
    coords = np.concatenate([c8, c16 * [2, 2, 1], c32 * [4, 4, 1]], axis=1).astype(np.int32)
    valid = np.concatenate([v8, v16, v32], axis=1)
    feats = rng.normal(0, 1, coords.shape[:2] + (5,)).astype(np.float32)
    want = jvn.sparse_bev_collapse(
        jsb.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                         jsp.SparseGrid(*grid)), out_cap)
    got = pvn.sparse_bev_collapse(sb.SparseTensor(t(feats), t(coords), t(valid),
                                                  sparse_ops.SparseGrid(*grid)), out_cap)
    assert tuple(got.grid) == tuple(want.grid) == (24, 20, 1)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=1e-6)
    assert got.valid.sum(1).max() == min(out_cap, got.valid.sum(1).max()) > 40


def test_assign_targets_matches_jax():
    """Nearest active voxel per gt (argmin's first index among ties: gts
    placed exactly between two voxel centres), the distance gaussian, the
    exact peak and the regression targets on a random BEV set; the two
    padding gts and a gt far from every voxel claim nothing."""
    jmodel, variables, model = pair("plain")
    rng = np.random.RandomState(1)
    nx, ny = 4, 8   # vn_grid at stride 8
    coords, valid = random_sets(rng, 2, (nx, ny, 1), [24])
    bev_valid = valid.copy()
    gt = np.asarray(make_batch(np.random.RandomState(2), b=2, n=8, m=10).gt_boxes).copy()
    gt_valid = np.ones((2, 10), bool)
    gt_valid[:, -2:] = False
    # ties: gts midway between two active voxel centres along x
    cell = 0.2 * 8
    for i in range(2):
        live = np.flatnonzero(bev_valid[i])
        a, b2 = coords[i, live[0]], coords[i, live[1]]
        gt[i, 0, 0] = ((a[0] + b2[0]) / 2 + 0.5) * cell
        gt[i, 0, 1] = ((a[1] + b2[1]) / 2 + 0.5) * cell - 6.4
    gt[0, 1, :2] = [500.0, 500.0]   # nowhere near a voxel
    bev = jsb.SparseTensor(jnp.zeros((2, 24, 4)), jnp.asarray(coords), jnp.asarray(bev_valid),
                           jsp.SparseGrid(nx, ny, 1))
    want = jax.device_get(jmodel.apply(
        variables, bev, jnp.asarray(gt), jnp.asarray(gt_valid),
        method=lambda m, *a: m.assign_targets(*a)))
    got = model.assign_targets(
        sb.SparseTensor(torch.zeros(2, 24, 4), t(coords), t(bev_valid),
                        sparse_ops.SparseGrid(nx, ny, 1)), t(gt), t(gt_valid))
    hm_t, nearest, reg_t, claimed = (x.numpy() for x in got)
    np.testing.assert_array_equal(nearest, np.asarray(want[1]))
    np.testing.assert_array_equal(claimed, np.asarray(want[3]))
    np.testing.assert_allclose(hm_t, np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(reg_t, np.asarray(want[2]), atol=1e-6)
    assert not claimed[:, -2:].any() and not claimed[0, 1] and claimed.sum() >= 10
    assert (hm_t == 1.0).sum() >= 10


def test_aligned_iou3d_matches_jax():
    """Pairs of random boxes, equal boxes (IoU 1) and disjoint ones (0)."""
    rng = np.random.RandomState(3)
    n = 200
    a = np.zeros((n, 7), np.float32)
    a[:, :2] = rng.uniform(-20, 20, (n, 2))
    a[:, 2] = rng.uniform(-2, 1, n)
    a[:, 3:6] = rng.uniform(0.4, 5, (n, 3))
    a[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b = a.copy()
    b[:150, :3] += rng.normal(0, 0.6, (150, 3))
    b[:150, 3:6] *= rng.uniform(0.7, 1.3, (150, 3))
    b[:150, 6] += rng.normal(0, 0.4, 150)
    b[180:, 0] += 50.0
    want = np.asarray(jiou.aligned_iou3d(jnp.asarray(a), jnp.asarray(b)))
    got = aligned_iou3d(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[150:180], 1.0, atol=1e-5)
    assert (got[180:] == 0).all() and 0.05 < got[:150].mean() < 0.95


# --------------------------------------------------------------------------
# predict
# --------------------------------------------------------------------------

def test_flax_tree_matches_state_dict():
    """The flax tree of JAX's VoxelNeXt init (the IoU-branch variant) has
    exactly the port state_dict's leaves, in flax shapes, so
    `params_from_jax` carries every weight with no key left over."""
    jmodel, _, model = pair("iou")
    jbatch = make_batch(np.random.RandomState(3), b=1, n=64)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch,
                                                train=False))

    def leaves(tree):
        return {"/".join(k.key for k in p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert leaves(shapes) == leaves(flax_variables_like(model))
    assert any(k.endswith("iou_out/kernel") for k in leaves(shapes))
