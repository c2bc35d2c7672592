"""Port parity: PartA2's modules (models/parta2.py) against the JAX package,
on the CPU, fp32 on both sides, from the same numpy inputs and weights:

* `parent_gather`: each fine voxel's stride-2 parent feature exactly equal
  to JAX's `_parent_gather`, the parents the coarse cap dropped reading 0;
* SparseUNet in train mode (BN biases +3 on both sides, as in the
  SparseEncoder test): every level's coordinates and masks exactly equal,
  the conv_out and decoder features within 1e-4, the loss Σ features · R
  within 1e-5 relative, every gradient within 1e-4 of its largest entry
  (jax.value_and_grad against B2's plain twin forward and dX), the BN
  running statistics within 1e-5; B2 runs 12 times forward and 11 times
  for dX (conv_in's input needs none), mirrored;
* `roiaware_pool`, max and avg: outputs within 1e-6 and the features'
  gradient within 1e-6 (RoIs with more points than the sample, an invalid
  RoI, points on no RoI), and the JAX test's closed-form placement;
* PartA2RoIHead in train mode, JAX's dropout masks handed over: outputs
  within 1e-5, every gradient within 1e-4 of its largest entry;
* the part targets with overlapping boxes: fg equal, the first box wins,
  part locations within 1e-6.

tests/test_torch_port_parta2_model.py holds the detector's served request,
its train step, its reference mapping and PartA2_free.yaml.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import parta2 as jpa
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.core.geometry.boxes import points_in_boxes
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
from dfu3d_tpu_torch.models import parta2 as ppa

from test_parta2 import pa2_cfg, pa2_grid
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_sparse import PCR, VS, ground_points
from test_torch_port_two_stage import (BN_SHIFT, CHANS, GRID, MAX_VOXELS, OUT_CH, VOXEL_CAP,
                                       DropoutMasks, build_pair, random_rois, t)
from test_torch_port_two_stage import few_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def unet_setup():
    pts, valid = ground_points(np.random.RandomState(40), 2)
    vox = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), MAX_VOXELS)
    feats = np.random.RandomState(41).normal(0, 1, (2, MAX_VOXELS, 4)).astype(np.float32)
    feats *= vox.voxel_valid.numpy()[..., None]
    return vox, feats


def port_unet(variables=None, train=False):
    unet = ppa.SparseUNet(GRID, VOXEL_CAP, in_channels=4, channels=CHANS, out_channels=OUT_CH)
    return params_from_jax(variables, unet.train(train)) if variables else unet


def test_parent_gather_matches_jax(unet_setup):
    """Stride-2 parents of the stride-1 voxels (the stride-2 cap binding,
    so that some have none) and of the stride-2 ones: the gathered features
    equal JAX's."""
    vox, _ = unet_setup
    levels, parents = port_unet().plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
    assert (levels[1].num_unique > levels[1].coords.shape[1]).all()
    rng = np.random.RandomState(43)
    for i in range(2):
        fine, coarse = levels[i], levels[i + 1]
        feats = rng.normal(0, 1, tuple(coarse.coords.shape[:2]) + (5,)).astype(np.float32)
        st = ppa.SparseTensor(t(feats), coarse.coords, coarse.valid, coarse.grid)
        got = ppa.parent_gather(st, parents[i]).numpy()
        jst = jsb.SparseTensor(jnp.asarray(feats), jnp.asarray(coarse.coords.numpy()),
                               jnp.asarray(coarse.valid.numpy()), jsp.SparseGrid(*coarse.grid))
        want = np.asarray(jpa._parent_gather(jst, jnp.asarray(fine.coords.numpy()),
                                             jnp.asarray(fine.valid.numpy())))
        np.testing.assert_array_equal(got, want)
        live = fine.valid.numpy()
        orphans = live & (np.abs(want).sum(-1) == 0)
        assert (orphans.sum() > 0) == (i == 0) and (live & ~orphans).sum() > 0


def test_sparse_unet_train_matches_jax(unet_setup, monkeypatch):
    vox, feats = unet_setup
    jmod = jpa.SparseUNet(grid=jsp.SparseGrid(*GRID), voxel_cap=VOXEL_CAP, channels=CHANS,
                          out_channels=OUT_CH, dtype=jnp.float32)
    variables = numpy_variables(lambda: flax_variables_like(port_unet()), seed=5)
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda path, x: x + BN_SHIFT if path[-1].key == "bias" else x, variables["params"]),
        "batch_stats": variables["batch_stats"]}
    jc, jv = jnp.asarray(vox.voxel_coords.numpy()), jnp.asarray(vox.voxel_valid.numpy())
    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(tuple(args[3].shape))
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    unet = port_unet(variables, train=True)
    plan = unet.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique, transpose=True)
    bev, d1 = unet(torch.from_numpy(feats), plan)
    assert len(calls) == 12
    r = np.random.RandomState(42).normal(0, 1, tuple(d1.features.shape)).astype(np.float32)

    def j_loss(params):
        (jbev, jd1), upd = jmod.apply({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(feats), jc, jv, train=True,
                                      mutable=["batch_stats"])
        return jnp.sum(jbev.features) + jnp.sum(jd1.features * r), (jbev, jd1, upd)

    (j_val, (jbev, jd1, j_upd)), j_grads = jax.device_get(jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(variables["params"]))
    for got, want in ((bev, jbev), (d1, jd1)):
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.features.detach().numpy(), np.asarray(want.features),
                                   rtol=0, atol=1e-4)
        assert np.abs(np.asarray(want.features)).max() > 0.1
    loss = bev.features.sum() + (d1.features * t(r)).sum()
    loss.backward()
    assert len(calls) == 23
    assert calls[12:] == [(k, co, ci) for k, ci, co in reversed(calls[1:12])]
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    want = params_from_jax({"params": j_grads})
    got = {k: p.grad for k, p in unet.named_parameters()}
    assert set(got) == set(want) and len(got) == 12 + 2 * 8
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(w).max() > 1e-3, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    stats = params_from_jax({"batch_stats": j_upd["batch_stats"]})
    own = unet.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_roiaware_pool_placement():
    """The JAX test's closed form: one axis-aligned 2 m RoI at the origin, a
    point in its low and one in its high octant, on a 4³ grid."""
    rois = t(np.array([[[0, 0, 0, 2, 2, 2, 0]]], np.float32))
    pts = t(np.array([[[-0.75, -0.75, -0.75], [0.75, 0.75, 0.75]]], np.float32))
    feats = t(np.array([[[1.0], [2.0]]], np.float32))
    g = ppa.roiaware_pool(pts, feats, torch.ones(1, 2, dtype=torch.bool), rois,
                          torch.ones(1, 1, dtype=torch.bool), 8, 4)[0, 0, ..., 0].numpy()
    assert g[0, 0, 0] == 1.0 and g[3, 3, 3] == 2.0 and g.sum() == 3.0


@pytest.mark.parametrize("reduce", ["max", "avg"])
def test_roiaware_pool_matches_jax(reduce):
    """2 frames of 300 points in an 8 m square (the last 30 invalid), 6
    rotated RoIs each (the last invalid), 24 samples per RoI (the larger
    RoIs hold more), a 4³ grid: outputs and the features' gradient within
    1e-6."""
    rng = np.random.RandomState(44)
    pts = rng.uniform(-4, 4, (2, 300, 3)).astype(np.float32)
    pts[..., 2] *= 0.25
    valid = np.ones((2, 300), bool)
    valid[:, -30:] = False
    feats = rng.normal(0, 1, (2, 300, 5)).astype(np.float32)
    rois = random_rois(rng, 2, 6, extent=3.0)
    roi_valid = np.ones((2, 6), bool)
    roi_valid[:, -1] = False
    r = rng.normal(0, 1, (2, 6, 4, 4, 4, 5)).astype(np.float32)

    def jfn(f):
        out = jax.vmap(lambda x, ff, v, ro, rv: jpa.roiaware_pool(x, ff, v, ro, rv, 24, 4,
                                                                   reduce=reduce))(
            jnp.asarray(pts), f, jnp.asarray(valid), jnp.asarray(rois), jnp.asarray(roi_valid))
        return jnp.sum(out * r), out

    (_, want), wg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(feats))
    f = t(feats).requires_grad_(True)
    got = ppa.roiaware_pool(t(pts), f, t(valid), t(rois), t(roi_valid), 24, 4, reduce)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    occupied = (want != 0).any(-1)
    assert occupied[:, :-1].sum() > 50 and not occupied[:, -1].any()
    (got * t(r)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wg), rtol=0, atol=1e-6)


def test_roi_head_matches_jax(monkeypatch):
    """2 x 3 RoIs on a 4³ grid, about half the cells empty (the rpn stream
    zero there too), NUM_FEATURES 16, SHARED_FC 32, 32, CLS_FC / REG_FC 16,
    train mode with JAX's 3 dropout masks: outputs within 1e-5, the
    parameters' and the inputs' gradients within 1e-4 of their largest
    entry, the BN running statistics within 1e-5."""
    rng = np.random.RandomState(45)
    occ = rng.uniform(size=(2, 3, 4, 4, 4, 1)) < 0.5
    part = (rng.uniform(0.05, 1, (2, 3, 4, 4, 4, 4)) * occ).astype(np.float32)
    rpn = (rng.normal(0, 1, (2, 3, 4, 4, 4, 6)) * occ).astype(np.float32)
    jmod = jpa.PartA2RoIHead(grid_size=4, num_features=16, shared_fc=(32, 32), cls_fc=(16,),
                             reg_fc=(16,), dp_ratio=0.3)
    port = ppa.PartA2RoIHead(4, 6, 4, 16, (32, 32), (16,), (16,), 0.3)
    variables = numpy_variables(lambda: flax_variables_like(port), seed=46)
    params_from_jax(variables, port).train()
    rc, rr = rng.normal(0, 1, (2, 3)), rng.normal(0, 1, (2, 3, 7))
    masks = DropoutMasks(monkeypatch)

    def jfn(params, p, q):
        (cls, reg), upd = jmod.apply({"params": params,
                                      "batch_stats": variables["batch_stats"]}, p, q,
                                     train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(3)})
        return jnp.sum(cls * rc) + jnp.sum(reg * rr), (cls, reg, upd)

    (_, (wc, wr, upd)), (wg, wp, wq) = jax.device_get(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(variables["params"], jnp.asarray(part),
                                              jnp.asarray(rpn)))
    assert len(masks.masks) == 3
    left = masks.hand_over(monkeypatch)
    p, q = t(part).requires_grad_(True), t(rpn).requires_grad_(True)
    cls, reg = port(p, q, torch.Generator())
    assert not left
    np.testing.assert_allclose(cls.detach().numpy(), wc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(reg.detach().numpy(), wr, rtol=0, atol=1e-5)
    ((cls * t(rc).float()).sum() + (reg * t(rr).float()).sum()).backward()
    want = params_from_jax({"params": wg})
    for k, prm in port.named_parameters():
        w = want[k].numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(prm.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    for got, w in ((p.grad, wp), (q.grad, wq)):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    stats = params_from_jax({"batch_stats": upd["batch_stats"]})
    own = port.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_part_targets_match_jax():
    """Voxels of the PartA2 test grid against 4 gt boxes per frame (boxes 0
    and 1 overlap, box 3 is invalid and overlaps box 2): fg and the part
    locations equal JAX's `_part_targets`; a voxel inside boxes 0 and 1
    takes box 0's part location."""
    jmodel, variables, model, _ = build_pair(pa2_cfg(), pa2_grid())
    rng = np.random.RandomState(47)
    coords = np.stack([rng.randint(0, 64, (2, 400)), rng.randint(0, 64, (2, 400)),
                       rng.randint(0, 16, (2, 400))], axis=-1).astype(np.int32)
    valid = np.ones((2, 400), bool)
    valid[:, -40:] = False
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, :, 7] = 1
    gt[:, 0] = [3.0, 0.0, -1.0, 4.0, 3.0, 2.0, 0.3, 1]
    gt[:, 1] = [4.5, 1.0, -1.0, 4.0, 3.0, 2.0, -0.4, 1]
    gt[:, 2] = [8.0, -3.0, -1.0, 3.0, 2.0, 2.0, 1.2, 1]
    gt[:, 3] = [8.5, -3.0, -1.0, 3.0, 2.0, 2.0, 0.0, 1]
    gt_valid = np.array([[True, True, True, False]] * 2)
    jst = jsb.SparseTensor(jnp.zeros((2, 400, 1)), jnp.asarray(coords), jnp.asarray(valid),
                           jsp.SparseGrid(64, 64, 16))
    wfg, wpart = jax.device_get(jmodel.apply(
        variables, jst, jnp.asarray(gt), jnp.asarray(gt_valid),
        method=lambda m, *a: m._part_targets(*a)))
    st = ppa.SparseTensor(torch.zeros(2, 400, 1), t(coords), t(valid), None)
    centers = model.voxel_centers(st)
    fg, part = ppa.part_targets(centers, t(valid), t(gt), t(gt_valid))
    np.testing.assert_array_equal(fg.numpy(), wfg)
    np.testing.assert_allclose(part.numpy(), wpart, rtol=0, atol=1e-6)
    inside = points_in_boxes(centers, t(gt[..., :7])).numpy()
    both = inside[..., 0] & inside[..., 1] & valid
    assert both.sum() > 0 and fg.numpy()[~valid].sum() == 0
    fg0, part0 = ppa.part_targets(centers, t(valid), t(gt[:, :1]), t(gt_valid[:, :1]))
    assert fg0.numpy()[both].all()
    np.testing.assert_array_equal(part.numpy()[both], part0.numpy()[both])
