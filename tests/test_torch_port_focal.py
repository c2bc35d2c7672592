"""Port parity: the focal sparse convolutions and the focal Voxel R-CNN
against the JAX package, on the CPU, fp32 on both sides, from the same
numpy inputs and weights (flax layout), at tests/test_pvrcnn.py's scale (a
64 x 64 x 16 grid, channels 8-16, the RoI grid pooled from x_conv2-3):

* `binary_focal_loss` and its gradient within 1e-6;
* the dilation winner: of a cell's candidates the last in the descending
  stable order of their scores, as XLA:CPU's scatter keeps the last of
  duplicate writers (ties included), equal to JAX's scatter;
* FocalSparseConv with colliding candidates and a binding `dilate_cap`
  (the winners' scores decide which cells the cap keeps), in train mode:
  the grown set's coords and mask exactly, features and focal loss within
  1e-4;
* the focal Voxel R-CNN with USE_IMG on MultimodalBatches: the per-voxel
  image features within 1e-4; predict (keep masks and labels equal, boxes
  and scores within 1e-4) and the train-mode loss (the RoI sampler's
  draws of JAX's PRNGKey(0), every term within 1e-4 relative), with 18 B2
  calls per forward; a PointBatch raises. The whole train step against
  JAX's is CaDDN's (tests/test_torch_port_camera_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.core.voxel.sparse_ops import SparseGrid as JSparseGrid
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu.models import sparse_backbone_focal as jfocal
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
from dfu3d_tpu_torch.core.voxel.sparse_ops import SparseGrid, build_lookup
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.models import sparse_backbone_focal as pfocal
from dfu3d_tpu_torch.models.sparse_backbone import SparseTensor

from test_pvrcnn import pv_cfg
from test_pvrcnn_pp import _pool_layer
from test_torch_port_camera import (Compiling, close, jax_batch, mm_arrays, port_batch, t,
                                    variables_like)
from test_torch_port_pointrcnn_train import jax_draws
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR = [0, -6.4, -3, 6.4, 6.4, 1]      # tests/test_pvrcnn.py's pv_grid
VOXEL = [0.2, 0.2, 0.25]
NAMES3 = ["Car", "Pedestrian", "Cyclist"]
GRID = SparseGrid(32, 64, 16)
TOL = 1e-4


def focal_cfg(use_img=True):
    """tests/test_pvrcnn_pp.py's VoxelRCNN config with voxel_rcnn_focal.yaml's
    BACKBONE_3D (VoxelBackBone8xFocal, TOPK, THRESHOLD 0.5, USE_IMG) at
    channels 8-16, the RoI grid pooled from the two focal stages x_conv2
    and x_conv3 (the shipped config adds x_conv4)."""
    cfg = pv_cfg()
    cfg["NAME"] = "VoxelRCNN"
    cfg["BACKBONE_3D"] = {"NAME": "VoxelBackBone8xFocal", "USE_IMG": use_img, "TOPK": True,
                          "THRESHOLD": 0.5, "KERNEL_SIZE": 3, "MASK_MULTI": False,
                          "SKIP_MASK_KERNEL": False, "CHANNELS": [8, 8, 16, 16, 16],
                          "OUT_CHANNELS": 32}
    rh = dict(cfg["ROI_HEAD"])
    rh["NAME"] = "VoxelRCNNHead"
    rh["ROI_GRID_POOL"] = {"GRID_SIZE": 4, "FEATURES_SOURCE": ["x_conv2", "x_conv3"],
                           "POOL_LAYERS": {"x_conv2": _pool_layer(0.4),
                                           "x_conv3": _pool_layer(0.8)}}
    cfg["ROI_HEAD"] = rh
    return cfg


def test_binary_focal_loss_matches_jax():
    rng = np.random.RandomState(0)
    p = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    p[0, :3] = (0.0, 1.0, 1e-9)
    target = rng.uniform(0, 1, (2, 300)) > 0.7
    valid = rng.uniform(0, 1, (2, 300)) > 0.2
    want, wgrad = jax.value_and_grad(lambda x: jfocal.binary_focal_loss(x, target, valid))(p)
    x = t(p).requires_grad_()
    got = pfocal.binary_focal_loss(x, t(target), t(valid))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    close(x.grad.numpy(), np.asarray(wgrad), 1e-6)


def test_dilation_winner_matches_jax_scatter():
    """JAX's winner table (`.at[cell[order]].set(order)` over the stable
    descending order of the scores) against `dilation_winners`, on 3000
    candidates in 200 cells with repeated scores."""
    rng = np.random.RandomState(1)
    lin = rng.randint(0, 200, (2, 3000)).astype(np.int32)
    lin[:, ::7] = 200                                      # no cell
    score = rng.randint(0, 30, (2, 3000)).astype(np.float32) / 29.0
    score[lin == 200] = -1.0
    order = jnp.argsort(-score, axis=1)
    winner = jax.vmap(lambda l, o: jnp.full((201,), -1, jnp.int32).at[jnp.take(l, o)].set(
        o, mode="drop"))(lin, order)
    want = np.asarray(jnp.take_along_axis(winner, lin, axis=1)
                      == jnp.arange(3000, dtype=jnp.int32)[None]) & (lin < 200)
    got = pfocal.dilation_winners(t(lin).long(), t(score), 200).numpy() & (lin < 200)
    np.testing.assert_array_equal(got, want)
    assert want.sum() == 2 * len(np.unique(lin[0][lin[0] < 200]))


def sparse_input(seed, b=2, v=160, cin=8):
    """Voxels in clusters of a (32, 64, 16) grid (so that dilation
    candidates of neighbouring foreground voxels collide), the last 10
    slots of each sample invalid, and 3 gt boxes over the clusters."""
    rng = np.random.RandomState(seed)
    coords = np.zeros((b, v, 3), np.int32)
    for i in range(b):
        cells = set()
        while len(cells) < v:
            c = rng.randint((2, 2, 2), (30, 62, 14))
            for _ in range(12):
                cells.add(tuple(np.clip(c + rng.randint(-2, 3, 3), 0, (31, 63, 15))))
        coords[i] = np.array(sorted(cells)[:v], np.int32)[rng.permutation(v)]
    valid = np.ones((b, v), bool)
    valid[:, -10:] = False
    coords[~valid] = 0
    feats = np.where(valid[..., None], rng.randn(b, v, cin), 0).astype(np.float32)
    gt = np.zeros((b, 3, 8), np.float32)
    centers = (coords[:, :3].astype(np.float32) + 0.5) * np.float32(0.2) + [0, -6.4, -3]
    gt[..., :3] = centers
    gt[..., 3:6] = (2.0, 2.0, 1.5)
    gt[..., 7] = 1
    return feats, coords, valid, gt, np.ones((b, 3), bool)


def test_focal_sparse_conv_matches_jax():
    """A focal layer at stride 2 with dilate_cap 24, which binds: more
    cells win than the cap keeps; in train mode (the focal loss on, BN's
    batch statistics)."""
    train = True
    feats, coords, valid, gt, gv = sparse_input(2)
    kw = dict(voxel_stride=2, point_cloud_range=tuple(PCR), voxel_size=(0.4, 0.4, 0.5),
              dilate_cap=24)
    jmod = jfocal.FocalSparseConv(channels=16, **kw)
    port = pfocal.FocalSparseConv(8, 16, **kw).train(train)
    variables = variables_like(port, seed=3)
    jst = jsb.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                           JSparseGrid(*GRID))

    def run(v):
        (out, loss), _ = jmod.apply(v, jst, jnp.asarray(gt), jnp.asarray(gv), train,
                                    mutable=["batch_stats"])
        return out.features, out.coords, out.valid, loss

    wf, wc, wv, wl = jax.device_get(jax.jit(run)(variables))
    params_from_jax(variables, port)
    st = SparseTensor(t(feats), t(coords), t(valid), GRID)
    lookup = build_lookup(GRID, st.coords, st.valid)
    with torch.no_grad():
        won = []
        winners = pfocal.dilation_winners

        def counting(*a):
            out = winners(*a)
            won.append(int(out.sum()))
            return out

        pfocal.dilation_winners = counting
        try:
            out, _, _, loss = port(st, lookup, None, t(gt), t(gv))
        finally:
            pfocal.dilation_winners = winners
    np.testing.assert_array_equal(out.valid.numpy(), wv)
    np.testing.assert_array_equal(out.coords.numpy(), wc)
    assert wv[:, -24:].all() and won[0] > wv[:, -24:].sum()   # the cap binds
    close(out.features.numpy(), wf)
    np.testing.assert_allclose(float(loss), float(wl), rtol=TOL, atol=1e-7)
    assert (float(wl) > 0) == train


# --------------------------------------------------------------------------
# the focal Voxel R-CNN
# --------------------------------------------------------------------------

def focal_pair(use_img=True, seed=1, train=False):
    """(JAX model, variables, port model, JAX cfg) as
    tests/test_torch_port_two_stage.py's `build_pair` makes them."""
    from test_torch_port_two_stage import build_pair

    return build_pair(JCfgDict(focal_cfg(use_img)), JVoxelGrid.create(PCR, VOXEL), seed,
                      train=train)


def test_voxel_image_feats_match_jax():
    """The per-voxel image features (projection, the truncating int cast,
    nearest sampling, zero outside or behind the camera)."""
    jmodel, variables, model, _ = focal_pair()
    arrays = mm_arrays(8, image_size=(48, 64), pcr=PCR)
    batch = port_batch(arrays)
    coords = np.random.RandomState(9).randint(0, (32, 64, 16), (2, 300, 3)).astype(np.int32)
    valid = np.random.RandomState(10).uniform(0, 1, (2, 300)) > 0.1
    want = jax.jit(lambda v, b: jmodel.apply(
        v, b, coords, valid, False, method=lambda m, b, c, vv, tr: m._voxel_image_feats(
            b, c, vv, tr)))(variables, jax_batch(arrays))
    with torch.no_grad():
        got = model.voxel_image_feats(batch, t(coords), t(valid))
    close(got.numpy(), np.asarray(want))
    assert (np.abs(np.asarray(want)).sum(-1) > 0).mean() > 0.2


def test_focal_voxel_rcnn_matches_jax(monkeypatch):
    """The focal Voxel R-CNN with USE_IMG on a MultimodalBatch (384 points
    per frame): predict, and the train-mode loss with the RoI sampler's
    draws of JAX's PRNGKey(0) (JAX applied without rngs, no dropout on
    either side), every term (the focal layers' loss_box_of_pts among them)
    within 1e-4 relative; JAX's two programs compile side by side. B2 is
    called 18 times per forward, focal1's importance conv on 8 + 16 image
    channels among them. A PointBatch raises. (At 768 points per frame a
    train-mode importance score lies within the packages' fp32 rounding of
    the 0.5 threshold and the grown sets differ; test_focal_sparse_conv_
    matches_jax holds the layer's decisions exact on equal inputs.)"""
    jmodel, variables, model, _ = focal_pair(seed=11)
    arrays = mm_arrays(12, image_size=(48, 64), pcr=PCR, n=384)

    def loss_fn(v, b):
        (loss, tb), _ = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return loss, tb

    predict = Compiling(lambda v, b: jmodel.apply(v, b, method=lambda m, bb: m.predict(bb)),
                        variables, jax_batch(arrays))
    train = Compiling(loss_fn, variables, jax_batch(arrays))
    batch = port_batch(arrays)
    calls = []
    kernel = gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm",
                        lambda *a: calls.append(tuple(a[3].shape)) or kernel(*a))
    with torch.no_grad():
        gb, gs, gl, gv = (a.numpy() for a in model.eval().predict(batch))
    assert len(calls) == 18 and calls.count((27, 8 + 16, 27)) == 1
    draws = jax_draws(np.asarray(jax.random.PRNGKey(0)), 2, model.train_proposal_nms["post_max"])
    monkeypatch.setattr(proi, "draw_roi_uniforms", lambda gen, shape, device: draws)
    loss, tb = model.train()(batch)

    wb, ws, wl, wv = jax.device_get(predict.result()(variables, jax_batch(arrays)))
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 4
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=TOL)
    jloss, jtb = jax.device_get(train.result()(variables, jax_batch(arrays)))
    assert set(tb) == set(jtb) and float(jtb["loss_box_of_pts"]) > 0
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=TOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    with pytest.raises(TypeError, match="MultimodalBatch"):
        model(PointBatch.from_numpy(*arrays[:4]))
