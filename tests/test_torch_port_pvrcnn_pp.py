"""Port parity: PV-RCNN++ (PVRCNNPlusPlus) against the JAX package, on the
CPU, fp32 on both sides, from the same numpy inputs and weights, at
tests/test_pvrcnn_pp.py's test-scale config (the reference
VectorPoolAggregationModuleMSG schema, 128 keypoints, 2 x 2 x 2 bins):

* `vector_pool`: the ball query's `idx` and `has` exactly equal, the
  per-bin means within 1e-5 (a one-hot product on both sides, summed in
  another order), with and without source features, empty balls, invalid
  queries and invalid sources included, against a numpy brute force too;
* `VPFromSource` in train mode: outputs within 1e-5, every gradient within
  1e-4 of its largest entry, an empty or invalid query's output 0;
* the proposal-centric keypoint mask, the RoIs' fallback to all points;
* a served request (`predict`): keep masks and labels exactly equal, boxes
  and scores within 1e-4;
* the shipped config's reference mapping: the RPN's only;
* the span profile (the proposal-centric FPS and its mask, the VSA's and
  the grid's vector pools).

One train step against JAX's `make_train_step` is in
tests/test_torch_port_pvrcnn_pp_train.py, with `pp_pair` from here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core import pointnet2 as jP
from dfu3d_tpu.models import pvrcnn as jpv
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import pointnet2 as P
from dfu3d_tpu_torch.models import pvrcnn as ppv

from test_model import make_batch
from test_pvrcnn import pv_cfg, pv_grid
from test_torch_port_models import numpy_variables
from test_torch_port_two_stage import build_pair, port_batch, sa_scene, t
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_two_stage_cli import check_two_stage_spans


def pp_cfg():
    """tests/test_pvrcnn_pp.py's PVRCNNPlusPlus config."""
    cfg = pv_cfg()
    cfg["NAME"] = "PVRCNNPlusPlus"
    cfg["PFE"] = {"NAME": "VectorPoolAggregation", "NUM_KEYPOINTS": 128, "SA_MLP": [8, 8],
                  "FUSION_MLP": [32], "NSAMPLE": 8, "STAGE_RADII": [0.4, 0.8, 1.6, 3.2],
                  "VP_BINS": [2, 2, 2], "SPC_RADIUS": 2.4}
    group = {"NUM_LOCAL_VOXEL": [2, 2, 2], "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16, 16]}
    cfg["ROI_HEAD"] = {
        **pv_cfg()["ROI_HEAD"], "NAME": "PVRCNNHead",
        "ROI_GRID_POOL": {"GRID_SIZE": 4, "NAME": "VectorPoolAggregationModuleMSG",
                          "NUM_GROUPS": 2, "MSG_POST_MLPS": [16],
                          "GROUP_CFG_0": {**group, "MAX_NEIGHBOR_DISTANCE": 0.8},
                          "GROUP_CFG_1": {**group, "MAX_NEIGHBOR_DISTANCE": 1.6}}}
    return cfg


def pp_pair(seed=1, train=False):
    return build_pair(pp_cfg(), pv_grid(), seed=seed, train=train)


@pytest.mark.parametrize("with_feats", [False, True])
def test_vector_pool_matches_jax(with_feats):
    """sa_scene's sources and queries (a tenth of the queries far away,
    the last 5 invalid, the last 20 sources invalid), radius 0.7, 8 slots,
    3 x 2 x 2 bins: idx and has exact, the means within 1e-5 of JAX's and
    of a numpy brute force over the first 8 hits."""
    rng = np.random.RandomState(11)
    q, qv, src, feats, sv = sa_scene(rng, c=5)
    radius, nsample, bins = 0.7, 8, (3, 2, 2)
    jf = jnp.asarray(feats) if with_feats else None
    want, whas = jax.vmap(lambda a, b, c, d, f: jP.vector_pool(a, b, c, d, f, radius, nsample,
                                                                  bins),
                          in_axes=(0, 0, 0, 0, 0 if with_feats else None))(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(src), jnp.asarray(sv), jf)
    got, has = P.vector_pool(t(q), t(qv), t(src), t(sv), t(feats) if with_feats else None,
                             radius, nsample, bins)
    np.testing.assert_array_equal(has.numpy(), np.asarray(whas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    c = 3 + (5 if with_feats else 0)
    got = got.numpy().reshape(2, 60, 12, c)
    empty = ~(has.numpy())
    assert empty.sum() >= 10 and (got[empty] == 0).all()
    for b in range(2):
        for m in range(0, 60, 7):
            d = src[b] - q[b, m]
            hits = np.where((np.sum(d * d, axis=1) <= radius ** 2) & sv[b] & qv[b, m])[0]
            hits = hits[:nsample]
            rel = (src[b, hits] - q[b, m] + radius) / (2 * radius)
            cell = np.minimum((rel * np.array(bins, np.float32)).astype(int), np.array(bins) - 1)
            ids = (cell[:, 0] * 2 + cell[:, 1]) * 2 + cell[:, 2]
            for k in range(12):
                sel = hits[ids == k]
                want_k = np.zeros(c, np.float32)
                if len(sel):
                    want_k[:3] = (src[b, sel] - q[b, m]).mean(0)
                    if with_feats:
                        want_k[3:] = feats[b, sel].mean(0)
                np.testing.assert_allclose(got[b, m, k], want_k, rtol=0, atol=1e-5)


def test_vp_from_source_matches_jax():
    """Train mode with features: outputs within 1e-5, the MLP's gradients
    and the sources' feature gradient within 1e-4 of their largest entry."""
    rng = np.random.RandomState(12)
    q, qv, src, feats, sv = sa_scene(rng, c=5)
    jmod = jpv.VPFromSource(radius=0.7, nsample=8, bins=(2, 2, 2), mlp=(16, 12))
    args = tuple(map(jnp.asarray, (q, qv, src)))
    variables = numpy_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), *args, jnp.asarray(feats), jnp.asarray(sv),
                          train=False), seed=13)
    port = params_from_jax(variables, ppv.VPFromSource(5, 0.7, 8, (2, 2, 2), (16, 12))).train()
    r = rng.normal(0, 1, (2, 60, 12)).astype(np.float32)

    def jfn(params, f):
        out, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            *args, f, jnp.asarray(sv), train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, want), (wg, wf) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(feats))
    f = t(feats).requires_grad_(True)
    out = port(t(q), t(qv), t(src), f, t(sv))
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1 and (want[:, -5:] == 0).all()
    (out * t(r)).sum().backward()
    wg = params_from_jax({"params": jax.device_get(wg)})
    for k, p in port.named_parameters():
        w = wg[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    wf = np.asarray(wf)
    np.testing.assert_allclose(f.grad.numpy(), wf, rtol=0, atol=1e-4 * np.abs(wf).max())


def test_keypoint_mask():
    """A point is kept within SPC_RADIUS (strictly) of a valid RoI's centre;
    a frame with no valid RoI keeps every valid point."""
    _, _, model, _ = pp_pair()
    pts = np.zeros((2, 6, 4), np.float32)
    pts[:, :, 0] = [0.0, 2.3, 2.4, 2.5, 10.0, 0.5]
    valid = np.array([[True] * 5 + [False], [True] * 6])
    rois = np.zeros((2, 2, 7), np.float32)
    rois[:, 1, 0] = 10.0
    roi_valid = np.array([[True, False], [False, False]])
    batch = port_batch(make_batch(np.random.RandomState(0), b=2, n=6))._replace(
        points=t(pts), points_valid=t(valid))
    got = model.keypoint_mask(batch, t(rois), t(roi_valid)).numpy()
    np.testing.assert_array_equal(got, [[True, True, False, False, False, False],
                                        [True] * 6])


def test_predict_matches_jax():
    jmodel, variables, model, _ = pp_pair()
    jbatch = make_batch(np.random.RandomState(4), b=2, n=512)
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, b: m.predict(b)))(variables, jbatch))
    with torch.no_grad():
        got = model.predict(port_batch(jbatch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum(1).min() >= 2
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)


def test_reference_mapping_is_the_rpns():
    """The JAX package maps no PV-RCNN++ head, so the port's mapping is the
    2D backbone's and the anchor head's."""
    _, _, model, _ = pp_pair()
    mapped = set(model.reference_mapping())
    assert mapped and all(k.startswith(("backbone_2d.", "dense_head.")) for k in mapped)


def test_two_stage_spans(monkeypatch):
    _, _, model, _ = pp_pair()
    check_two_stage_spans(model, monkeypatch, ("vsa", "vsa.fps", "vsa.keypoint_mask"),
                          ("kp_seg_loss",))
