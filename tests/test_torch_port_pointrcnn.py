"""Port parity for PointRCNN serving: the box helpers and coders, RoI point
pooling, the RoI head, proposal_layer, final_nms and the whole `predict` at
tests/test_pointrcnn.py's tiny widths against the JAX package, fp32 on both
sides, from the same numpy inputs and weights (flax layout, carried by
`params_from_jax`); the NMS_CONFIG fallback on DFU3D's shipped config; and
tools.test on that config from a synthetic KITTI root on the CPU.

Tolerances: gathers, masks, NMS choices and labels are exact; geometry
within GEOM_TOL (cos/sin may differ by an ulp between XLA and torch);
network outputs within NET_TOL (dense sums ordered otherwise).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.core.geometry import boxes as jboxes
from dfu3d_tpu.models import anchor_head as janchor
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import pointrcnn as jprcnn
from dfu3d_tpu.models import roi_head as jroi
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch import profile_serve
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import pointnet2
from dfu3d_tpu_torch.core.geometry import boxes as pboxes
from dfu3d_tpu_torch.core.geometry import iou_kernel
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.flagship import seeded_weights_
from dfu3d_tpu_torch.models import anchor_head as panchor
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import pointrcnn as pprcnn
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.tools import create_infos, test as test_cli
from dfu3d_tpu_torch.train.train_state import make_eval_step
from dfu3d_tpu_torch.utils.config import CfgDict
from dfu3d_tpu_torch.zoo import POINTRCNN_CFG, pointrcnn

from test_model import CLASS_NAMES, make_batch, tiny_grid
from test_pointrcnn import prcnn_cfg
from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

GEOM_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, b, n, extent=8.0, size=(0.5, 3.0)):
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0:2] = rng.uniform(0, extent, (b, n, 2))
    bx[..., 2] = rng.uniform(-1, 1, (b, n))
    bx[..., 3:6] = rng.uniform(*size, (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    return bx


def test_box_helpers_and_coders_match_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 8, (2, 300, 3)).astype(np.float32)
    bx = random_boxes(rng, 2, 9)
    want = np.asarray(jax.jit(jax.vmap(jboxes.points_in_boxes))(pts, bx))
    got = pboxes.points_in_boxes(t(pts), t(bx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()
    np.testing.assert_array_equal(
        pboxes.enlarge_box3d(t(bx), (0.2, 0.3, 0.4)).numpy(),
        np.asarray(jboxes.enlarge_box3d(jnp.asarray(bx), (0.2, 0.3, 0.4))))

    anchors = random_boxes(rng, 2, 9)
    enc = np.asarray(janchor.encode_boxes(jnp.asarray(bx), jnp.asarray(anchors)))
    np.testing.assert_allclose(panchor.encode_boxes(t(bx), t(anchors)).numpy(), enc, **GEOM_TOL)
    np.testing.assert_allclose(panchor.decode_boxes(t(enc), t(anchors)).numpy(),
                               np.asarray(janchor.decode_boxes(jnp.asarray(enc),
                                                               jnp.asarray(anchors))), **GEOM_TOL)
    codes = rng.normal(size=(2, 300, 8)).astype(np.float32)
    cls = rng.randint(1, 9, (2, 300))
    mean = [[4.63, 1.97, 1.74], [6.93, 2.51, 2.84], [0.73, 0.67, 1.77]] * 3
    np.testing.assert_allclose(
        pprcnn.point_decode(t(codes), t(pts), t(cls), mean[:8]).numpy(),
        np.asarray(jprcnn.point_decode(jnp.asarray(codes), jnp.asarray(pts),
                                       jnp.asarray(cls), mean[:8])), **GEOM_TOL)


def test_pool_roi_points_matches_jax():
    """32 slots per RoI: some RoIs hold more points (later ones dropped),
    some fewer, one is invalid."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 4, (2, 600, 3)).astype(np.float32)
    pts[..., 2] -= 2.0
    valid = rng.uniform(size=(2, 600)) > 0.1
    feats = rng.normal(size=(2, 600, 5)).astype(np.float32)
    rois = random_boxes(rng, 2, 6, extent=4.0, size=(0.5, 2.5))
    rois[:, :2, 3:6] = 0.2   # small RoIs: fewer points than slots
    roi_valid = np.ones((2, 6), bool)
    roi_valid[1, 4] = False
    jpool = jax.jit(jax.vmap(
        lambda p, f, v, r, rv: jprcnn.pool_roi_points(p, f, v, r, rv, 32, 1.0)))
    wl, wf, wv = (np.asarray(a) for a in jpool(*map(jnp.asarray,
                                                    (pts, feats, valid, rois, roi_valid))))
    gl, gf, gv = pprcnn.pool_roi_points(t(pts), t(feats), t(valid), t(rois), t(roi_valid), 32,
                                        1.0)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gf.numpy(), wf)
    np.testing.assert_allclose(gl.numpy(), wl, **GEOM_TOL)
    counts = wv.sum(-1)
    assert (counts == 32).any() and ((counts > 0) & (counts < 32)).any() and counts[1, 4] == 0


def test_roi_head_matches_jax():
    rh = prcnn_cfg()["ROI_HEAD"]
    sa = rh["SA_CONFIG"]
    spec = dict(xyz_up=tuple(rh["XYZ_UP_LAYER"]), sa_npoints=tuple(sa["NPOINTS"]),
                sa_radii=tuple(sa["RADIUS"]), sa_nsamples=tuple(sa["NSAMPLE"]),
                sa_mlps=tuple(tuple(m) for m in sa["MLPS"]), cls_fc=tuple(rh["CLS_FC"]),
                reg_fc=tuple(rh["REG_FC"]), use_bn=False)
    rng = np.random.RandomState(2)
    m, s, c = 6, 32, 64
    local = rng.uniform(-1, 1, (m, s, 3)).astype(np.float32) * [1.0, 1.0, 0.5]
    local = local.astype(np.float32)
    prefix = rng.uniform(-0.5, 1, (m, s, 2)).astype(np.float32)
    feats = rng.normal(size=(m, s, c)).astype(np.float32)
    valid = np.arange(s)[None, :] < np.array([32, 20, 5, 1, 0, 12])[:, None]
    jm = jprcnn.PointRCNNRoIHead(num_samples=s, **spec)
    variables = numpy_variables(lambda: jm.init({"params": jax.random.PRNGKey(0)}, local,
                                                prefix, feats, valid, False))
    wc, wr = (np.asarray(a) for a in jax.jit(jm.apply, static_argnums=5)(
        variables, local, prefix, feats, valid, False))
    port = pprcnn.PointRCNNRoIHead(in_channels=c, num_samples=s, **spec).eval()
    params_from_jax(variables, port)
    with torch.no_grad():
        gc, gr = port(t(local), t(prefix), t(feats), t(valid))
    np.testing.assert_allclose(gc.numpy(), wc, **NET_TOL)
    np.testing.assert_allclose(gr.numpy(), wr, **NET_TOL)


def clustered_proposals(rng, b, n, k=3):
    """n boxes jittered around a few centres, so that NMS suppresses."""
    centres = random_boxes(rng, b, 12, size=(1.0, 4.0))
    pick = rng.randint(0, 12, (b, n))
    bx = np.take_along_axis(centres, pick[..., None], 1).copy()
    bx[..., 0:3] += rng.normal(0, 0.15, (b, n, 3))
    bx[..., 3:6] *= rng.uniform(0.9, 1.1, (b, n, 3))
    bx[..., 6] += rng.normal(0, 0.1, (b, n))
    scores = rng.uniform(size=(b, n, k)).astype(np.float32)
    return bx.astype(np.float32), scores


def test_proposal_layer_matches_jax():
    rng = np.random.RandomState(3)
    bx, cls = clustered_proposals(rng, 2, 300)
    for train in (False, True):
        assert (proi.resolve_nms_cfg(CfgDict(prcnn_cfg()["ROI_HEAD"]), train)
                == jroi.resolve_nms_cfg(prcnn_cfg()["ROI_HEAD"], train))
    nms_cfg = dict(pre_max=256, post_max=64, thresh=0.5, score_thresh=0.2)
    want = [np.asarray(a) for a in jroi.proposal_layer(jnp.asarray(bx), jnp.asarray(cls),
                                                       nms_cfg)]
    got = [a.numpy() for a in proi.proposal_layer(t(bx), t(cls), nms_cfg)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < want[3].sum(1).min() and want[3].sum(1).max() < 64   # NMS suppressed
    # the shipped config's flat keys: pre 4096, post 128, IoU 0.8
    shipped = proi.resolve_nms_cfg(CfgDict(yaml.safe_load(POINTRCNN_CFG.read_text())
                                           ["MODEL"]["ROI_HEAD"]), train=False)
    assert shipped == dict(pre_max=4096, post_max=128, thresh=0.8, score_thresh=None)


def test_final_nms_fallback_on_the_shipped_config():
    """JAX's final_nms raises KeyError on DFU3D's POST_PROCESSING (no
    NMS_CONFIG); the port serves it with the dict JAX's predict falls back
    to, and equals JAX's final_nms given that dict explicitly."""
    jcfg = j_cfg_from_yaml_file(POINTRCNN_CFG, JCfgDict())
    rng = np.random.RandomState(4)
    bx, _ = clustered_proposals(rng, 2, 128)
    scores = rng.uniform(size=(2, 128)).astype(np.float32)
    labels = rng.randint(1, 9, (2, 128)).astype(np.int32)
    valid = rng.uniform(size=(2, 128)) > 0.2
    args = tuple(map(jnp.asarray, (bx, scores, labels, valid)))
    with pytest.raises(KeyError, match="NMS_CONFIG"):
        jroi.final_nms(*args, jcfg.MODEL.POST_PROCESSING)
    pp = proi.fallback_post_processing(CfgDict(jcfg.MODEL.POST_PROCESSING), 128)
    assert pp == {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
        "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 128, "NMS_THRESH": 0.1}}
    want = [np.asarray(a) for a in jroi.final_nms(*args, pp)]
    got = [a.numpy() for a in proi.final_nms(t(bx), t(scores), t(labels).long(), t(valid), pp)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < want[3].sum()


def test_shipped_config_serves_at_full_width(caplog):
    """The shipped config at its published widths (4.04 M parameters) on a
    small input: B=1, 512 points, so every FPS level repeats points. The
    model logs the final NMS's fallback dict, whose post size is the RoI
    count of the proposal NMS (128)."""
    with caplog.at_level("WARNING", logger="dfu3d_tpu_torch"):
        cfg, _, model = pointrcnn(device="cpu")
    assert model.post_processing == {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
        "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 128, "NMS_THRESH": 0.1}}
    assert f"falls back to {model.post_processing}" in caplog.text
    assert sum(p.numel() for p in model.parameters()) == 4_040_104
    seeded_weights_(model, seed=0)
    batch = PointBatch.from_numpy(*make_batch(np.random.RandomState(5), b=1, n=512))
    with torch.no_grad():
        boxes, scores, labels, valid = model.predict(batch)
    assert boxes.shape == (1, 128, 7) and torch.isfinite(boxes).all()
    assert valid.any() and (scores[valid] >= 0.1).all()
    assert ((labels[valid] >= 1) & (labels[valid] <= len(cfg.CLASS_NAMES))).all()


@pytest.fixture(scope="module")
def tiny_predict():
    """The whole predict at tests/test_pointrcnn.py's widths (JAX is given
    POST_PROCESSING.NMS_CONFIG, which that config has)."""
    jcfg = prcnn_cfg()
    assert "NMS_CONFIG" in jcfg["POST_PROCESSING"]
    jmodel = j_build_network(jcfg, CLASS_NAMES, tiny_grid())
    jbatch = make_batch(np.random.RandomState(12), b=2, n=256)
    # small point-box codes, so that each proposal sits on its point with
    # about its class's mean size and pools points; RoI scores spread by a
    # larger gain on the RoI head's cls output
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False), seed=3,
        gains={"point_head/reg_out/kernel": 0.05, "roi_head/cls_fc/out/kernel": 3.0})
    want = jax.jit(lambda v, b: jmodel.apply(v, b, method=lambda m, x: m.predict(x)))(
        variables, jbatch)
    model = build_network(CfgDict(jcfg), CLASS_NAMES, tiny_grid(), device="cpu")
    params_from_jax(variables, model)
    with torch.no_grad():
        got = model.predict(PointBatch.from_numpy(*jbatch))
    return [a.numpy() for a in got], [np.asarray(a) for a in want]


def test_predict_matches_jax(tiny_predict):
    (gb, gs, gl, gv), (wb, ws, wl, wv) = tiny_predict
    assert gb.shape == (2, 16, 7)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 2
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gb[gv], wb[wv], **NET_TOL)
    np.testing.assert_allclose(gs, ws, **NET_TOL)


def test_pointrcnn_profile_on_the_cpu(monkeypatch):
    """profile_serve.pointrcnn_profile (what `profile_serve --model
    pointrcnn` and chip_smoke.py's PointRCNN phase report) on the tiny
    config, its device syncs made no-ops: every span keyed under its outer
    span, exclusive times that add up to the step, the FPS share, the FPS
    iterations of the config, two keep-scans per step, and every wrapped
    function restored."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = prcnn_cfg()
    model = build_network(CfgDict(cfg), CLASS_NAMES, tiny_grid(), device="cpu")
    seeded_weights_(model, seed=0)
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    batches = [PointBatch.from_numpy(*make_batch(np.random.RandomState(s), b=2, n=256))
               for s in (1, 2)]
    fps = pointnet2.farthest_point_sample
    out = profile_serve.pointrcnn_profile(model, step, batches)
    assert pointnet2.farthest_point_sample is fps and "forward" not in vars(model.roi_head)
    phase_ms = out["phase_ms"]
    for key in ("backbone.sa_0.fps", "backbone.sa_1.ball_query", "backbone.fp_0.three_nn",
                "point_head", "proposal_layer.b1", "proposal_layer.keep_scan", "pool_rois",
                "roi_head.fps", "final_nms.b1", "final_nms.keep_scan", "recall_iou.b1"):
        assert phase_ms[key] > 0, key
    assert not any(k.startswith("step.") for k in phase_ms)
    fps_keys = [k for k in phase_ms if k.endswith(".fps")]
    assert sorted(fps_keys) == ["backbone.sa_0.fps", "backbone.sa_1.fps", "roi_head.fps"]
    assert 0 < out["fps_share"] < 1 and out["fps_ms"] > 0
    assert out["fps_iterations_per_step"] == sum(
        cfg["BACKBONE_3D"]["SA_CONFIG"]["NPOINTS"]) + sum(
        n for n in cfg["ROI_HEAD"]["SA_CONFIG"]["NPOINTS"] if n > 0)
    assert [c["shape"] for c in out["keep_scan"]] == [[2, 128, 128], [2, 16, 16]] * 2
    assert all(c["iterations"] >= 1 and c["ms"] > 0 for c in out["keep_scan"])


def test_tools_test_serves_the_pointrcnn_config(tmp_path, monkeypatch):
    """tools.test --cfg_file cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml
    on a synthetic root laid out as the config expects, in fp32 on the CPU:
    an AP dict of the 8 classes and 3 overlap calls (proposal NMS, final
    NMS, recall) per eval batch. Cut to the CPU by --set: SA npoints
    256/64/32/16 (published 4096/1024/256/64) and proposal NMS pre 256
    (published 4096); the widths stay published, the frames carry
    800-1200 points that sample_points takes to 16,384."""
    work = tmp_path
    (work / "cfgs").symlink_to(Path(__file__).resolve().parents[1] / "tools" / "cfgs")
    cfg = yaml.safe_load(POINTRCNN_CFG.read_text())
    classes = cfg["CLASS_NAMES"]
    root = work / "train_28130"
    kitti_synthetic.write_root(root, 0, 2, classes, seed=2, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    cfg_file = "cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml"
    monkeypatch.chdir(work)
    (info,) = create_infos.main(["--cfg_file", cfg_file, "--data_path", str(root),
                                 "--splits", "val", "--no_gt_database"])["infos"]
    (work / "val_6019").mkdir()
    info.rename(work / "val_6019" / "nuscenes2kitti_infos_val_6019.pkl")

    _, _, model = pointrcnn(device="cpu")
    seeded_weights_(model, seed=0)
    ckpt = work / "pointrcnn_seeded.pth"
    torch.save({"model_state": model.state_dict(), "epoch": 0}, ckpt)
    calls = []
    plain = iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev",
                        lambda a, b: calls.append(tuple(a.shape[:2])) or plain(a, b))
    ((epoch, result_dir, res),) = test_cli.main([
        "--cfg_file", cfg_file, "--ckpt", str(ckpt), "--batch_size", "2", "--workers", "1",
        "--device", "cpu", "--dtype", "float32", "--save_to_file",
        "--set", "DATA_CONFIG.DATA_PATH", str(root),
        "MODEL.BACKBONE_3D.SA_CONFIG.NPOINTS", "[256,64,32,16]",
        "MODEL.ROI_HEAD.NMS_PRE_MAXSIZE", "256"])
    assert epoch == 0 and res["num_frames"] == 2 and res["eval_batches"] == 1
    assert calls == [(2, 256), (2, 128), (2, 128)]
    assert len(list((result_dir / "final_result" / "data").glob("*.txt"))) == 2
    log = next((work / "output").rglob("log_eval_*.txt")).read_text()
    ap = json.loads(log.split("AP_DICT ", 1)[1].splitlines()[0])
    assert all(f"{c}_3d/moderate_R40" in ap for c in classes) and len(classes) == 8

