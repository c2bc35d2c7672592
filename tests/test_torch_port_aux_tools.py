"""Port parity: the auxiliary tools against the JAX package's, on the CPU:

* `utils.profiling`: StepTimer's EMA and summary text equal to JAX's under
  one patched clock; `trace` + `annotate` write a Chrome trace that names
  the span;
* `tools.visual_utils`: gradient_point_colors, get_coor_colors and
  calculate_iou equal to tools/visual_utils.py's, and draw_scenes (mpl) and
  the demo's draw_bev write the same decoded pixels as JAX's for the same
  inputs;
* `tools.demo`: predict_files on two .bin files equals the port's eval step
  on the same padded batches (one B1 call per file: the NMS), and the CLI
  predicts and renders with a saved checkpoint;
* `tools.create_integrated_database`: create_integrated_db + verify give
  the arrays and offsets of the JAX package's tool on a KITTI gt database
  written by the port;
* `tools.waymo_extract`: process_single_sequence writes the JAX tool's
  files from the same decoded frames, the port's WaymoDataset reads them,
  and decode_tfrecord raises the JAX tool's clear error without
  waymo-open-dataset;
* `eval.waymo_official`: _flatten equals JAX's on
  tests/test_extra_datasets.py's annos and on detections, and
  WaymoDataset.waymo_official_eval runs the in-process metric where the
  package imports (stubbed here) and dumps the pickles and the command
  where it does not.
"""
import pickle
import sys
import time
from pathlib import Path

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from dfu3d_tpu.eval import waymo_official as jwo
from dfu3d_tpu.utils import profiling as jprof
from dfu3d_tpu_torch.core.geometry import iou_kernel
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data import waymo_dataset as pwa
from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset, create_kitti_infos
from dfu3d_tpu_torch.eval import waymo_official as pwo
from dfu3d_tpu_torch.tools import create_integrated_database as pcid
from dfu3d_tpu_torch.tools import demo as pdemo
from dfu3d_tpu_torch.tools import e2e_synthetic
from dfu3d_tpu_torch.tools import visual_utils as pvu
from dfu3d_tpu_torch.tools import waymo_extract as pwe
from dfu3d_tpu_torch.tools.common import build_model
from dfu3d_tpu_torch.train.train_state import make_eval_step
from dfu3d_tpu_torch.utils import profiling
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_e2e import _dataset_cfg
from test_torch_port_data import assert_tree_equal
from test_torch_port_datasets import WAYMO_CFG, shipped
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_waymo_extract import _decoded_frame

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))
sys.path.insert(0, str(TOOLS / "process_tools"))
import create_integrated_database as jcid  # noqa: E402
import demo as jdemo  # noqa: E402
import visual_utils as jvu  # noqa: E402
import waymo_extract as jwe  # noqa: E402

CLASSES = ["Car", "Pedestrian", "Cyclist"]


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.010, 0.035, 0.040, 0.100, 0.1125, 0.2])
    ticks = [("load", "step", "load", "step", "step")]
    now = {"t": 0.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])
    timers = [profiling.StepTimer(momentum=0.8), jprof.StepTimer(momentum=0.8)]
    next(clock)
    for name, t_next in zip(ticks[0], clock):
        now["t"] = t_next
        dts = [tm.tick(name) for tm in timers]
        assert dts[0] == dts[1]
    assert timers[0].avg == timers[1].avg and len(timers[0].avg) == 2
    assert timers[0].summary() == timers[1].summary()
    now["t"] = 5.0
    timers[0].reset()
    now["t"] = 5.25
    assert timers[0].tick("load") == 0.25


def test_trace_names_the_span(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("column_request"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof.trace_path.parent == tmp_path / "trace"
    text = prof.trace_path.read_text()
    assert "column_request" in text and "aten::matmul" in text


def scene(seed=0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-30, 30, (3000, 2)), rng.uniform(-2, 2, (3000, 1)),
                          rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 20, (5, 2)), rng.uniform(-1, 0, (5, 1)),
                            rng.uniform(1, 4, (5, 3)), rng.uniform(-3, 3, (5, 1))],
                           axis=1).astype(np.float32)
    gt = boxes + np.float32([0.3, -0.2, 0, 0, 0, 0, 0.1])
    return pts, boxes, gt, rng.uniform(0.2, 1, 5).astype(np.float32), np.int64([1, 2, 3, 1, 2])


def test_visual_helpers_match_jax():
    pts, boxes, gt, _, _ = scene()
    np.testing.assert_array_equal(pvu.gradient_point_colors(pts), jvu.gradient_point_colors(pts))
    labels = np.random.RandomState(1).randint(0, 9, 50)
    np.testing.assert_array_equal(pvu.get_coor_colors(labels), jvu.get_coor_colors(labels))
    np.testing.assert_array_equal(pvu.calculate_iou(boxes, gt), jvu.calculate_iou(boxes, gt))
    assert pvu.calculate_iou(boxes, gt).min() > 0.3
    assert pvu.calculate_iou(boxes, gt[:0]).shape == (5,)


@pytest.mark.parametrize("view", ["3d", "bev"])
def test_renderings_match_jax(tmp_path, view):
    """The same inputs give the same PNG pixels through both packages."""
    pts, boxes, gt, scores, labels = scene()
    pngs = []
    for side, mod in (("port", pvu if view == "3d" else pdemo),
                      ("jax", jvu if view == "3d" else jdemo)):
        out = tmp_path / side
        out.mkdir()
        png = out / "frame.png"
        if view == "3d":
            mod.draw_scenes(pts, gt_boxes=gt, ref_boxes=boxes, ref_labels=labels,
                            ref_scores=scores, class_names=CLASSES, out_png=str(png),
                            backend="mpl")
        else:
            mod.draw_bev(pts, boxes, scores, labels, CLASSES, png, xlim=(-30, 30),
                         ylim=(-30, 30))
        pngs.append(mpimg.imread(png))
    assert pngs[0].shape == pngs[1].shape and pngs[0].shape[0] > 500
    np.testing.assert_array_equal(pngs[0], pngs[1])


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    """The synthetic run's pillar CenterPoint config, a model built from it
    with seeded weights saved as a checkpoint, and two .bin frames."""
    work = tmp_path_factory.mktemp("demo")
    cfg_file = e2e_synthetic.build_cfg(work / "data", work, model="pillar")
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    torch.manual_seed(0)
    model = build_model(cfg, "test", "cpu")
    with torch.no_grad():
        head = model.dense_head
        for name, p in head.named_parameters():
            if name.endswith("bias") and "hm" in name:
                p.fill_(1.0)   # every cell a peak: the NMS keeps real sets
    ckpt = work / "ckpt.pth"
    torch.save({"model_state": model.state_dict(), "epoch": 3, "it": 0,
                "optimizer_state": {}, "version": "test"}, ckpt)
    bins = work / "bins"
    bins.mkdir()
    for i in range(2):
        rng = np.random.RandomState(10 + i)
        pts = np.concatenate([rng.uniform(0, 50, (4000, 1)), rng.uniform(-25, 25, (4000, 1)),
                              rng.uniform(-2, 1, (4000, 1)), rng.uniform(0, 1, (4000, 1))],
                             axis=1).astype(np.float32)
        pts.tofile(bins / f"{i:06d}.bin")
    return cfg_file, cfg, model, ckpt, bins


def test_demo_predict_files_matches_the_eval_step(demo_setup, monkeypatch):
    _, cfg, model, _, bins = demo_setup
    files = sorted(bins.glob("*.bin"))
    calls = []
    overlap = iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev", lambda *a: calls.append(1) or overlap(*a))
    n_max, m_max = cfg.DATA_CONFIG.MAX_POINTS_PER_FRAME, cfg.DATA_CONFIG.MAX_GT_PER_FRAME
    preds = pdemo.predict_files(model, files, n_max, m_max, device="cpu")
    assert len(calls) == len(files)   # one B1 call per file: the NMS (no recall)
    step = make_eval_step(model, device="cpu")
    for f, (pts, boxes, scores, labels) in zip(files, preds):
        raw = np.fromfile(f, dtype=np.float32).reshape(-1, 4)
        np.testing.assert_array_equal(pts, raw)
        batch = pdemo.batch_of(raw, n_max, m_max)
        assert batch.points.shape == (1, n_max, 4) and int(batch.points_valid.sum()) == len(raw)
        wb, ws, wl, wv = (x[0] for x in step(batch))
        assert len(boxes) == int(wv.sum()) > 0
        np.testing.assert_array_equal(boxes, wb[wv].numpy())
        np.testing.assert_array_equal(scores, ws[wv].numpy())
        np.testing.assert_array_equal(labels, wl[wv].numpy())


def test_demo_cli_predicts_and_renders(demo_setup, tmp_path):
    cfg_file, cfg, model, ckpt, bins = demo_setup
    preds, written = pdemo.main(["--cfg_file", str(cfg_file), "--ckpt", str(ckpt),
                                 "--data_path", str(bins), "--out_dir", str(tmp_path / "out"),
                                 "--device", "cpu", "--dtype", "float32"])
    assert [p.name for p in written] == ["000000.png", "000001.png"]
    assert all(mpimg.imread(p).shape[0] > 500 for p in written)
    want = pdemo.predict_files(model, sorted(bins.glob("*.bin")),
                               cfg.DATA_CONFIG.MAX_POINTS_PER_FRAME,
                               cfg.DATA_CONFIG.MAX_GT_PER_FRAME, device="cpu")
    for got, exp in zip(preds, want):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)


def test_integrated_database_matches_jax(tmp_path):
    root = tmp_path / "kitti"
    kitti_synthetic.write_root(root, 4, 1, CLASSES[:2], seed=3, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    cfg = CfgDict(_dataset_cfg(root))
    create_kitti_infos(cfg, CLASSES[:2], root, root)
    KittiDataset(cfg, CLASSES[:2], training=False, root_path=root).create_groundtruth_database(
        root / "kitti_infos_train.pkl", root, used_classes=CLASSES[:2])
    outs = []
    for side, mod in (("port", pcid), ("jax", jcid)):
        d = tmp_path / side
        d.mkdir()
        db = d / "kitti_dbinfos_train.pkl"
        db.write_bytes((root / "kitti_dbinfos_train.pkl").read_bytes())
        npy, pkl = mod.create_integrated_db(db, root)
        assert mod.verify(db, root, npy, pkl)
        outs.append((np.load(npy), pickle.loads(pkl.read_bytes())))
    (pa, pi), (ja, ji) = outs
    np.testing.assert_array_equal(pa, ja)
    assert_tree_equal(pi, ji)
    offsets = [i["global_data_offset"] for infos in pi.values() for i in infos]
    assert len(offsets) >= 8 and offsets[-1][1] == len(pa)
    # a corrupted clip fails the check
    pa[offsets[0][0]] += 1.0
    np.save(tmp_path / "port" / "kitti_dbinfos_train_global.npy", pa)
    with pytest.raises(AssertionError):
        pcid.verify(tmp_path / "port" / "kitti_dbinfos_train.pkl", root,
                    tmp_path / "port" / "kitti_dbinfos_train_global.npy",
                    tmp_path / "port" / "kitti_dbinfos_train_global.pkl", num_checks=1000)


def test_waymo_layout_matches_jax_and_reads(tmp_path, monkeypatch):
    names, data = shipped(WAYMO_CFG)
    frames = [_decoded_frame("seq_a", i, rot=0.3 * i) for i in range(4)]
    written = {}
    for side, mod in (("port", pwe), ("jax", jwe)):
        tag = tmp_path / side / data["PROCESSED_DATA_TAG"]
        infos = mod.process_single_sequence(iter(frames), tag, sampled_interval=2)
        written[side] = (infos, sorted(p.relative_to(tag) for p in tag.rglob("*")), tag)
    (pinfos, pfiles, ptag), (jinfos, jfiles, jtag) = written["port"], written["jax"]
    assert pfiles == jfiles and len(pinfos) == 2
    assert_tree_equal(pinfos, jinfos)
    for f in pfiles:
        if f.suffix == ".npy":
            np.testing.assert_array_equal(np.load(ptag / f), np.load(jtag / f))
        elif f.suffix == ".pkl":
            assert_tree_equal(pickle.loads((ptag / f).read_bytes()),
                              pickle.loads((jtag / f).read_bytes()))
    root = tmp_path / "port"
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / f"{data['DATA_SPLIT']['test']}.txt").write_text("seq_a\n")
    ds = pwa.WaymoDataset(CfgDict(data), names, training=False, root_path=root)
    assert [i["point_cloud"]["sample_idx"] for i in ds.infos] == [0, 2]
    raw = frames[2]["points"]
    np.testing.assert_array_equal(ds.get_lidar("seq_a", 2), raw[raw[:, 5] == -1][:, :5])
    item = ds[1]
    assert item["points"].shape[1] == 5 and len(item["gt_boxes"]) >= 1
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # as on a machine without it
    with pytest.raises(ImportError, match="waymo-open-dataset"):
        next(pwe.decode_tfrecord(tmp_path / "x.tfrecord"))


WAYMO_GT = [{
    "name": np.array(["Vehicle", "Pedestrian", "Cyclist", "Vehicle", "Sign", "unknown"]),
    "gt_boxes_lidar": np.tile(np.array([[0, 0, 0, 4, 2, 1.5, 4.0]], np.float32), (6, 1)),
    "num_points_in_gt": np.array([10, 3, 0, 7, 9, 5]),
    "difficulty": np.array([0, 0, 0, 2, 0, 0]),
}]


def test_waymo_metric_marshalling_matches_jax():
    classes = ["Vehicle", "Pedestrian", "Cyclist"]
    det = [{"name": np.array(["Vehicle", "Cyclist"]), "score": np.float32([0.9, 0.4]),
            "boxes_lidar": np.float32([[1, 2, 0, 4, 2, 1.5, 7.0], [3, 1, 0, 1, 1, 2, -4.0]])},
           {"name": np.array([], dtype="<U32"), "score": np.zeros(0, np.float32),
            "boxes_lidar": np.zeros((0, 7), np.float32)}]
    for annos, is_gt in ((WAYMO_GT, True), (det, False)):
        got = pwo._flatten(annos, classes, is_gt=is_gt)
        want = jwo._flatten(annos, classes, is_gt=is_gt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    fid, boxes, types, _, diffs = pwo._flatten(WAYMO_GT, classes, is_gt=True)
    assert list(types) == [1, 2, 1] and list(diffs) == [1, 2, 2]
    assert np.all(np.abs(boxes[:, 6]) <= np.pi)
    assert pwo._wrap_heading(np.float64(3 * np.pi / 2)) == jwo._wrap_heading(3 * np.pi / 2)


def test_waymo_official_eval_in_process_and_dumped(tmp_path, monkeypatch):
    ds = pwa.WaymoDataset.__new__(pwa.WaymoDataset)
    ds.infos = [{"annos": WAYMO_GT[0]}]
    det = [{"name": np.array(["Vehicle"]), "score": np.float32([0.9]),
            "boxes_lidar": np.float32([[0, 0, 0, 4, 2, 1.5, 4.0]])}]
    text, ret = ds.waymo_official_eval(det, ["Vehicle"], tmp_path)
    assert "command" in ret and "waymo_eval" in ret["command"]
    assert pickle.loads(Path(ret["gt_annos"]).read_bytes())[0]["name"][0] == "Vehicle"
    # where the package imports, the metric runs in process
    for mod in ("waymo_open_dataset", "waymo_open_dataset.metrics",
                "waymo_open_dataset.metrics.python",
                "waymo_open_dataset.metrics.python.detection_metrics"):
        monkeypatch.setitem(sys.modules, mod, type(sys)(mod))
    sys.modules["waymo_open_dataset.metrics.python"].detection_metrics = \
        sys.modules["waymo_open_dataset.metrics.python.detection_metrics"]
    seen, ap = [], {"OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP": 0.5}
    monkeypatch.setattr(pwo, "waymo_detection_metrics",
                        lambda d, g, c: seen.append((d, g, c)) or ap)
    text, ret = ds.waymo_official_eval(det, ["Vehicle"], tmp_path)
    assert ret == ap and text == "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP: 0.5000"
    assert seen[0][0] is det and seen[0][1][0] is WAYMO_GT[0] and seen[0][2] == ["Vehicle"]
