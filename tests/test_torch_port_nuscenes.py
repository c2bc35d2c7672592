"""Port parity: NuScenesDataset and create_nuscenes_infos against the JAX
package on the JAX tests' own raw-table fixtures (`nusc_root`, one key
frame; `nusc_root_velo`, with prev/next annotations) and on a
`data.nuscenes_synthetic` tree with 9 sweeps before each key frame:

* infos equal: tokens, paths, lidar2global and sweep transforms within
  1e-6, time lags, 9-column gt (velocity included) within 1e-5, names;
* `__getitem__` in test mode with MAX_SWEEPS 10: equal points (5 features,
  the time lag last) and equal gt;
* `_balanced_resample`: equal picks from the same RandomState (JAX draws
  from numpy's global one, seeded the same);
* `write_nuscenes_results_json`: equal JSON; `evaluation()`: equal APs;
* the synthetic tree: what it wrote (9 sweeps per key frame, every class,
  finite velocities) is what the infos read.

The JAX dataset compares the infos' KITTI-style names (Car, ...) with the
config's class names as they are, so the cbgs configs' detection names
(car, ...) keep no gt there; the port translates them
(`test_detection_class_names`)."""
import json

import numpy as np
import pytest

from dfu3d_tpu.data import nuscenes_dataset as jnd
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.data import nuscenes_dataset as pnd
from dfu3d_tpu_torch.data import nuscenes_synthetic
from dfu3d_tpu_torch.data.dataset import BatchMeta
from dfu3d_tpu_torch.utils.config import CfgDict

from test_nuscenes2kitti import nusc_root  # noqa: F401
from test_nuscenes_dataset import _cfg, nusc_root_velo  # noqa: F401

CLASSES = ["Car", "Truck", "Construction_vehicle", "Bus", "Trailer", "Barrier", "Motorcycle",
           "Bicycle", "Pedestrian", "Traffic_cone"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """4 train + 2 val key frames in scenes of 2, 3,000 points per sweep."""
    root = tmp_path_factory.mktemp("nusc_synth")
    written = nuscenes_synthetic.write_root(root, n_train=4, n_val=2, frames_per_scene=2,
                                            points_per_sweep=3000, seed=3)
    paths = nuscenes_synthetic.write_infos(root, written, max_sweeps=10)
    return root, written, paths


def _infos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["token"] == w["token"] and g["lidar_path"] == w["lidar_path"]
        np.testing.assert_allclose(g["lidar2global"], w["lidar2global"], rtol=0, atol=1e-6)
        assert g["gt_boxes"].shape == w["gt_boxes"].shape and g["gt_boxes"].shape[1] == 9
        np.testing.assert_allclose(g["gt_boxes"], w["gt_boxes"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g["gt_names"], w["gt_names"])
        np.testing.assert_array_equal(g["num_lidar_pts"], w["num_lidar_pts"])
        assert len(g["sweeps"]) == len(w["sweeps"])
        for gs, ws in zip(g["sweeps"], w["sweeps"]):
            assert gs["lidar_path"] == ws["lidar_path"] and gs["time_lag"] == ws["time_lag"]
            np.testing.assert_allclose(gs["transform"], ws["transform"], rtol=0, atol=1e-6)


def test_infos_of_the_jax_fixtures(nusc_root_velo):  # noqa: F811
    for sweeps in (1, 3):
        want = jnd.create_nuscenes_infos(nusc_root_velo, "v1.0-mini", max_sweeps=sweeps)
        got = pnd.create_nuscenes_infos(nusc_root_velo, "v1.0-mini", max_sweeps=sweeps)
        _infos_equal(got, want)
    assert np.isfinite(got[0]["gt_boxes"][0, 7:9]).all()


def test_infos_of_the_one_frame_fixture(nusc_root):  # noqa: F811
    got = pnd.create_nuscenes_infos(nusc_root, "v1.0-mini", max_sweeps=10,
                                    save_path=nusc_root / "nuscenes_infos.pkl")
    _infos_equal(got, jnd.create_nuscenes_infos(nusc_root, "v1.0-mini", max_sweeps=10))
    assert np.isnan(got[0]["gt_boxes"][0, 7:9]).all()  # an isolated annotation
    cfg = _cfg(nusc_root)
    ds, jds = (pnd.NuScenesDataset(CfgDict(cfg), ["Car"], training=False, root_path=nusc_root),
               jnd.NuScenesDataset(cfg, ["Car"], training=False, root_path=nusc_root))
    g, w = ds[0], jds[0]
    np.testing.assert_array_equal(g["points"], w["points"])
    np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
    assert g["gt_boxes"].shape[1] == 10 and not g["gt_boxes"][:, 7:9].any()


def test_synthetic_tree_infos(synth):
    root, written, paths = synth
    want = jnd.create_nuscenes_infos(root, written["version"], max_sweeps=10)
    got = pnd.create_nuscenes_infos(root, written["version"], max_sweeps=10)
    _infos_equal(got, want)
    assert [i["token"] for i in got] == written["train"] + written["val"]
    assert all(len(i["sweeps"]) == 9 for i in got)
    lags = [s["time_lag"] for s in got[0]["sweeps"]]
    np.testing.assert_allclose(lags, np.arange(1, 10) * 0.05, atol=1e-9)
    for split in ("train", "val"):
        import pickle

        infos = pickle.loads(paths[split].read_bytes())
        assert [i["token"] for i in infos] == written[split]
        assert sum(len(i["gt_boxes"]) for i in infos) == written["gt"][split]
    names = {n for i in got for n in i["gt_names"]}
    assert names == set(CLASSES)
    assert all(np.isfinite(i["gt_boxes"]).all() for i in got)  # prev/next on every track
    assert all(20 <= len(i["gt_boxes"]) <= 40 for i in got)


def _dataset_cfg(root, info_file, sweeps=10):
    cfg = _cfg(root)
    cfg["MAX_SWEEPS"] = sweeps
    cfg["POINT_CLOUD_RANGE"] = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
    cfg["MAX_POINTS_PER_FRAME"] = 65536
    cfg["INFO_PATH"] = {"train": [info_file], "test": [info_file]}
    feats = ["x", "y", "z", "intensity", "timestamp"]
    cfg["POINT_FEATURE_ENCODING"] = {"encoding_type": "absolute_coordinates_encoding",
                                     "used_feature_list": feats, "src_feature_list": feats}
    return cfg


def test_getitem_with_sweeps(synth):
    root, written, paths = synth
    cfg = _dataset_cfg(root, paths["val"].name)
    ds = pnd.NuScenesDataset(CfgDict(cfg), CLASSES, training=False, root_path=root)
    jds = jnd.NuScenesDataset(JCfgDict(cfg), CLASSES, training=False, root_path=root)
    assert len(ds) == len(jds) == 2 and ds.gt_box_width == jds.gt_box_width == 9
    for i in range(len(ds)):
        g, w = ds[i], jds[i]
        assert g["frame_id"] == w["frame_id"]
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
        assert g["points"].shape[1] == 5 and len(g["points"]) > 9 * 2000
        lags = np.unique(g["points"][:, 4])
        np.testing.assert_allclose(lags, np.arange(10) * 0.05, atol=1e-6)
    batch, meta = ds.collate_batch([ds[0], ds[1]])
    jbatch, _ = jds.collate_batch([jds[0], jds[1]])
    for a, b in zip(batch, jbatch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_balanced_resample(synth):
    root, _, paths = synth
    cfg = _dataset_cfg(root, paths["train"].name)
    ds = pnd.NuScenesDataset(CfgDict(cfg), CLASSES, training=False, root_path=root)
    jds = jnd.NuScenesDataset(JCfgDict(cfg), CLASSES, training=False, root_path=root)
    # drop the buses from two frames, so that the classes differ in frequency
    for infos in (ds.infos, jds.infos):
        for info in infos[:2]:
            keep = info["gt_names"] != "Bus"
            info["gt_names"], info["gt_boxes"] = info["gt_names"][keep], info["gt_boxes"][keep]
    for seed in (0, 5):
        np.random.seed(seed)
        want = jds._balanced_resample(jds.infos)
        got = ds._balanced_resample(ds.infos, np.random.RandomState(seed))
        assert [i["token"] for i in got] == [i["token"] for i in want]
        assert len(got) > len(ds.infos)


def test_detection_class_names(synth):
    """The cbgs configs name the detection classes (car, ...): the port reads
    the infos' KITTI-style gt under those names and evaluates them in KITTI
    style; the JAX dataset keeps none of them. (With a handful of gt per
    class KITTI AP stays low even for gt fed back as predictions: the
    41-point recall table has few thresholds to fill.)"""
    root, _, paths = synth
    names = list(pnd.DEFAULT_MAP)
    cfg = _dataset_cfg(root, paths["val"].name)
    ds = pnd.NuScenesDataset(CfgDict(cfg), names, training=False, root_path=root)
    jds = jnd.NuScenesDataset(JCfgDict(cfg), names, training=False, root_path=root)
    assert len(jds[0]["gt_boxes"]) == 0
    item = ds[0]
    assert len(item["gt_boxes"]) == len(ds.infos[0]["gt_boxes"])
    np.testing.assert_array_equal(
        item["gt_boxes"][:, -1],
        [names.index(pnd.KITTI_TO_DETECTION[n]) + 1 for n in ds.infos[0]["gt_names"]])
    train = pnd.NuScenesDataset(CfgDict({**cfg, "BALANCED_RESAMPLING": True}), names,
                                training=False, root_path=root)
    assert len(train.infos) == 2  # test mode: no resampling
    # the same predictions under either naming give the same APs
    kitti = pnd.NuScenesDataset(CfgDict(cfg), CLASSES, training=False, root_path=root)
    meta = BatchMeta([i["token"] for i in ds.infos], [None] * 2, [None] * 2)
    preds = _gt_predictions(ds, jitter=0.3, seed=2)
    _, ap = ds.evaluation(ds.generate_prediction_dicts(meta, preds, names), names)
    _, kap = kitti.evaluation(kitti.generate_prediction_dicts(meta, preds, CLASSES), CLASSES)
    assert ap == kap and {k.split("/")[0].rsplit("_", 1)[0] for k in ap if "/" in k} == set(CLASSES)


def _gt_predictions(ds, jitter=0.0, seed=0):
    rng = np.random.RandomState(seed)
    preds = []
    for info in ds.infos:
        boxes = info["gt_boxes"].copy()
        boxes[:, :3] += rng.normal(0, jitter, boxes[:, :3].shape)
        labels = np.array([ds.class_names.index(ds._cfg_names([n])[0]) + 1
                           for n in info["gt_names"]])
        preds.append({"pred_boxes": boxes, "pred_scores": rng.uniform(0.2, 1, len(boxes)),
                      "pred_labels": labels})
    return preds


def test_results_json_and_evaluation(synth, tmp_path):
    root, _, paths = synth
    cfg = _dataset_cfg(root, paths["val"].name)
    ds = pnd.NuScenesDataset(CfgDict(cfg), CLASSES, training=False, root_path=root)
    jds = jnd.NuScenesDataset(JCfgDict(cfg), CLASSES, training=False, root_path=root)
    meta = BatchMeta([i["token"] for i in ds.infos], [None] * 2, [None] * 2)
    preds = _gt_predictions(ds, jitter=0.3, seed=1)
    annos = ds.generate_prediction_dicts(meta, preds, CLASSES)
    jannos = jds.generate_prediction_dicts(meta, preds, CLASSES)
    for a, b in zip(annos, jannos):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = json.loads(ds.write_nuscenes_results_json(annos, tmp_path / "p.json").read_text())
    want = json.loads(jds.write_nuscenes_results_json(jannos, tmp_path / "j.json").read_text())
    assert got == want and sum(len(v) for v in got["results"].values()) == sum(
        len(p["pred_boxes"]) for p in preds)
    _, ap = ds.evaluation(annos, CLASSES)
    _, jap = jds.evaluation(jannos, CLASSES)
    assert set(ap) == set(jap)
    for k in jap:
        assert ap[k] == pytest.approx(jap[k], abs=1e-9), k
    assert 0 < ap["Car_bev/moderate_R40"] < 100
