"""Port parity for the other lidar datasets (Waymo's extracted layout, ONCE
with its evaluator, Lyft, Custom, Pandaset, Argoverse 2) and the dataset
registry: each port dataset against the JAX package's on the same seeded
root (`data.lidar_synthetic`), on its shipped dataset config at a small
range: infos, len per mode, items, the collated batch, ONCE's gt database
and dbinfos, and `evaluation`. Exact unless a test states a tolerance.

Where the port departs from the JAX package on purpose, a test here pins
the difference (ROADMAP Queue C): Waymo's elongation column, the Lyft
configs' lower-case class names and the Lyft metric's 7 box columns, and
ONCE reading INFO_PATH by mode. Also pinned, as both packages do it: a
multi-frame Waymo config reads one frame, DISABLE_NLZ_FLAG_ON_POINTS is not
read, and the converted-layout Argo2Dataset is shadowed in the registry."""
import copy
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from dfu3d_tpu.data import __all_datasets__ as j_registry
from dfu3d_tpu.data import argo2_dataset as ja2
from dfu3d_tpu.data import custom_dataset as jcu
from dfu3d_tpu.data import lyft_dataset as jly
from dfu3d_tpu.data import once_dataset as jon
from dfu3d_tpu.data import pandaset_dataset as jpa
from dfu3d_tpu.data import waymo_dataset as jwa
from dfu3d_tpu.data.dataset import BatchMeta as JBatchMeta
from dfu3d_tpu.eval import once_eval as j_once_eval
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.data import argo2_dataset as pa2
from dfu3d_tpu_torch.data import custom_dataset as pcu
from dfu3d_tpu_torch.data import lidar_synthetic as ls
from dfu3d_tpu_torch.data import lyft_dataset as ply
from dfu3d_tpu_torch.data import once_dataset as pon
from dfu3d_tpu_torch.data import pandaset_dataset as ppa
from dfu3d_tpu_torch.data import waymo_dataset as pwa
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.data.dataset import BatchMeta
from dfu3d_tpu_torch.data.loader import __all_datasets__ as p_registry
from dfu3d_tpu_torch.data.loader import build_dataloader
from dfu3d_tpu_torch.eval import once_eval as p_once_eval
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_data import assert_tree_equal

CFGS = Path(__file__).resolve().parents[1] / "tools" / "cfgs"
SMALL = 25.6   # m, the tests' half range in x and y


def shipped(cfg_file, **overrides):
    """(class names, DATA_CONFIG as a plain dict) of a shipped model config
    at the tests' small range and caps, with `overrides` on DATA_CONFIG."""
    cfg = cfg_from_yaml_file(CFGS / cfg_file, CfgDict())
    data = json.loads(json.dumps(cfg.DATA_CONFIG))
    z = data["POINT_CLOUD_RANGE"]
    data.update(POINT_CLOUD_RANGE=[-SMALL, -SMALL, z[2], SMALL, SMALL, z[5]],
                MAX_POINTS_PER_FRAME=4096, MAX_GT_PER_FRAME=64, **overrides)
    return list(cfg.CLASS_NAMES), data


def pair(port_cls, jax_cls, data, names, training, root, seed=7):
    """(port, JAX) datasets on one root, their augmentors (and gt samplers)
    drawing from one seeded RandomState per side."""
    out = []
    for cls, cfgd in ((port_cls, CfgDict), (jax_cls, JCfgDict)):
        ds = cls(cfgd(copy.deepcopy(data)), names, training=training, root_path=root)
        if ds.data_augmentor is not None:
            rng = np.random.RandomState(seed)
            ds.data_augmentor.rng = rng
            for aug in ds.data_augmentor.data_augmentor_queue:
                if hasattr(aug, "rng"):
                    aug.rng = rng
        out.append(ds)
    return out


def assert_items_and_batch_equal(port, jax_side, count=None):
    """Every item (the processor's shuffle from one global seed per side) and
    the collated batch of the first three equal."""
    frames = []
    for ds in (port, jax_side):
        np.random.seed(3)
        frames.append([ds[i] for i in range(count or len(ds))])
    for got, want in zip(*frames):
        assert_tree_equal(got, want)
    batch, meta = port.collate_batch(frames[0][:3])
    jbatch, jmeta = jax_side.collate_batch(frames[1][:3])
    assert isinstance(batch, PointBatch)
    for got, want in zip(batch, jbatch):
        np.testing.assert_array_equal(got.numpy(), want)
    assert meta.frame_ids == jmeta.frame_ids
    return frames[0], batch


def predictions(infos, boxes_of, names_of, class_names, seed, jitter=0.2, ties=True):
    """Per info: its gt jittered by `jitter` m as predictions, labels from the
    names, scores seeded (every other score repeated, so that ties occur)."""
    rng = np.random.RandomState(seed)
    out = []
    for info in infos:
        boxes = np.asarray(boxes_of(info), np.float64)[:, :7].copy()
        boxes[:, :2] += rng.normal(0, jitter, boxes[:, :2].shape)
        scores = rng.uniform(0.1, 1.0, len(boxes))
        if ties:
            scores[1::2] = scores[0:-1:2][:len(scores[1::2])]
        names = list(names_of(info))
        keep = np.array([n in class_names for n in names], bool)
        labels = np.array([class_names.index(n) + 1 for n in np.asarray(names)[keep]])
        out.append({"pred_boxes": boxes[keep], "pred_scores": scores[keep],
                    "pred_labels": labels.astype(np.int64)})
    return out


def evaluations(port, jax_side, preds, class_names, fids, **kw):
    n = len(fids)
    got = port.evaluation(port.generate_prediction_dicts(
        BatchMeta(fids, [None] * n, [None] * n), preds, class_names), class_names, **kw)
    want = jax_side.evaluation(jax_side.generate_prediction_dicts(
        JBatchMeta(fids, [None] * n, [None] * n), preds, class_names), class_names, **kw)
    return got, want


def test_registry_has_the_jax_names_and_the_shadowed_argo2():
    assert set(p_registry) == set(j_registry) and len(p_registry) == 10
    for name, cls in p_registry.items():
        assert cls.__name__ == j_registry[name].__name__ or name == "DatasetTemplate"
    # the registry's Argo2Dataset is argo2_dataset's; pandaset_dataset's own
    # converted-layout class of that name is importable and no name reaches it
    assert p_registry["Argo2Dataset"] is pa2.Argo2Dataset
    assert j_registry["Argo2Dataset"] is ja2.Argo2Dataset
    assert ppa.Argo2Dataset is not pa2.Argo2Dataset
    assert ppa.Argo2Dataset not in p_registry.values()
    assert jpa.Argo2Dataset not in j_registry.values()


# --- Waymo ---

WAYMO_CFG = "waymo_models/centerpoint.yaml"
FOUR = {"encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"]}


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    """10 + 3 frames of 3,000 points (6 columns, 5 % NLZ), one box of frame 0
    named 'unknown' and one 'Sign'."""
    root = tmp_path_factory.mktemp("waymo")
    _, data = shipped(WAYMO_CFG)
    seqs = ls.write_waymo_root(root, [10], [3], data["POINT_CLOUD_RANGE"], num_points=3000,
                               num_boxes=(6, 10), seed=1, tag=data["PROCESSED_DATA_TAG"])
    for seq in seqs["train"] + seqs["val"]:
        pkl = root / data["PROCESSED_DATA_TAG"] / seq / f"{seq}.pkl"
        infos = pickle.loads(pkl.read_bytes())
        infos[0]["annos"]["name"][:2] = ["unknown", "Sign"]
        pkl.write_bytes(pickle.dumps(infos))
    return root, seqs


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_waymo_items_match_jax(waymo_root, training):
    """On a four-feature encoding the port's items equal the JAX package's;
    SAMPLED_INTERVAL as shipped (train 5: 2 of 10 frames, test 1)."""
    root, _ = waymo_root
    names, data = shipped(WAYMO_CFG, POINT_FEATURE_ENCODING=FOUR)
    port, jax_side = pair(pwa.WaymoDataset, jwa.WaymoDataset, data, names, training, root)
    assert len(port) == len(jax_side) == (2 if training else 3)
    assert_tree_equal(port.infos, jax_side.infos)
    frames, batch = assert_items_and_batch_equal(port, jax_side)
    assert batch.points.shape[-1] == 4 and batch.gt_valid.any()
    # 'unknown' is dropped before the class filter, 'Sign' by it
    assert all(len(f["gt_boxes"]) <= len(i["annos"]["name"]) - 2 * (k == 0)
               for k, (f, i) in enumerate(zip(frames, port.infos)))
    port.merge_all_iters_to_one_epoch(epochs=3)
    jax_side.merge_all_iters_to_one_epoch(epochs=3)
    assert len(port) == len(jax_side) == 3 * len(port.infos)


def test_waymo_keeps_the_elongation_column(waymo_root):
    """The shipped encoding lists elongation: the JAX package hands it 4
    columns (`get_lidar` keeps [:, :4]), the port the layout's 5."""
    root, seqs = waymo_root
    names, data = shipped(WAYMO_CFG)
    port, jax_side = pair(pwa.WaymoDataset, jwa.WaymoDataset, data, names, False, root)
    raw = np.load(port.data_dir / seqs["val"][0] / "0000.npy")
    kept = raw[raw[:, 5] == -1]
    got = port.get_lidar(seqs["val"][0], 0)
    np.testing.assert_array_equal(got, kept[:, :5])
    np.testing.assert_array_equal(jax_side.get_lidar(seqs["val"][0], 0), kept[:, :4])
    assert port.num_point_features == jax_side.num_point_features == 5
    np.random.seed(0)
    item = port[0]
    np.random.seed(0)
    jitem = jax_side[0]
    assert item["points"].shape[1] == 5 and jitem["points"].shape[1] == 4
    # the fifth column is the file's elongation, row for row
    rows = {tuple(r[:3]): r[4] for r in kept}
    np.testing.assert_array_equal(item["points"][:, 4],
                                  [rows[tuple(r[:3])] for r in item["points"]])
    np.testing.assert_array_equal(item["points"][:, :4], jitem["points"])


def test_waymo_multiframe_config_reads_one_frame(waymo_root):
    """SEQUENCE_CONFIG is read by neither package: the 4-frame config gets
    one frame's points (5 columns here, 4 in the JAX package, for an
    encoding of 6)."""
    root, seqs = waymo_root
    names, data = shipped("waymo_models/centerpoint_4frames.yaml")
    assert data["SEQUENCE_CONFIG"]["ENABLED"] and data["SEQUENCE_CONFIG"]["SAMPLE_OFFSET"] == [-3, 0]
    port, jax_side = pair(pwa.WaymoDataset, jwa.WaymoDataset, data, names, False, root)
    assert port.num_point_features == 6
    raw = np.load(port.data_dir / seqs["val"][0] / "0001.npy")
    kept = raw[raw[:, 5] == -1][:, :5]
    pcr = np.asarray(data["POINT_CLOUD_RANGE"], np.float32)
    in_range = ((kept[:, :3] >= pcr[:3]) & (kept[:, :3] <= pcr[3:])).all(1)
    inside = in_range.sum()
    np.random.seed(0)
    item = port[1]
    np.random.seed(0)
    jitem = jax_side[1]
    assert item["points"].shape == (inside, 5) and jitem["points"].shape == (inside, 4)
    np.testing.assert_array_equal(np.sort(item["points"][:, 0]), np.sort(kept[in_range, 0]))


@pytest.mark.parametrize("disable_nlz", [True, False])
def test_waymo_nlz_filter(tmp_path, disable_nlz):
    """NLZ points go whenever a frame flags any (flag != -1 with a negative
    flag present); DISABLE_NLZ_FLAG_ON_POINTS changes nothing in either
    package; a frame without a negative flag keeps every point."""
    names, data = shipped(WAYMO_CFG, DISABLE_NLZ_FLAG_ON_POINTS=disable_nlz)
    seq_dir = tmp_path / data["PROCESSED_DATA_TAG"] / "s"
    seq_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    flagged = np.concatenate([rng.uniform(-5, 5, (50, 5)),
                              np.where(np.arange(50) % 5 == 0, 1.0, -1.0)[:, None]], axis=1)
    unflagged = flagged.copy()
    unflagged[:, 5] = 0.0
    np.save(seq_dir / "0000.npy", flagged.astype(np.float32))
    np.save(seq_dir / "0001.npy", unflagged.astype(np.float32))
    for cls in (pwa.WaymoDataset, jwa.WaymoDataset):
        ds = cls((CfgDict if cls is pwa.WaymoDataset else JCfgDict)(data), names,
                 training=False, root_path=tmp_path)
        assert len(ds.get_lidar("s", 0)) == 40 and len(ds.get_lidar("s", 1)) == 50
    np.testing.assert_array_equal(pwa.WaymoDataset(CfgDict(data), names, training=False,
                                                   root_path=tmp_path).get_lidar("s", 0),
                                  flagged[flagged[:, 5] == -1, :5].astype(np.float32))


def test_waymo_evaluation_and_official_dump_match_jax(waymo_root, tmp_path):
    root, _ = waymo_root
    names, data = shipped(WAYMO_CFG, POINT_FEATURE_ENCODING=FOUR)
    port, jax_side = pair(pwa.WaymoDataset, jwa.WaymoDataset, data, names, False, root)
    preds = predictions(port.infos, lambda i: i["annos"]["gt_boxes_lidar"],
                        lambda i: i["annos"]["name"], names, seed=4)
    fids = [i["frame_id"] for i in port.infos]
    (text, got), (jtext, want) = evaluations(port, jax_side, preds, names, fids)
    assert text == jtext and got == want
    assert {k.split("_")[0] for k in got} == {"Car", "Pedestrian", "Bicycle"}
    # EVAL_METRIC waymo: the pickles and the out-of-process command
    for ds in (port, jax_side):
        ds.dataset_cfg["EVAL_METRIC"] = "waymo"
    (_, got), (_, want) = evaluations(port, jax_side, preds, names, fids,
                                      output_path=str(tmp_path / "port"))
    _, jwant = evaluations(port, jax_side, preds, names, fids, output_path=str(tmp_path / "jax"))
    want = jwant[1]
    assert got["command"] == want["command"].replace("/jax/", "/port/")
    for key in ("det_annos", "gt_annos"):
        assert_tree_equal(pickle.loads(Path(got[key]).read_bytes()),
                          pickle.loads(Path(want[key]).read_bytes()))


# --- ONCE ---

ONCE_CFG = "once_models/centerpoint.yaml"


@pytest.fixture(scope="module")
def once_roots(tmp_path_factory):
    """One raw ONCE root of 6 + 3 frames; the JAX package's infos and gt
    database in it, the port's in a copy."""
    root = tmp_path_factory.mktemp("once")
    names, data = shipped(ONCE_CFG)
    ls.write_once_root(root, 6, 3, data["POINT_CLOUD_RANGE"], num_points=3000,
                       num_boxes=(8, 12), seed=2)
    port_root = tmp_path_factory.mktemp("once_port")
    shutil.rmtree(port_root)
    shutil.copytree(root, port_root)
    jon.create_once_infos(JCfgDict(data), names, root, root, splits=("train", "val"))
    pon.create_once_infos(CfgDict(data), names, port_root, port_root, splits=("train", "val"))
    jdb = jon.ONCEDataset(JCfgDict(data), names, training=False, root_path=root) \
        .create_groundtruth_database(root / "once_infos_train.pkl", used_classes=names)
    pdb = pon.ONCEDataset(CfgDict(data), names, training=False, root_path=port_root) \
        .create_groundtruth_database(port_root / "once_infos_train.pkl", used_classes=names)
    return root, port_root, jdb, pdb


def test_once_infos_and_gt_database_match_jax(once_roots):
    root, port_root, jdb, pdb = once_roots
    for split in ("train", "val"):
        got = pickle.loads((port_root / f"once_infos_{split}.pkl").read_bytes())
        want = pickle.loads((root / f"once_infos_{split}.pkl").read_bytes())
        for info in got:
            info["lidar"] = info["lidar"].replace(str(port_root), str(root))
        assert_tree_equal(got, want)
    assert pdb.name == jdb.name == "once_dbinfos_train.pkl"
    got, want = pickle.loads(pdb.read_bytes()), pickle.loads(jdb.read_bytes())
    assert_tree_equal(got, want)
    assert sum(len(v) for v in got.values()) > 20
    for infos in got.values():
        for info in infos:
            np.testing.assert_array_equal(np.fromfile(port_root / info["path"], np.float32),
                                          np.fromfile(root / info["path"], np.float32))


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_once_items_match_jax(once_roots, training):
    """Train mode with the shipped gt sampling and world augmentations;
    INFO_PATH is read by mode (test: once_infos_test.pkl, none written here,
    so the test mode reads the val infos through INFO_PATH.test)."""
    root, _, _, _ = once_roots
    names, data = shipped(ONCE_CFG)
    data["INFO_PATH"]["test"] = ["once_infos_val.pkl"]
    port, jax_side = pair(pon.ONCEDataset, jon.ONCEDataset, data, names, training, root)
    assert len(port) == len(jax_side) == (6 if training else 3)
    assert_tree_equal(port.once_infos, jax_side.once_infos)
    assert_items_and_batch_equal(port, jax_side)


def test_once_reads_info_path_by_mode(once_roots):
    """The shipped config's test mode reads INFO_PATH['test']
    (once_infos_test.pkl) although DATA_SPLIT['test'] is val, in both
    packages; the reference reads INFO_PATH[split]."""
    root, _, _, _ = once_roots
    names, data = shipped(ONCE_CFG)
    assert data["DATA_SPLIT"]["test"] == "val" and data["INFO_PATH"]["test"] == [
        "once_infos_test.pkl"]
    port, jax_side = pair(pon.ONCEDataset, jon.ONCEDataset, data, names, False, root)
    assert port.split == "val" and len(port) == len(jax_side) == 0


def test_once_evaluation_matches_jax(once_roots):
    root, _, _, _ = once_roots
    names, data = shipped(ONCE_CFG)
    data["INFO_PATH"]["test"] = ["once_infos_val.pkl"]
    port, jax_side = pair(pon.ONCEDataset, jon.ONCEDataset, data, names, False, root)
    preds = predictions(port.once_infos, lambda i: i["annos"]["boxes_3d"],
                        lambda i: i["annos"]["name"], names, seed=5, jitter=0.3)
    (text, got), (jtext, want) = evaluations(port, jax_side, preds, names,
                                             [i["frame_id"] for i in port.once_infos])
    assert text == jtext and got == want
    assert got["AP_Vehicle/overall"] > 0


def once_annos(seed, frames=4, ties=True):
    """Seeded ONCE gt and predictions: all five classes, every distance tier,
    headings flipped on a share of the predictions, tied scores."""
    rng = np.random.RandomState(seed)
    classes = ["Car", "Bus", "Truck", "Pedestrian", "Cyclist"]
    gts, preds = [], []
    for _ in range(frames):
        n = rng.randint(5, 15)
        boxes = np.zeros((n, 7))
        r, a = rng.uniform(5, 70, n), rng.uniform(-np.pi, np.pi, n)
        boxes[:, 0], boxes[:, 1] = r * np.cos(a), r * np.sin(a)
        boxes[:, 3:6] = rng.uniform(0.6, 5, (n, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        names = rng.choice(classes, n)
        gts.append({"name": names, "boxes_3d": boxes.astype(np.float32)})
        m = n + rng.randint(0, 6)
        pb = np.concatenate([boxes, boxes[rng.randint(0, n, m - n)]])
        pb[:, :3] += rng.normal(0, 0.25, (m, 3))
        pb[:, 6] += np.where(rng.uniform(size=m) < 0.15, np.pi, 0)
        scores = np.round(rng.uniform(0, 1, m), 1) if ties else rng.uniform(0, 1, m)
        preds.append({"name": np.concatenate([names, rng.choice(classes, m - n)]),
                      "boxes_3d": pb.astype(np.float32), "score": scores})
    return gts, preds


@pytest.mark.parametrize("mode,superclass", [("Overall&Distance", True), ("Distance", False),
                                             ("Overall", True)])
def test_once_eval_matches_jax_with_ties(mode, superclass):
    """get_evaluation_results on seeded annos whose scores tie (rounded to
    0.1): equal to 1e-12, its text equal."""
    gts, preds = once_annos(11)
    kw = dict(use_superclass=superclass, difficulty_mode=mode)
    text, got = p_once_eval.get_evaluation_results(gts, preds, ["Car", "Bus", "Truck",
                                                               "Pedestrian", "Cyclist"], **kw)
    jtext, want = j_once_eval.get_evaluation_results(gts, preds, ["Car", "Bus", "Truck",
                                                                 "Pedestrian", "Cyclist"], **kw)
    assert text == jtext and got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert max(got.values()) > 0
    b = np.array([[0, 0, 0, 4, 2, 1.5, 0.0]], np.float32)
    flipped = b.copy()
    flipped[0, 6] = np.pi * 0.9
    for w in (True, False):
        np.testing.assert_array_equal(p_once_eval.iou3d_with_heading(b, flipped, w),
                                      j_once_eval.iou3d_with_heading(b, flipped, w))


def test_once_eval_breaks_ties_as_jax():
    """Two ground-truth boxes 0.8 m apart and two predictions of one score
    (then of one IoU) that the first gt box could take: the first of the
    tied candidates is taken, which leaves the second gt box unmatched. The
    port's numpy form of the loops takes the same one as JAX's loops."""
    def box(x):
        return [x, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0]

    gt = [{"name": np.array(["Car", "Car"]), "boxes_3d": np.array([box(0), box(0.8)],
                                                                np.float32)}]
    for pred_x, scores in (([0.4, -0.3], [0.9, 0.9]),     # tied scores
                           ([0.4, -0.4], [0.9, 0.8])):    # tied IoUs with gt 0
        pred = [{"name": np.array(["Car", "Car"]),
                 "boxes_3d": np.array([box(x) for x in pred_x], np.float32),
                 "score": np.array(scores)}]
        kw = dict(difficulty_mode="Overall")
        _, got = p_once_eval.get_evaluation_results(gt, pred, ["Car"], **kw)
        _, want = j_once_eval.get_evaluation_results(gt, pred, ["Car"], **kw)
        assert got == want and 0 < got["AP_Vehicle/overall"] < 100, (pred_x, got)


# --- Lyft ---

LYFT_CFG = "lyft_models/cbgs_second_multihead.yaml"
LYFT_KITTI_NAMES = ["Car", "Truck", "Bus", "Motorcycle", "Bicycle", "Pedestrian"]


@pytest.fixture(scope="module")
def lyft_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lyft")
    ls.write_lyft_root(root, 2, 2, points_per_sweep=2000, num_boxes=(8, 12), seed=3)
    return root


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_lyft_items_match_jax(lyft_root, training):
    """On the infos' own (KITTI-style) class names both packages read the
    same items: 5 sweeps with time lags, 9-column gt."""
    _, data = shipped(LYFT_CFG, BALANCED_RESAMPLING=False)
    data["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    port, jax_side = pair(ply.LyftDataset, jly.LyftDataset, data, LYFT_KITTI_NAMES, training,
                          lyft_root)
    assert len(port) == len(jax_side) == 2
    frames, batch = assert_items_and_batch_equal(port, jax_side)
    assert batch.points.shape[-1] == 5 and batch.gt_boxes.shape[-1] == 10
    assert len(np.unique(frames[0]["points"][:, 4])) == 5


def test_lyft_config_names_and_metric(lyft_root):
    """The Lyft config names its classes in lower case: the port reads the
    infos' Car, Truck, ... under them (the JAX package keeps no gt), and
    its metric reads the boxes' first 7 columns (the JAX package's reshapes
    the 9-column gt to rows of 7 and raises)."""
    names, data = shipped(LYFT_CFG)
    port, jax_side = pair(ply.LyftDataset, jly.LyftDataset, data, names, False, lyft_root)
    np.random.seed(0)
    item = port[0]
    np.random.seed(0)
    assert len(jax_side[0]["gt_boxes"]) == 0
    info = port.infos[0]
    np.testing.assert_array_equal(item["gt_boxes"][:, -1],
                                  [names.index(n.lower()) + 1 for n in info["gt_names"]])
    preds = predictions(port.infos, lambda i: np.nan_to_num(i["gt_boxes"]),
                        lambda i: [n.lower() for n in i["gt_names"]], names, seed=6, jitter=0.0)
    fids = [i["token"] for i in port.infos]
    n = len(fids)
    annos = port.generate_prediction_dicts(BatchMeta(fids, [None] * n, [None] * n), preds, names)
    _, got = port.evaluation(annos, names)
    seen = {str(n).lower() for i in port.infos for n in i["gt_names"]}
    assert seen == set(ls.LYFT_CLASSES)
    for cls in names:
        assert got[f"AP_{cls}"] == (pytest.approx(1.0) if cls in seen else 0.0), cls
    with pytest.raises(ValueError, match="reshape"):
        jax_side.evaluation(jax_side.generate_prediction_dicts(
            JBatchMeta(fids, [None] * n, [None] * n), preds, names), names)
    # on 7-column annos the metric itself equals the JAX package's
    gt7 = [{"name": port._cfg_names(i["gt_names"]), "boxes_lidar": i["gt_boxes"][:, :7]}
           for i in port.infos]
    det7 = [{**a, "boxes_lidar": a["boxes_lidar"][:, :7]} for a in annos]
    np.testing.assert_array_equal(ply.lyft_average_precisions(gt7, det7, names),
                                  jly.lyft_average_precisions(gt7, det7, names))


def test_lyft_average_precisions_match_jax_with_ties():
    """Seeded annos with tied scores and overlapping detections: equal to 1e-12."""
    rng = np.random.RandomState(8)
    gts, dets = [], []
    for _ in range(3):
        n = 12
        boxes = np.zeros((n, 7), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (n, 2))
        boxes[:, 3:6] = rng.uniform(1, 5, (n, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        names = rng.choice(["car", "truck", "pedestrian"], n)
        gts.append({"name": names, "boxes_lidar": boxes})
        db = np.concatenate([boxes, boxes[:4]])
        db[:, :3] += rng.normal(0, 0.3, (n + 4, 3))
        dets.append({"name": np.concatenate([names, names[:4]]), "boxes_lidar": db,
                     "score": np.round(rng.uniform(0, 1, n + 4), 1)})
    got = ply.lyft_average_precisions(gts, dets, ["car", "truck", "pedestrian", "animal"])
    want = jly.lyft_average_precisions(gts, dets, ["car", "truck", "pedestrian", "animal"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[:, :3].max() > 0 and not got[:, 3].any()


# --- Custom ---

CUSTOM_CFG = "custom_models/second.yaml"


@pytest.fixture(scope="module")
def custom_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("custom")
    names, data = shipped(CUSTOM_CFG)
    ls.write_custom_root(root, 4, 3, data["POINT_CLOUD_RANGE"], num_points=3000,
                         num_boxes=(8, 12), seed=4)
    port_dir = tmp_path_factory.mktemp("custom_port")
    jcu.create_custom_infos(JCfgDict(data), names, root, root)
    pcu.create_custom_infos(CfgDict(data), names, root, port_dir)
    return root, port_dir


def test_custom_infos_items_and_evaluation_match_jax(custom_roots):
    root, port_dir = custom_roots
    names, data = shipped(CUSTOM_CFG)
    for split in ("train", "val"):
        assert_tree_equal(pickle.loads((port_dir / f"custom_infos_{split}.pkl").read_bytes()),
                          pickle.loads((root / f"custom_infos_{split}.pkl").read_bytes()))
    data["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    for training in (True, False):
        port, jax_side = pair(pcu.CustomDataset, jcu.CustomDataset, data, names, training, root)
        assert len(port) == len(jax_side) == (4 if training else 3)
        assert_items_and_batch_equal(port, jax_side)
    preds = predictions(port.custom_infos, lambda i: i["annos"]["gt_boxes_lidar"],
                        lambda i: i["annos"]["name"], names, seed=9)
    (text, got), (jtext, want) = evaluations(
        port, jax_side, preds, names, [i["point_cloud"]["lidar_idx"] for i in port.custom_infos])
    assert text == jtext and got == want and "Car_3d/moderate_R40" in got


# --- Pandaset and the converted-layout Argo2Dataset ---

def test_pandaset_and_converted_argo2_match_jax(tmp_path):
    names = ["Car", "Pedestrian"]
    data = {**shipped("waymo_models/centerpoint.yaml")[1], "DATASET": "PandasetDataset",
            "POINT_FEATURE_ENCODING": FOUR,
            "INFO_PATH": {"train": ["pandaset_infos_train.pkl"],
                          "test": ["pandaset_infos_val.pkl"]}}
    ls.write_pandaset_root(tmp_path, 3, 3, data["POINT_CLOUD_RANGE"], num_points=3000,
                           num_boxes=(8, 12), seed=5)
    for pcls, jcls in ((ppa.PandasetDataset, jpa.PandasetDataset),
                       (ppa.Argo2Dataset, jpa.Argo2Dataset)):
        for training in (True, False):
            port, jax_side = pair(pcls, jcls, data, names, training, tmp_path)
            assert len(port) == len(jax_side) == 3
            assert_tree_equal(port.infos, jax_side.infos)
            assert_items_and_batch_equal(port, jax_side)
        preds = predictions(port.infos, lambda i: i["annos"]["gt_boxes_lidar"],
                            lambda i: i["annos"]["name"], names, seed=10)
        (text, got), (jtext, want) = evaluations(port, jax_side, preds, names,
                                                 [i["frame_id"] for i in port.infos])
        assert text == jtext and got == want and "Car_3d/moderate_R40" in got


# --- Argoverse 2 ---

ARGO2_CFG = "argo2_models/cbgs_voxel01_voxelnext.yaml"


def test_argo2_items_and_fallback_evaluation_match_jax(tmp_path):
    names, data = shipped(ARGO2_CFG)
    ls.write_argo2_root(tmp_path, 3, 3, data["POINT_CLOUD_RANGE"], num_points=3000,
                        num_boxes=(8, 12), seed=6)
    for training in (True, False):
        port, jax_side = pair(pa2.Argo2Dataset, ja2.Argo2Dataset, data, names, training,
                              tmp_path)
        assert len(port) == len(jax_side) == 3
        assert_tree_equal(port.argo2_infos, jax_side.argo2_infos)
        frames, _ = assert_items_and_batch_equal(port, jax_side)
        assert frames[0]["points"][:, 3].max() > 1.0   # intensities 0-255
    preds = predictions(port.argo2_infos, lambda i: pa2._gt_boxes(i["annos"]),
                        lambda i: i["annos"]["name"], names, seed=11)
    (text, got), (jtext, want) = evaluations(port, jax_side, preds, names,
                                             [i["sample_idx"] for i in port.argo2_infos])
    assert text == jtext and got == want
    assert {k.split("_")[0] for k in got} == {"Car", "Pedestrian", "Cyclist", "Bus", "Truck",
                                             "Bicycle", "Motorcycle"}


def test_argo2_predictions_keep_seven_columns(tmp_path):
    """The shipped Argo2 VoxelNeXt keeps the nuScenes heads' velocity: its
    boxes have 9 columns. The port keeps their first 7; the JAX package
    reshapes them to rows of 7, which raises (or, where 9 N is a multiple
    of 7, reads the wrong numbers)."""
    names, data = shipped(ARGO2_CFG)
    cfg = cfg_from_yaml_file(CFGS / ARGO2_CFG, CfgDict())
    assert "vel" in cfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_ORDER
    ls.write_argo2_root(tmp_path, 0, 2, data["POINT_CLOUD_RANGE"], num_points=500,
                        num_boxes=(4, 4), seed=15)
    port, jax_side = pair(pa2.Argo2Dataset, ja2.Argo2Dataset, data, names, False, tmp_path)
    rng = np.random.RandomState(16)
    preds = [{"pred_boxes": rng.uniform(1, 5, (n, 9)), "pred_scores": rng.uniform(size=n),
              "pred_labels": np.ones(n, np.int64)} for n in (5, 14)]
    fids = [i["sample_idx"] for i in port.argo2_infos]
    annos = port.generate_prediction_dicts(BatchMeta(fids, [None] * 2, [None] * 2), preds, names)
    for a, p in zip(annos, preds):
        np.testing.assert_array_equal(a["boxes_lidar"], p["pred_boxes"][:, :7])
    with pytest.raises(ValueError, match="reshape"):
        jax_side.generate_prediction_dicts(JBatchMeta(fids[:1], [None], [None]), preds[:1], names)
    (jax_anno,) = jax_side.generate_prediction_dicts(JBatchMeta(fids[1:], [None], [None]),
                                                     preds[1:], names)
    assert jax_anno["boxes_lidar"].shape == (18, 7) != annos[1]["boxes_lidar"].shape
    seven = [{**p, "pred_boxes": p["pred_boxes"][:, :7]} for p in preds]
    (text, got), (jtext, want) = evaluations(port, jax_side, seven, names, fids)
    assert text == jtext and got == want


def test_argo2_quaternions_match_jax():
    rng = np.random.RandomState(12)
    yaws = np.concatenate([np.linspace(-np.pi + 0.01, np.pi - 0.01, 17),
                           rng.uniform(-np.pi, np.pi, 50)])
    np.testing.assert_array_equal(pa2.yaw_to_quat(yaws), ja2.yaw_to_quat(yaws))
    quats = rng.normal(size=(40, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    np.testing.assert_array_equal(pa2.quat_to_yaw(quats), ja2.quat_to_yaw(quats))
    np.testing.assert_allclose(pa2.quat_to_yaw(pa2.yaw_to_quat(yaws)), yaws, atol=1e-12)


def test_argo2_convert_and_format_match_jax(tmp_path):
    """convert_av2_sensor on a feather fixture (pandas), both packages into
    their own directories: the same infos, bins and val_anno.feather; then
    format_results."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(13)
    av2 = tmp_path / "sensor"
    for split, log in (("train", "log_a"), ("val", "log_b")):
        rows = []
        for ts in (1000, 2000):
            d = av2 / split / log / "sensors" / "lidar"
            d.mkdir(parents=True, exist_ok=True)
            pts = rng.uniform(-20, 20, (500, 3))
            pd.DataFrame({"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2] * 0.05,
                          "intensity": rng.uniform(0, 255, 500)}).to_feather(d / f"{ts}.feather")
            boxes = rng.uniform(-15, 15, (6, 7))
            boxes[:, 3:6] = rng.uniform(1, 4, (6, 3))
            quat = ja2.yaw_to_quat(boxes[:, 6])
            rows.append(pd.DataFrame({
                "timestamp_ns": np.full(6, ts, np.int64),
                **{k: boxes[:, i] for i, k in enumerate(ja2.LABEL_ATTR[:6])},
                **{k: quat[:, i] for i, k in enumerate(ja2.LABEL_ATTR[6:])},
                "category": ["REGULAR_VEHICLE"] * 4 + ["PEDESTRIAN", "BUS"],
                "num_interior_pts": np.array([20, 20, 0, 20, 20, 20], np.int64)}))
        pd.concat(rows).reset_index(drop=True).to_feather(av2 / split / log / "annotations.feather")
    outs = {}
    for tag, mod in (("port", pa2), ("jax", ja2)):
        out = tmp_path / tag
        out.mkdir()
        outs[tag] = (out, mod.convert_av2_sensor(av2, out))
    (pout, ppaths), (jout, jpaths) = outs["port"], outs["jax"]
    for split in ("train", "val"):
        assert_tree_equal(pickle.loads(ppaths[split].read_bytes()),
                          pickle.loads(jpaths[split].read_bytes()))
    for f in sorted((jout / "training" / "velodyne").glob("*.bin")):
        np.testing.assert_array_equal(np.fromfile(pout / "training" / "velodyne" / f.name,
                                                  np.float32), np.fromfile(f, np.float32))
    assert pd.read_feather(pout / "val_anno.feather").equals(
        pd.read_feather(jout / "val_anno.feather"))
    names, data = shipped(ARGO2_CFG)
    port, jax_side = pair(pa2.Argo2Dataset, ja2.Argo2Dataset, data, names, False, pout)
    preds = predictions(port.argo2_infos, lambda i: pa2._gt_boxes(i["annos"]),
                        lambda i: i["annos"]["name"], names, seed=14)
    fids = [i["sample_idx"] for i in port.argo2_infos]
    n = len(fids)
    got = port.format_results(port.generate_prediction_dicts(
        BatchMeta(fids, [None] * n, [None] * n), preds, names))
    want = jax_side.format_results(jax_side.generate_prediction_dicts(
        JBatchMeta(fids, [None] * n, [None] * n), preds, names))
    assert got.equals(want) and (got["category"] == "REGULAR_VEHICLE").any()


def test_build_dataloader_reads_each_dataset(waymo_root, once_roots, custom_roots):
    """build_dataloader takes the registry's names: one batch each."""
    cases = [(WAYMO_CFG, waymo_root[0], {}),
             (ONCE_CFG, once_roots[0], {"INFO_PATH": {"train": ["once_infos_train.pkl"],
                                                      "test": ["once_infos_val.pkl"]}}),
             (CUSTOM_CFG, custom_roots[0], {})]
    for cfg_file, root, extra in cases:
        names, data = shipped(cfg_file, **extra)
        ds, loader = build_dataloader(CfgDict(data), names, batch_size=2, root_path=root,
                                      workers=1, training=False)
        batch, meta = next(iter(loader))
        assert type(ds).__name__ == data["DATASET"] and batch.points.shape[0] == 2
        assert batch.points.shape[-1] == ds.num_point_features
