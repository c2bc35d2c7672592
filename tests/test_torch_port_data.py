"""Port parity for the data path: np_geometry, the calibration, kitti_io,
the augmentors, the gt-database sampler, the processor, info and gt-database
generation, KittiDataset.__getitem__, collate, the loader's order and the
train loop's loader hooks, each against the JAX package on the same numpy
inputs and seeds. Exact unless a test states a tolerance."""
import copy
import pickle
from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

from dfu3d_tpu.core.geometry import calibration as jcal
from dfu3d_tpu.data import kitti_io as jio
from dfu3d_tpu.data import np_geometry as jnpg
from dfu3d_tpu.data.data_augmentor import DataAugmentor as JDataAugmentor
from dfu3d_tpu.data.database_sampler import DataBaseSampler as JDataBaseSampler
from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from dfu3d_tpu.data.kitti_dataset import create_kitti_infos as j_create_kitti_infos
from dfu3d_tpu.data.loader import DataLoader as JDataLoader
from dfu3d_tpu.data.processor import DataProcessor as JDataProcessor
from dfu3d_tpu.train.trainer import disable_augmentation_hook as j_disable_hook
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_list as j_cfg_from_list
from dfu3d_tpu_torch.core.geometry import calibration as pcal
from dfu3d_tpu_torch.data import augmentor_utils as paug
from dfu3d_tpu_torch.data import kitti_io as pio
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data import np_geometry as pnpg
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.data.data_augmentor import DataAugmentor
from dfu3d_tpu_torch.data.database_sampler import DataBaseSampler
from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset, create_kitti_infos
from dfu3d_tpu_torch.data.loader import DataLoader, build_dataloader
from dfu3d_tpu_torch.data.processor import DataProcessor
from dfu3d_tpu_torch.train.trainer import disable_augmentation_hook, train_model
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_list

from test_e2e import _dataset_cfg
from test_torch_port_cli import tiny_state

CLASSES = ["Car", "Pedestrian"]


def assert_tree_equal(a, b, path="root"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A synthetic root (10 train, 4 val frames); the JAX package writes its
    infos and gt database into it, the port into `port_dir`."""
    root = tmp_path_factory.mktemp("kitti_port_data")
    kitti_synthetic.write_root(root, 10, 4, CLASSES, seed=3, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    port_dir = tmp_path_factory.mktemp("kitti_port_infos")
    jcfg, pcfg = JCfgDict(_dataset_cfg(root)), CfgDict(_dataset_cfg(root))
    j_create_kitti_infos(jcfg, CLASSES, root, root)
    create_kitti_infos(pcfg, CLASSES, root, port_dir)
    jds = JKittiDataset(jcfg, CLASSES, training=False, root_path=root)
    jds.create_groundtruth_database(root / "kitti_infos_train.pkl", root, used_classes=CLASSES)
    pds = KittiDataset(pcfg, CLASSES, training=False, root_path=root)
    pds.create_groundtruth_database(port_dir / "kitti_infos_train.pkl", port_dir,
                                    used_classes=CLASSES)
    return root, port_dir


def random_boxes(rng, n, extent=20.0):
    return np.concatenate([rng.uniform(-extent, extent, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


def test_np_geometry_matches_jax():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 40, 8.0), random_boxes(rng, 30, 8.0)
    pts = np.concatenate([rng.uniform(-10, 10, (500, 3)), rng.uniform(0, 1, (500, 1))],
                         axis=1).astype(np.float32)
    for name, args in [("boxes_to_corners_bev", (a,)), ("boxes_to_corners_3d", (a,)),
                       ("pairwise_overlap_bev", (a, b)), ("pairwise_iou_bev", (a, b)),
                       ("points_in_boxes", (pts, a)), ("remove_points_in_boxes", (pts, a)),
                       ("mask_boxes_outside_range", (a, [-5, -5, -1, 5, 5, 1])),
                       ("limit_period", (a[:, 6] * 3,))]:
        np.testing.assert_array_equal(getattr(pnpg, name)(*args), getattr(jnpg, name)(*args),
                                      err_msg=name)
    assert pnpg.pairwise_overlap_bev(a, b).max() > 0


def test_calibration_matches_jax(tmp_path):
    calib_file = tmp_path / "calib.txt"
    calib_file.write_text(kitti_synthetic.CALIB_TXT)
    assert_tree_equal(pcal.get_calib_from_file(calib_file), jcal.get_calib_from_file(calib_file))
    p, j = pcal.Calibration(calib_file), jcal.Calibration(calib_file)
    rng = np.random.RandomState(1)
    pts = np.stack([rng.uniform(2, 50, 300), rng.uniform(-20, 20, 300),
                    rng.uniform(-2, 1, 300)], axis=1).astype(np.float32)
    np.testing.assert_array_equal(p.lidar_to_rect(pts), j.lidar_to_rect(pts))
    np.testing.assert_array_equal(p.rect_to_lidar(pts), j.rect_to_lidar(pts))
    for name in ("rect_to_img", "lidar_to_img"):
        for got, want in zip(getattr(p, name)(pts), getattr(j, name)(pts)):
            np.testing.assert_array_equal(got, want, err_msg=name)
    u, v, d = pts[:, 0] * 20, pts[:, 1] * 10, pts[:, 2] + 10
    np.testing.assert_array_equal(p.img_to_rect(u, v, d), j.img_to_rect(u, v, d))
    corners = jnpg.boxes_to_corners_3d(random_boxes(rng, 12) + [30, 0, 0, 0, 0, 0, 0])
    for got, want in zip(p.corners3d_to_img_boxes(corners), j.corners3d_to_img_boxes(corners)):
        np.testing.assert_array_equal(got, want)
    for attr in ("cu", "cv", "fu", "fv", "tx", "ty"):
        assert getattr(p, attr) == getattr(j, attr)
    np.testing.assert_array_equal(p.rect_from_lidar, j.mats.rect_from_lidar)
    np.testing.assert_array_equal(p.lidar_from_rect, j.mats.lidar_from_rect)


def test_kitti_io_labels_match_jax(tmp_path):
    lines = ["Car 0.00 0 -1.57 600.00 150.00 700.00 250.00 1.60 1.80 4.00 1.00 1.50 20.00 0.10",
             "Pedestrian 0.20 1 0.30 10.00 20.00 30.00 45.00 1.70 0.70 0.70 -3.00 1.60 9.00 "
             "-2.00 0.8800",
             "DontCare -1 -1 -10 500.00 160.00 520.00 190.00 -1 -1 -1 -1000 -1000 -1000 -10"]
    label = tmp_path / "000001.txt"
    label.write_text("\n".join(lines) + "\n\n")
    got, want = pio.get_objects_from_label(label), jio.get_objects_from_label(label)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_tree_equal({k: v for k, v in vars(g).items()}, {k: v for k, v in vars(w).items()})
    anno = {"name": np.array(["Car", "Cyclist"]), "alpha": np.array([0.1, -2.0]),
            "bbox": np.array([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]]),
            "dimensions": np.array([[4.0, 1.5, 1.8], [1.7, 1.7, 0.6]]),
            "location": np.array([[1.0, 1.6, 20.0], [-2.0, 1.5, 8.25]]),
            "rotation_y": np.array([0.3, -1.2]), "score": np.array([0.9, 0.123456])}
    pio.write_kitti_label_file(tmp_path / "p" / "a.txt", anno)
    jio.write_kitti_label_file(tmp_path / "j" / "a.txt", anno)
    assert (tmp_path / "p" / "a.txt").read_text() == (tmp_path / "j" / "a.txt").read_text()
    pio.write_kitti_label_file(tmp_path / "p" / "empty.txt", {k: v[:0] for k, v in anno.items()})
    assert (tmp_path / "p" / "empty.txt").read_text() == ""


@pytest.mark.parametrize("size,mode", [((1240, 370), "L"), ((1, 1), "RGB"), ((1600, 900), "RGBA")])
def test_get_image_shape_matches_pil(tmp_path, size, mode):
    path = tmp_path / "img.png"
    Image.new(mode, size).save(path)
    got = pio.get_image_shape(path)
    np.testing.assert_array_equal(got, jio.get_image_shape(path))
    assert got.dtype == np.int32 and got.tolist() == [size[1], size[0]]
    # the port's own PNG writer is read alike by PIL
    kitti_synthetic.write_png_gray(tmp_path / "own.png", *size)
    with Image.open(tmp_path / "own.png") as im:
        im.load()
        assert im.size == size
    np.testing.assert_array_equal(pio.get_image_shape(tmp_path / "own.png"), got)


def test_get_image_shape_rejects_other_files(tmp_path):
    Image.new("RGB", (8, 4)).save(tmp_path / "img.jpg")
    with pytest.raises(ValueError, match="not a PNG"):
        pio.get_image_shape(tmp_path / "img.jpg")


def scene(seed, n_boxes=6, n_points=3000):
    """A frame dict: boxes 10-40 m ahead and points around and inside them."""
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, n_boxes, 15.0) + np.float32([25, 0, 0, 0, 0, 0, 0])
    inside = [rng.uniform(-0.45, 0.45, (60, 3)) * b[3:6] + b[0:3] for b in boxes]
    pts = np.concatenate(inside + [np.stack([rng.uniform(5, 45, n_points),
                                             rng.uniform(-20, 20, n_points),
                                             rng.uniform(-2, 1, n_points)], axis=1)])
    pts = np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], axis=1).astype(np.float32)
    names = np.array([CLASSES[i % 2] for i in range(n_boxes)])
    return {"gt_boxes": boxes, "gt_names": names, "points": pts,
            "gt_boxes_mask": np.ones(n_boxes, bool)}


AUGMENTATIONS = [
    {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
    {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
    {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.9, 1.1]},
    {"NAME": "random_world_translation", "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.5]},
    {"NAME": "random_local_translation", "LOCAL_TRANSLATION_RANGE": [-0.25, 0.25],
     "ALONG_AXIS_LIST": ["x", "y", "z"]},
    {"NAME": "random_local_rotation", "LOCAL_ROT_ANGLE": [-0.15, 0.15]},
    {"NAME": "random_local_scaling", "LOCAL_SCALE_RANGE": [0.95, 1.05]},
    {"NAME": "random_world_frustum_dropout", "INTENSITY_RANGE": [0, 0.2],
     "DIRECTION": ["top", "left"]},
    {"NAME": "random_local_frustum_dropout", "INTENSITY_RANGE": [0, 0.2],
     "DIRECTION": ["bottom", "right"]},
    {"NAME": "random_local_pyramid_aug", "DROP_PROB": 0.25, "SPARSIFY_PROB": 0.5,
     "SPARSIFY_MAX_NUM": 5, "SWAP_PROB": 0.5, "SWAP_MAX_NUM": 5},
]


@pytest.mark.parametrize("aug", AUGMENTATIONS, ids=[a["NAME"] for a in AUGMENTATIONS])
def test_augmentor_matches_jax(tmp_path, aug):
    for seed in range(3):
        out = []
        for cls, cfgd in ((DataAugmentor, CfgDict), (JDataAugmentor, JCfgDict)):
            augmentor = cls(tmp_path, [cfgd(aug)], CLASSES, rng=np.random.RandomState(seed))
            out.append(augmentor.forward(scene(seed)))
        assert_tree_equal(*out)
    assert len(paug.get_pyramids(scene(0)["gt_boxes"])) == 6


def test_image_augmentations_raise(tmp_path):
    """The image augmentation, the sampler's image copy-paste and the image
    processors raised NotImplementedError until the image data path was
    ported; they now build as the JAX package's do and act alike:
    random_image_flip draws once per frame with images and none without,
    the sampler takes IMG_AUG_TYPE kitti, image_normalize normalises a
    uint8 image as JAX's (tests/test_torch_port_image_data.py holds the
    whole path against JAX)."""
    rng = np.random.RandomState(0)
    frames = [{"gt_boxes": rng.normal(0, 1, (2, 8)).astype(np.float32),
               "images": rng.uniform(0, 1, (4, 6, 3)).astype(np.float32)} for _ in range(4)]
    frames.insert(2, {"gt_boxes": rng.normal(0, 1, (2, 8)).astype(np.float32)})
    out = []
    for cls, cfgd in ((DataAugmentor, CfgDict), (JDataAugmentor, JCfgDict)):
        augmentor = cls(tmp_path, [cfgd({"NAME": "random_image_flip"})], CLASSES,
                        rng=np.random.RandomState(3))
        out.append([augmentor.forward(copy.deepcopy(f)) for f in frames])
    assert_tree_equal(*out)
    assert 0 < sum("image_flipped" in f for f in out[1]) < 4
    sampler_cfg = {"DB_INFO_PATH": [], "SAMPLE_GROUPS": [], "IMG_AUG_TYPE": "kitti"}
    assert DataBaseSampler(tmp_path, CfgDict(sampler_cfg), CLASSES).img_aug_type == \
        JDataBaseSampler(tmp_path, JCfgDict(sampler_cfg), CLASSES).img_aug_type == "kitti"
    proc = {"NAME": "image_normalize", "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
    image = rng.randint(0, 256, (4, 6, 3)).astype(np.uint8)
    got = DataProcessor([CfgDict(proc)], [0, -1, -1, 1, 1, 1], True, 4).forward({"images": image})
    want = JDataProcessor([JCfgDict(proc)], [0, -1, -1, 1, 1, 1], True, 4).forward(
        {"images": image})
    np.testing.assert_array_equal(got["images"], want["images"])


def test_database_sampler_matches_jax(roots):
    root, port_dir = roots
    sampler_cfg = {"DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
                   "PREPARE": {"filter_by_min_points": ["Car:5", "Pedestrian:5"],
                               "filter_by_difficulty": [-1]},
                   "SAMPLE_GROUPS": ["Car:9", "Pedestrian:6"], "NUM_POINT_FEATURES": 4,
                   "REMOVE_EXTRA_WIDTH": [0.1, 0.1, 0.1], "LIMIT_WHOLE_SCENE": True}
    port = DataBaseSampler(port_dir, CfgDict(sampler_cfg), CLASSES, rng=np.random.RandomState(5))
    jax_side = JDataBaseSampler(root, JCfgDict(sampler_cfg), CLASSES,
                                rng=np.random.RandomState(5))
    assert_tree_equal(port.db_infos, jax_side.db_infos)
    added = 0
    for seed in range(6):   # the shuffled pointers wrap around more than once
        got, want = port(scene(seed, 3, 500)), jax_side(scene(seed, 3, 500))
        assert_tree_equal(got, want)
        added += len(got["gt_boxes"]) - 3
    assert added > 10


def test_processor_matches_jax():
    procs = [{"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
             {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
             {"NAME": "sample_points", "NUM_POINTS": {"train": 2000, "test": 5000}},
             {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.1, 0.1, 0.2],
              "MAX_POINTS_PER_VOXEL": 10, "MAX_NUMBER_OF_VOXELS": {"train": 100, "test": 200}}]
    pcr = [0, -20, -3, 40, 20, 1]
    for training in (True, False):
        out = []
        for cls, cfgd in ((DataProcessor, CfgDict), (JDataProcessor, JCfgDict)):
            proc = cls([cfgd(p) for p in procs], pcr, training, 4)
            np.random.seed(7)
            out.append((proc.forward(scene(1)), proc.grid_size, proc.voxel_size, proc.max_voxels))
        assert_tree_equal(*out)
    grid = DataProcessor([CfgDict({"NAME": "calculate_grid_size", "VOXEL_SIZE": [0.4, 0.4, 4]})],
                         pcr, False, 4).grid_size
    np.testing.assert_array_equal(grid, [100, 100, 1])


def test_infos_and_gt_database_match_jax(roots):
    root, port_dir = roots
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl", "kitti_dbinfos_train.pkl"):
        with open(port_dir / name, "rb") as f, open(root / name, "rb") as g:
            assert_tree_equal(pickle.load(f), pickle.load(g), name)
    bins = sorted(p.name for p in (root / "gt_database").iterdir())
    assert bins == sorted(p.name for p in (port_dir / "gt_database").iterdir())
    assert len(bins) > 40
    for name in bins:
        assert (root / "gt_database" / name).read_bytes() == \
            (port_dir / "gt_database" / name).read_bytes()
    infos = pickle.load(open(port_dir / "kitti_infos_train.pkl", "rb"))
    assert len(infos) == 10 and (infos[0]["annos"]["num_points_in_gt"] >= 20).all()
    np.testing.assert_array_equal(infos[0]["image"]["image_shape"], [370, 1240])


def flagship_like_cfg(root, cfgd):
    """The test dataset config with the flagship's gt sampling and four world
    augmentations."""
    cfg = cfgd(_dataset_cfg(root))
    cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].PREPARE = {
        "filter_by_min_points": ["Car:5", "Pedestrian:5"]}
    cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].SAMPLE_GROUPS = ["Car:6", "Pedestrian:5"]
    cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
        cfgd({"NAME": "random_world_translation", "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.5]}))
    return cfg


def make_datasets(root, training, seed=11):
    """(port, JAX) KittiDatasets, augmentor and sampler drawing from one
    seeded RandomState per side."""
    out = []
    for cls, cfgd in ((KittiDataset, CfgDict), (JKittiDataset, JCfgDict)):
        ds = cls(flagship_like_cfg(root, cfgd), CLASSES, training=training, root_path=root)
        if ds.data_augmentor is not None:
            rng = np.random.RandomState(seed)
            ds.data_augmentor.rng = rng
            ds.data_augmentor.data_augmentor_queue[0].rng = rng
        out.append(ds)
    return out


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_getitem_and_collate_match_jax(roots, training):
    root, _ = roots
    port, jax_side = make_datasets(root, training)
    frames = []
    for ds in (port, jax_side):
        np.random.seed(2)
        frames.append([ds[i] for i in range(len(ds))])
    for got, want in zip(*frames):
        calib_p, calib_j = got.pop("calib"), want.pop("calib")
        np.testing.assert_array_equal(calib_p.P2, calib_j.P2)
        assert_tree_equal(got, want)
    assert len(frames[0]) == (10 if training else 4)
    batch, meta = port.collate_batch(frames[0][:3])
    jbatch, jmeta = jax_side.collate_batch(frames[1][:3])
    assert isinstance(batch, PointBatch) and batch.points.dtype == torch.float32
    for got, want in zip(batch, jbatch):
        np.testing.assert_array_equal(got.numpy(), want)
    assert meta.frame_ids == jmeta.frame_ids
    assert_tree_equal(meta.image_shapes, jmeta.image_shapes)
    assert batch.gt_valid.sum() > 0 and batch.points.shape == (3, 4096, 4)


def test_loader_order_matches_jax(roots):
    root, _ = roots
    port, jax_side = make_datasets(root, False)
    for shuffle in (True, False):
        for process_count in (1, 2):
            for index in range(process_count):
                kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=shuffle,
                          process_index=index, process_count=process_count)
                p, j = DataLoader(port, **kw), JDataLoader(jax_side, **kw)
                for epoch in (0, 1):
                    p.set_epoch(epoch)
                    j.set_epoch(epoch)
                    np.testing.assert_array_equal(p._local_indices(), j._local_indices())
                    assert len(p) == len(j)
    loader = DataLoader(port, batch_size=3, shuffle=False, num_workers=1, drop_last=False)
    ids = [fid for _, meta in loader for fid in meta.frame_ids]
    assert ids == [info["point_cloud"]["lidar_idx"] for info in port.kitti_infos]


def test_loader_raises_a_frame_error_and_unknown_datasets(roots):
    root, _ = roots
    port, _ = make_datasets(root, False)
    port.kitti_infos[1] = copy.deepcopy(port.kitti_infos[1])
    port.kitti_infos[1]["point_cloud"]["lidar_idx"] = "missing"
    with pytest.raises(FileNotFoundError):
        list(DataLoader(port, batch_size=2, shuffle=False, num_workers=2))
    cfg = CfgDict(_dataset_cfg(root))
    cfg.DATASET = "NoSuchDataset"
    with pytest.raises(NotImplementedError, match="NoSuchDataset"):
        build_dataloader(cfg, CLASSES, batch_size=2)


def test_loader_hooks_match_jax(roots, tmp_path):
    """disable_augmentation_hook on both sides, merge_all_iters_to_one_epoch,
    and train_model's use of both (set_epoch once per epoch, the hook in the
    last epoch only)."""
    root, _ = roots
    hook = {"DisableAugmentationHook": {"DISABLE_AUG_LIST": ["gt_sampling",
                                                              "random_world_flip"],
                                        "NUM_LAST_EPOCHS": 1}}
    queues = []
    for (ds, cfgd, fn) in zip(make_datasets(root, True), (CfgDict, JCfgDict),
                              (disable_augmentation_hook, j_disable_hook)):
        cfg = cfgd({"DATA_CONFIG": flagship_like_cfg(root, cfgd), "HOOK": hook})
        loader = DataLoader(ds, batch_size=2)
        fn(cfg.HOOK.DisableAugmentationHook, loader, 3, 1, cfg, None)
        assert len(ds.data_augmentor.data_augmentor_queue) == 5     # not yet
        fn(cfg.HOOK.DisableAugmentationHook, loader, 3, 2, cfg, None)
        queues.append([a.func.__name__ if isinstance(a, partial) else type(a).__name__
                       for a in ds.data_augmentor.data_augmentor_queue])
        ds.merge_all_iters_to_one_epoch(merge=True, epochs=3)
        assert len(ds) == 30 and ds[25]["frame_id"] == ds.kitti_infos[5]["point_cloud"][
            "lidar_idx"]
    assert queues[0] == queues[1] == ["random_world_rotation", "random_world_scaling",
                                      "random_world_translation"]

    class Recorder(list):
        """A re-iterable loader stand-in that records its hooks."""
        def __init__(self, dataset, batches):
            super().__init__(batches)
            self.dataset, self.epochs = dataset, []

        def set_epoch(self, epoch):
            self.epochs.append(epoch)

    state, batches = tiny_state(root)
    port, _ = make_datasets(root, True)
    cfg = CfgDict({"DATA_CONFIG": flagship_like_cfg(root, CfgDict), "HOOK": hook})
    rec = Recorder(port, [(b, None) for b in batches])
    train_model(state, rec, 3, tmp_path, device="cpu", dtype=torch.float32, cfg=cfg)
    assert rec.epochs == [0, 1, 2] and state.step == 3 * len(batches)
    assert len(port.data_augmentor.data_augmentor_queue) == 3
    rec = Recorder(make_datasets(root, True)[0], [(b, None) for b in batches])
    stats = []
    train_model(state, rec, 2, tmp_path / "merged", device="cpu", dtype=torch.float32,
                merge_all_iters_to_one_epoch=True, on_epoch=stats.append)
    assert rec.epochs == [0] and rec.dataset.total_epochs == 2
    assert [s["epoch"] for s in stats] == [0] and len(stats[0]["losses"]) == len(batches)


def test_cfg_from_list_matches_jax():
    base = {"A": {"B": 1, "C": ["Car"], "D": {"x": 1.0, "y": 2.0}, "E": "s", "F": [0.5]}}
    overrides = ["A.B", "3", "A.C", "Car,Bus", "A.D", "x:3,y:4", "A.E", "/data/kitti",
                 "A.F", "[0.25, 0.75]"]
    got = cfg_from_list(overrides, CfgDict(base))
    assert got == j_cfg_from_list(overrides, JCfgDict(base))
    assert got.A.C == ["Car", "Bus"] and got.A.D == {"x": 3.0, "y": 4.0}
    assert got.A.E == "/data/kitti" and got.A.F == [0.25, 0.75]
    with pytest.raises(KeyError):
        cfg_from_list(["A.Z", "1"], CfgDict(base))
    with pytest.raises(TypeError):
        cfg_from_list(["A.B", "0.5"], CfgDict(base))
