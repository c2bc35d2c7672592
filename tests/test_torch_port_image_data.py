"""Port parity: the KITTI image data path (host numpy in both packages)
against the JAX package, on a synthetic KITTI root whose image_2 PNGs hold
seeded random RGB pixels (one frame keeps its blank gray PNG):

* `KittiDataset.get_image` through the port's `kitti_io.read_png` against
  the JAX package's PIL read: exactly equal (8-bit PNGs);
* `KittiDataset(CaDDN.yaml)[i]` (images, gt_boxes2d and points in
  GET_ITEM_LIST; random_image_flip; image_normalization) in train mode at a
  seed (the augmentors' generators seeded alike) and in test mode: the same
  keys, every array exactly equal, the calibrations' matrices equal;
* `random_image_flip` through the augmentor queue (images with and without
  a depth map, a frame without images, which draws nothing): exactly equal,
  and the generators left in the same state;
* the image processors `downsample_depth_map` (a map padded at its edges),
  `image_normalization` (a uint8 image and a list of camera images) and
  `image_calibrate` (recorded resize / crop / flip / rotate, and none):
  exactly equal;
* the gt sampler with IMG_AUG_TYPE kitti: the 2D-IoU filter, the source
  crops read from the root's PNGs, the paste and the occlusion filter on
  the points: points, boxes, names, 2D boxes and the image exactly equal.
"""
import copy
import os
from pathlib import Path

import numpy as np
import pytest

from dfu3d_tpu.core.geometry.calibration import Calibration as JCalibration
from dfu3d_tpu.data import data_augmentor as jda
from dfu3d_tpu.data import database_sampler as jdbs
from dfu3d_tpu.data import processor as jproc
from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.data import data_augmentor as pda
from dfu3d_tpu_torch.data import database_sampler as pdbs
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data import processor as pproc
from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset, create_kitti_infos
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

TOOLS = Path(__file__).resolve().parents[1] / "tools"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
GRAY_FRAME = "000003"   # keeps the blank gray PNG that write_root makes


def caddn_cfg():
    cwd = os.getcwd()
    os.chdir(TOOLS)
    try:
        return cfg_from_yaml_file("cfgs/kitti_models/CaDDN.yaml", CfgDict())
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """4 train + 2 val frames (3,000-4,000 points, 5-8 boxes), random RGB
    PNGs (but GRAY_FRAME's), the info pkls and the train gt database."""
    root = tmp_path_factory.mktemp("kitti_images")
    kitti_synthetic.write_root(root, 4, 2, CLASSES, num_points=(3000, 4000), num_boxes=(5, 8))
    rng = np.random.RandomState(0)
    for png in sorted((root / "image_2").glob("*.png")):
        if png.stem != GRAY_FRAME:
            kitti_synthetic.write_png_rgb(png, rng.randint(0, 256, (kitti_synthetic.IMG_H,
                                                                    kitti_synthetic.IMG_W, 3),
                                                         dtype=np.uint8))
    cfg = caddn_cfg()
    create_kitti_infos(cfg.DATA_CONFIG, CLASSES, root, root)
    ds = KittiDataset(_ds_cfg(cfg, root), CLASSES, training=False, root_path=root)
    ds.create_groundtruth_database(root / "kitti_infos_train.pkl", root, split="train")
    return root


def _ds_cfg(cfg, root):
    ds_cfg = copy.deepcopy(cfg.DATA_CONFIG)
    ds_cfg.DATA_PATH = str(root)
    ds_cfg.INFO_PATH = {"train": [str(root / "kitti_infos_train.pkl")],
                        "test": [str(root / "kitti_infos_val.pkl")]}
    return ds_cfg


def datasets(root, training):
    cfg = caddn_cfg()
    ds_cfg = _ds_cfg(cfg, root)
    port = KittiDataset(ds_cfg, CLASSES, training=training, root_path=root)
    jax_ds = JKittiDataset(JCfgDict(ds_cfg), CLASSES, training=training, root_path=root)
    return port, jax_ds


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, JCalibration):
            for attr in ("P2", "R0", "V2C"):
                np.testing.assert_array_equal(getattr(g, attr), getattr(w, attr), err_msg=k)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def test_get_image_matches_pil(kitti_root):
    port, jax_ds = datasets(kitti_root, training=False)
    ids = sorted(p.stem for p in (kitti_root / "image_2").glob("*.png"))
    assert GRAY_FRAME in ids
    for idx in ids:
        got, want = port.get_image(idx), jax_ds.get_image(idx)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (kitti_synthetic.IMG_H, kitti_synthetic.IMG_W, 3)
        np.testing.assert_array_equal(got, want)
    assert port.get_image(ids[0]).std() > 0.2 and not port.get_image(GRAY_FRAME).any()


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_caddn_items_match_jax(kitti_root, training):
    port, jax_ds = datasets(kitti_root, training)
    if training:
        port.data_augmentor.rng = np.random.RandomState(1)
        jax_ds.data_augmentor.rng = np.random.RandomState(1)
    flipped = 0
    for i in range(len(port)):
        np.random.seed(i)
        got = port[i]
        np.random.seed(i)
        want = jax_ds[i]
        assert_items_equal(got, want)
        assert "images" in want and "gt_boxes2d" in want
        flipped += bool(want.get("image_flipped"))
        # image_normalization: (x - mean) / std of an image in [0, 1]
        if want["frame_id"] != GRAY_FRAME:
            assert want["images"].min() < -1.5 and want["images"].max() > 2.0
    if training:
        assert 0 < flipped < len(port)


def test_random_image_flip_matches_jax():
    aug_cfg = CfgDict({"DISABLE_AUG_LIST": [],
                       "AUG_CONFIG_LIST": [{"NAME": "random_image_flip",
                                            "ALONG_AXIS_LIST": ["horizontal"]}]})
    port = pda.DataAugmentor(None, aug_cfg, CLASSES, rng=np.random.RandomState(2))
    jaug = jda.DataAugmentor(None, JCfgDict(aug_cfg), CLASSES, rng=np.random.RandomState(2))
    rng = np.random.RandomState(3)
    flipped = 0
    for i in range(8):
        d = {"gt_boxes": rng.normal(0, 1, (3, 8)).astype(np.float32)}
        if i != 3:   # frame 3 has no image: no draw
            d["images"] = rng.uniform(0, 1, (6, 9, 3)).astype(np.float32)
        if i % 2:
            d["depth_maps"] = rng.uniform(0, 40, (6, 9)).astype(np.float32)
        got = port.random_image_flip(copy.deepcopy(d), aug_cfg.AUG_CONFIG_LIST[0])
        want = jaug.random_image_flip(copy.deepcopy(d), aug_cfg.AUG_CONFIG_LIST[0])
        assert_items_equal(got, want)
        flipped += bool(want.get("image_flipped"))
        if want.get("image_flipped"):
            np.testing.assert_array_equal(want["images"], d["images"][:, ::-1])
    assert 0 < flipped < 7
    assert port.rng.uniform() == jaug.rng.uniform()


def test_image_processors_match_jax():
    cfgs = [{"NAME": "calculate_grid_size", "VOXEL_SIZE": [0.16, 0.16, 4.0]},
            {"NAME": "downsample_depth_map", "DOWNSAMPLE_FACTOR": 4},
            {"NAME": "image_normalization", "mean": [0.485, 0.456, 0.406],
             "std": [0.229, 0.224, 0.225]},
            {"NAME": "image_calibrate"}]
    pcr = [2.0, -30.08, -3.0, 46.8, 30.08, 1.0]
    port = pproc.DataProcessor([CfgDict(c) for c in cfgs], pcr, True, 4)
    jp = jproc.DataProcessor([JCfgDict(c) for c in cfgs], pcr, True, 4)
    np.testing.assert_array_equal(port.grid_size, jp.grid_size)
    rng = np.random.RandomState(5)
    frames = [
        {"images": rng.randint(0, 256, (37, 50, 3)).astype(np.uint8),
         "depth_maps": rng.uniform(0, 60, (37, 50)).astype(np.float32)},
        {"camera_imgs": [rng.uniform(0, 1, (16, 24, 3)).astype(np.float32) for _ in range(2)],
         "depth_maps": rng.uniform(0, 60, (32, 48)).astype(np.float32),
         "img_process_infos": [(0.48, (32, 176, 736, 432), False, 3.5),
                               (0.5, (0, 140, 704, 396), True, -5.4)]},
        {"camera_imgs": [rng.uniform(0, 1, (16, 24, 3)).astype(np.float32) for _ in range(3)],
         "depth_maps": rng.uniform(0, 60, (16, 24)).astype(np.float32)},
    ]
    outs = []
    for d in frames:
        # a single image without recorded augmentations: image_calibrate
        # takes the array's truth value and raises in both (ROADMAP Queue C)
        single = "images" in d
        got = (port if not single else pproc.DataProcessor(
            [CfgDict(c) for c in cfgs[:3]], pcr, True, 4)).forward(copy.deepcopy(d))
        want = (jp if not single else jproc.DataProcessor(
            [JCfgDict(c) for c in cfgs[:3]], pcr, True, 4)).forward(copy.deepcopy(d))
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if not isinstance(w, list):
                g, w = [g], [w]
            assert len(g) == len(w), k
            for gi, wi in zip(g, w):
                if isinstance(wi, np.ndarray):
                    np.testing.assert_array_equal(gi, wi, err_msg=k)
                else:
                    assert gi == wi, k
        if single:
            assert got["depth_maps"].shape == (10, 13) and got["images"].dtype == np.float32
            for proc in (port, jp):
                with pytest.raises(ValueError, match="truth value"):
                    proc.forward(copy.deepcopy(d))
        outs.append(got)
    # a frame without a depth map: downsample_depth_map reads np.asarray(None)
    # and raises in both (ROADMAP Queue C)
    for proc in (port, jp):
        with pytest.raises(ValueError, match="not enough values to unpack"):
            proc.forward({"camera_imgs": frames[2]["camera_imgs"]})
    assert len(outs[1]["img_aug_matrix"]) == 2 and len(outs[2]["img_aug_matrix"]) == 3
    assert not np.allclose(outs[1]["img_aug_matrix"][1], np.eye(4))
    np.testing.assert_array_equal(outs[2]["img_aug_matrix"][0], np.eye(4))


def _scene(root, index):
    """The train frame's fields before augmentation, as __getitem__ reads
    them (CaDDN.yaml's GET_ITEM_LIST), with the gt mask the dataset adds."""
    ds = KittiDataset(_ds_cfg(caddn_cfg(), root), CLASSES, training=True, root_path=root)
    captured = {}

    def grab(data_dict):
        captured.update(data_dict)
        return {}

    ds.prepare_data = grab
    ds[index]
    captured["gt_boxes_mask"] = np.ones(len(captured["gt_names"]), bool)
    return captured


def test_gt_sampler_image_copy_paste_matches_jax(kitti_root):
    base = cfg_from_yaml_file(TOOLS / "cfgs/dataset_configs/kitti_dataset.yaml", CfgDict())
    sampler_cfg = copy.deepcopy(base.DATA_AUGMENTOR.AUG_CONFIG_LIST[0])
    sampler_cfg.update(DB_INFO_PATH=["kitti_dbinfos_train.pkl"], USE_ROAD_PLANE=False,
                       SAMPLE_GROUPS=["Car:8", "Pedestrian:6", "Cyclist:6"],
                       IMG_AUG_TYPE="kitti", IMG_AUG_IOU_THRESH=0.5)
    port = pdbs.DataBaseSampler(kitti_root, sampler_cfg, CLASSES, rng=np.random.RandomState(6))
    jsampler = jdbs.DataBaseSampler(kitti_root, JCfgDict(sampler_cfg), CLASSES,
                                    rng=np.random.RandomState(6))
    pasted = 0
    for index in range(3):
        scene = _scene(kitti_root, index)
        jscene = {**copy.deepcopy(scene), "calib": JCalibration(
            kitti_root / "calib" / f"{scene['frame_id']}.txt")}
        got = port(copy.deepcopy(scene))
        want = jsampler(jscene)
        for k in ("points", "gt_boxes", "gt_names", "gt_boxes2d", "images"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert set(got) == set(want)
        pasted += len(want["gt_boxes2d"]) - len(scene["gt_boxes2d"])
        assert len(want["gt_boxes2d"]) == len(want["gt_boxes"])
        if len(want["gt_boxes2d"]) > len(scene["gt_boxes2d"]):
            assert (want["images"] != scene["images"]).any()
    assert pasted > 3
