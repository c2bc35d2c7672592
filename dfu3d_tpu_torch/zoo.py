"""Builders for the port's other supported models: voxel CenterPoint and
PointRCNN.

`voxel_centerpoint` is voxel CenterPoint on the public OpenPCDet nuScenes
config tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml
(MeanVFE, VoxelResBackBone8x, 0.1 × 0.1 × 0.2 m voxels), built as the JAX
package's tools/test.py and tools/train.py build it: the grid from
POINT_CLOUD_RANGE and the last transform_points_to_voxels VOXEL_SIZE, the
voxel cap from MAX_NUMBER_OF_VOXELS['test'] (['train'] for training).
"""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np

from .core.voxel import VoxelGrid
from .models import build_network
from .utils.config import CfgDict, cfg_from_yaml_file

VOXEL_CFG = (Path(__file__).resolve().parents[1]
             / "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml")
# 12.8 m square, full height: a 128 x 128 x 40 grid at the config's voxels
VOXEL_TINY_RANGE = [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]


def voxel_centerpoint(tiny: bool = False, device="cuda", train: bool = False):
    """Returns (cfg, grid, model) at full widths, in train mode with `train`;
    `tiny` shrinks only the point-cloud range. The model's weights are
    PyTorch's defaults."""
    cfg = cfg_from_yaml_file(VOXEL_CFG, CfgDict())
    if tiny:
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(VOXEL_TINY_RANGE)
    voxel_cfg = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p.NAME.startswith("transform_points_to_voxels")][-1]
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, voxel_cfg.VOXEL_SIZE)
    max_voxels = voxel_cfg.MAX_NUMBER_OF_VOXELS
    if isinstance(max_voxels, dict):
        max_voxels = max_voxels["train" if train else "test"]
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=train,
                          max_voxels=int(max_voxels))
    return cfg, grid, model


POINTRCNN_CFG = (Path(__file__).resolve().parents[1]
                 / "tools/cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml")
POINTRCNN_BATCH_SIZE = 4  # the config's BATCH_SIZE_PER_GPU
POINTRCNN_SEED = 0


def pointrcnn(device="cuda"):
    """PointRCNN on DFU3D's second detector config
    tools/cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml at its published
    widths, for serving: returns (cfg, grid, model) in eval mode, with the
    grid of the config's voxel placeholder (the model reads no grid). The
    model's weights are PyTorch's defaults."""
    cfg = cfg_from_yaml_file(POINTRCNN_CFG, CfgDict())
    voxel_cfg = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p.NAME.startswith("transform_points_to_voxels")][-1]
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, voxel_cfg.VOXEL_SIZE)
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device)
    return cfg, grid, model


def pointrcnn_batches(cfg, root, info_file, num_batches: int):
    """`num_batches` PointBatches of POINTRCNN_BATCH_SIZE frames read from
    `root` through KittiDataset in test mode, the frames of `info_file` in
    order (repeated if there are fewer): the config's processors mask the
    range, sample 16,384 points (sample_points) and shuffle them. numpy's
    global generator, which those processors draw from, is seeded with
    POINTRCNN_SEED."""
    from .data.kitti_dataset import KittiDataset

    ds_cfg = copy.deepcopy(cfg.DATA_CONFIG)
    ds_cfg.DATA_PATH = str(root)
    ds_cfg.INFO_PATH = {"train": [], "test": [str(info_file)]}
    dataset = KittiDataset(ds_cfg, cfg.CLASS_NAMES, training=False, root_path=Path(root))
    np.random.seed(POINTRCNN_SEED)
    b = POINTRCNN_BATCH_SIZE
    frames = [dataset[i % len(dataset)] for i in range(num_batches * b)]
    return [dataset.collate_batch(frames[i:i + b])[0] for i in range(0, len(frames), b)]


def write_pointrcnn_root(cfg, root, num_frames: int):
    """A synthetic KITTI-format root of `num_frames` frames in the val split
    (data.kitti_synthetic at its defaults: 40,000-60,000 points in the
    camera frustum, 20-40 boxes of the config's classes, seed
    POINTRCNN_SEED) and its info file; returns the info file's path."""
    from .data import kitti_synthetic
    from .data.kitti_dataset import create_kitti_infos

    kitti_synthetic.write_root(root, 0, num_frames, cfg.CLASS_NAMES, seed=POINTRCNN_SEED)
    (info,) = create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, splits=("val",))
    return info
