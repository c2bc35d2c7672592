"""Builders for the port's other supported models.

`voxel_centerpoint` is voxel CenterPoint on the public OpenPCDet nuScenes
config tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml
(MeanVFE, VoxelResBackBone8x, 0.1 × 0.1 × 0.2 m voxels), built as the JAX
package's tools/test.py and tools/train.py build it: the grid from
POINT_CLOUD_RANGE and the last transform_points_to_voxels VOXEL_SIZE, the
voxel cap from MAX_NUMBER_OF_VOXELS['test'] (['train'] for training).
"""
from __future__ import annotations

from pathlib import Path

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
