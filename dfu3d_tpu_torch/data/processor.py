"""Ordered data-processor queue (own copy of dfu3d_tpu/data/processor.py,
LiDAR processors; reference: processor/data_processor.py).

Voxelization happens on the device inside the model (core/voxel), so both
voxel processor names only record the grid geometry and the voxel cap (the
reference's own "placeholder" path for dynamic VFEs, data_processor.py:107-131),
and the collate step pads points to a static cap instead. The image
processors come with the image branch; a config that names one raises.
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np

from . import np_geometry as npg

_IMAGE_PROCESSORS = ("downsample_depth_map", "image_normalization", "image_normalize",
                     "image_calibrate")


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training, num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.max_voxels = None
        self._occupancy_checked = 0
        self._occupancy_warned = False
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            if cur_cfg.NAME in _IMAGE_PROCESSORS:
                raise NotImplementedError(
                    f"data processor {cur_cfg.NAME} needs the image branch, which is not "
                    "ported yet (ROADMAP Queue A item 6: models/image/*)")
            self.data_processor_queue.append(getattr(self, cur_cfg.NAME)(config=cur_cfg))

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get("points", None) is not None:
            pts = data_dict["points"]
            mask = np.all(
                (pts[:, 0:3] >= self.point_cloud_range[0:3])
                & (pts[:, 0:3] <= self.point_cloud_range[3:6]),
                axis=1,
            )
            data_dict["points"] = pts[mask]
        if (
            data_dict.get("gt_boxes", None) is not None
            and config.REMOVE_OUTSIDE_BOXES
            and self.training
            and len(data_dict["gt_boxes"])
        ):
            keep = npg.mask_boxes_outside_range(data_dict["gt_boxes"], self.point_cloud_range)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][keep]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            points = data_dict["points"]
            perm = np.random.permutation(points.shape[0])
            data_dict["points"] = points[perm]
        return data_dict

    def _record_grid(self, config):
        voxel_size = config.VOXEL_SIZE
        grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / np.array(
            voxel_size
        )
        self.grid_size = np.round(grid_size).astype(np.int64)
        self.voxel_size = voxel_size

    def _check_voxel_occupancy(self, data_dict):
        """Sampled guard against a silently-truncating voxel cap.

        The on-device voxelizer keeps the first MAX_NUMBER_OF_VOXELS
        first-seen cells and drops the rest: an undersized cap removes part
        of every scene without any error. Check the first few frames on the
        host (a numpy unique) and warn once.
        """
        if self.max_voxels is None or self._occupancy_checked >= 8:
            return
        self._occupancy_checked += 1
        pts = data_dict.get("points")
        if pts is None or len(pts) == 0:
            return
        pcr = self.point_cloud_range
        vs = np.asarray(self.voxel_size)
        ijk = np.floor((pts[:, :3] - pcr[:3]) / vs).astype(np.int64)
        ok = np.all((ijk >= 0) & (ijk < self.grid_size), axis=1)
        ijk = ijk[ok]
        lin = (ijk[:, 2] * self.grid_size[1] + ijk[:, 1]) * self.grid_size[0] + ijk[:, 0]
        n_unique = len(np.unique(lin))
        if n_unique > self.max_voxels and not self._occupancy_warned:
            self._occupancy_warned = True
            logging.getLogger("dfu3d_tpu_torch").warning(
                "MAX_NUMBER_OF_VOXELS=%d but a sampled frame occupies %d "
                "cells — the voxelizer will silently drop the overflow "
                "(first-seen cells win). Raise the cap above the scene "
                "occupancy.", self.max_voxels, n_unique,
            )

    def transform_points_to_voxels_placeholder(self, data_dict=None, config=None):
        if data_dict is None:
            self._record_grid(config)
            mv = config.get("MAX_NUMBER_OF_VOXELS", None)
            if mv is not None:
                self.max_voxels = int(mv[self.mode] if hasattr(mv, "get") else mv)
            return partial(self.transform_points_to_voxels_placeholder, config=config)
        self._check_voxel_occupancy(data_dict)
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        # on-device voxelization: record geometry + capacity only (see module doc)
        if data_dict is None:
            self._record_grid(config)
            self.max_voxels = config.MAX_NUMBER_OF_VOXELS[self.mode]
            self.max_points_per_voxel = config.get("MAX_POINTS_PER_VOXEL", 1)
            # DOUBLE_FLIP test-time augmentation lives in the model; the flag
            # is recorded for config parity
            self.double_flip = bool(config.get("DOUBLE_FLIP", False)) and (
                self.mode == "test"
            )
            return partial(self.transform_points_to_voxels, config=config)
        self._check_voxel_occupancy(data_dict)
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None):
        """Record grid geometry only (reference data_processor.py:216-222)."""
        if data_dict is None:
            self._record_grid(config)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config.NUM_POINTS[self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict["points"]
        if num_points < len(points):
            # match reference bias: keep near points preferentially (:182-216)
            depth = np.linalg.norm(points[:, 0:3], axis=1)
            far_mask = depth >= 40.0
            far_idx = np.where(far_mask)[0]
            near_idx = np.where(~far_mask)[0]
            if num_points > len(far_idx):
                near_choice = np.random.choice(
                    near_idx, num_points - len(far_idx), replace=False
                )
                choice = np.concatenate([near_choice, far_idx])
            else:
                choice = np.random.choice(np.arange(len(points)), num_points, replace=False)
            np.random.shuffle(choice)
            data_dict["points"] = points[choice]
        elif num_points > len(points):
            extra = np.random.choice(len(points), num_points - len(points), replace=True)
            data_dict["points"] = np.concatenate([points, points[extra]], axis=0)
        return data_dict

    def forward(self, data_dict):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict)
        return data_dict
