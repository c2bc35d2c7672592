"""Ordered data-processor queue (own copy of dfu3d_tpu/data/processor.py,
LiDAR processors; reference: processor/data_processor.py).

Voxelization happens on the device inside the model (core/voxel), so both
voxel processor names only record the grid geometry and the voxel cap (the
reference's own "placeholder" path for dynamic VFEs, data_processor.py:107-131),
and the collate step pads points to a static cap instead. The image
processors (`downsample_depth_map`, `image_normalization` alias
`image_normalize`, `image_calibrate`) are the JAX package's host numpy
(processor.py:135-219).
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np

from . import np_geometry as npg

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

    def downsample_depth_map(self, data_dict=None, config=None):
        """Block-mean depth downsample by DOWNSAMPLE_FACTOR (reference
        data_processor.py:224-233; skimage downscale_local_mean: the map
        padded with zeros at its bottom and right edges to a multiple of
        the factor, then each block's mean)."""
        if data_dict is None:
            self.depth_downsample_factor = int(config.DOWNSAMPLE_FACTOR)
            return partial(self.downsample_depth_map, config=config)
        dm = np.asarray(data_dict.get("depth_maps"))
        if dm is None or dm.size == 0:
            return data_dict
        f = self.depth_downsample_factor
        h, w = dm.shape[:2]
        ph, pw = (-h) % f, (-w) % f
        if ph or pw:
            dm = np.pad(dm, ((0, ph), (0, pw)), mode="constant")
        hh, ww = dm.shape[0] // f, dm.shape[1] // f
        data_dict["depth_maps"] = dm.reshape(hh, f, ww, f).mean(axis=(1, 3))
        return data_dict

    def image_normalization(self, data_dict=None, config=None):
        """Per-channel (image - mean) / std of "images" or "camera_imgs" (one
        image or a list; uint8 first scaled to [0, 1]), in float32
        (reference image_normalize, data_processor.py:235-247)."""
        if data_dict is None:
            return partial(self.image_normalization, config=config)
        mean = np.asarray(config.mean, np.float32)
        std = np.asarray(config.std, np.float32)
        for key in ("images", "camera_imgs"):
            if data_dict.get(key) is None:
                continue
            imgs = data_dict[key]
            single = not isinstance(imgs, (list, tuple))
            out = []
            for img in [imgs] if single else imgs:
                img = np.asarray(img)
                if img.dtype == np.uint8:
                    img = img.astype(np.float32) / 255.0
                out.append((img.astype(np.float32) - mean) / std)
            data_dict[key] = out[0] if single else out
        return data_dict

    # the reference's spelling (the BEVFusion dataset configs use image_normalize)
    image_normalize = image_normalization

    def image_calibrate(self, data_dict=None, config=None):
        """The recorded image augmentations (resize, crop, flip, rotate per
        camera, "img_process_infos") folded into 4×4 post-homographies
        "img_aug_matrix" (reference data_processor.py:249-283); identities
        when none were recorded."""
        if data_dict is None:
            return partial(self.image_calibrate, config=config)
        infos = data_dict.get("img_process_infos")
        if not infos:
            n = len(data_dict.get("camera_imgs", data_dict.get("images", [])) or [1])
            data_dict["img_aug_matrix"] = [np.eye(4, dtype=np.float32)] * n
            return data_dict
        transforms = []
        for resize, crop, flip, rotate in infos:
            rotation = np.eye(2, dtype=np.float32) * resize
            translation = -np.asarray(crop[:2], np.float32)
            if flip:
                a = np.array([[-1, 0], [0, 1]], np.float32)
                rotation = a @ rotation
                translation = a @ translation + np.array([crop[2] - crop[0], 0], np.float32)
            theta = rotate / 180.0 * np.pi
            a = np.array([[np.cos(theta), np.sin(theta)],
                          [-np.sin(theta), np.cos(theta)]], np.float32)
            b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2.0
            b = a @ (-b) + b
            rotation = a @ rotation
            translation = a @ translation + b
            t = np.eye(4, dtype=np.float32)
            t[:2, :2] = rotation
            t[:2, 3] = translation
            transforms.append(t)
        data_dict["img_aug_matrix"] = transforms
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
