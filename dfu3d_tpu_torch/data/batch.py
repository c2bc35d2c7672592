"""Fixed-shape, mask-padded batches (dfu3d_tpu/data/dataset.py PointBatch and
MultimodalBatch) and the synthetic workload the benchmarks use."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PointBatch(NamedTuple):
    points: torch.Tensor        # (B, N_max, C) fp32
    points_valid: torch.Tensor  # (B, N_max) bool
    gt_boxes: torch.Tensor      # (B, M_max, 7 [+ 2 velocity] + 1) fp32; 1-based class id last
    gt_valid: torch.Tensor      # (B, M_max) bool

    def to(self, device) -> "PointBatch":
        return PointBatch(*(t.to(device, non_blocking=True) for t in self))

    @classmethod
    def from_numpy(cls, points, points_valid, gt_boxes, gt_valid) -> "PointBatch":
        return cls(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (points, points_valid, gt_boxes, gt_valid)))


class MultimodalBatch(NamedTuple):
    """Camera (+ LiDAR) batch of the camera detectors (BevFusion, CaDDN, the
    focal Voxel R-CNN with USE_IMG): a PointBatch's four fields, then the
    cameras'. N_cam is 1 for KITTI's front camera, 6 for nuScenes' ring."""

    points: torch.Tensor           # (B, N_max, C) fp32
    points_valid: torch.Tensor     # (B, N_max) bool
    gt_boxes: torch.Tensor         # (B, M_max, 8 or 10) fp32; 1-based class id last
    gt_valid: torch.Tensor         # (B, M_max) bool
    images: torch.Tensor           # (B, N_cam, H, W, 3) fp32, normalised
    cam_intrinsics: torch.Tensor   # (B, N_cam, 3, 3)
    cam2lidar_rots: torch.Tensor   # (B, N_cam, 3, 3)
    cam2lidar_trans: torch.Tensor  # (B, N_cam, 3)
    lidar_to_cam: torch.Tensor     # (B, N_cam, 4, 4)
    cam_to_img: torch.Tensor       # (B, N_cam, 3, 4)
    depth_maps: torch.Tensor       # (B, N_cam, H, W) projected LiDAR depth, 0 where none

    def to(self, device) -> "MultimodalBatch":
        return MultimodalBatch(*(t.to(device, non_blocking=True) for t in self))

    @classmethod
    def from_numpy(cls, *arrays) -> "MultimodalBatch":
        return cls(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def synthetic_batch(b: int, n: int, m: int, extent: float, seed: int = 0,
                    velocity: bool = False) -> PointBatch:
    """Uniform points and random gt boxes; the same numpy draws as
    `__graft_entry__._synthetic_batch` (which always uses seed 0). The first
    16 gt slots of each sample are valid. With `velocity` the boxes have 10
    columns, (vx, vy) in [-5, 5] m/s before the class id, drawn after every
    other draw so that the 8-column batch of the same seed is unchanged."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0, extent, (b, n))
    pts[..., 1] = rng.uniform(-extent, extent, (b, n))
    pts[..., 2] = rng.uniform(-4, 2, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    gt = np.zeros((b, m, 8), np.float32)
    gt[..., 0] = rng.uniform(1, extent - 1, (b, m))
    gt[..., 1] = rng.uniform(-extent + 1, extent - 1, (b, m))
    gt[..., 2] = rng.uniform(-2, 0, (b, m))
    gt[..., 3:6] = rng.uniform(0.5, 5, (b, m, 3))
    gt[..., 6] = rng.uniform(-3, 3, (b, m))
    gt[..., 7] = rng.randint(1, 11, (b, m))
    gt_valid = np.zeros((b, m), bool)
    gt_valid[:, :16] = True
    if velocity:
        gt = np.concatenate([gt[..., :7], rng.uniform(-5, 5, (b, m, 2)).astype(np.float32),
                             gt[..., 7:]], axis=-1)
    return PointBatch.from_numpy(pts, np.ones((b, n), bool), gt, gt_valid)
