"""Rotated BEV / 3D IoU (port of dfu3d_tpu/core/geometry/iou.py).

The intersection area runs through `iou_kernel.overlap_bev`: the CUDA kernel
for tensors on the card, its plain twin for tensors on the CPU. The z overlap
and the divides stay plain PyTorch around it. Every pairwise function takes
either (N, 7|5) × (M, 7|5) boxes or a batch of problems (G, N, 7|5) ×
(G, M, 7|5). `aligned_iou3d` pairs box i with box i: plain PyTorch on any
device, as the JAX package computes it in XLA and not in its kernel.
"""
from __future__ import annotations

import torch

from . import iou_kernel
from .boxes import boxes_to_corners_bev


def pairwise_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV intersection area: (…, N, 7|5) × (…, M, 7|5) → (…, N, M)."""
    single = boxes_a.dim() == 2
    if single:
        boxes_a, boxes_b = boxes_a[None], boxes_b[None]
    ca = boxes_to_corners_bev(boxes_a.float()).contiguous()
    cb = boxes_to_corners_bev(boxes_b.float()).contiguous()
    out = iou_kernel.overlap_bev(ca, cb)
    return out[0] if single else out


def _bev_area(boxes):
    if boxes.shape[-1] >= 7:
        return boxes[..., 3] * boxes[..., 4]
    return boxes[..., 2] * boxes[..., 3]


def pairwise_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU: (…, N, 7|5) × (…, M, 7|5) → (…, N, M)."""
    inter = pairwise_overlap_bev(boxes_a, boxes_b)
    area_a = _bev_area(boxes_a)
    area_b = _bev_area(boxes_b)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-6)


def pairwise_iou3d(boxes_a, boxes_b):
    """3D IoU of lidar boxes: BEV polygon overlap × z-interval overlap,
    (…, N, 7) × (…, M, 7) → (…, N, M)."""
    inter_bev = pairwise_overlap_bev(boxes_a, boxes_b)
    za_min = boxes_a[..., 2] - boxes_a[..., 5] / 2.0
    za_max = boxes_a[..., 2] + boxes_a[..., 5] / 2.0
    zb_min = boxes_b[..., 2] - boxes_b[..., 5] / 2.0
    zb_max = boxes_b[..., 2] + boxes_b[..., 5] / 2.0
    overlap_h = torch.clamp(
        torch.minimum(za_max[..., :, None], zb_max[..., None, :])
        - torch.maximum(za_min[..., :, None], zb_min[..., None, :]),
        min=0.0,
    )
    inter = inter_bev * overlap_h
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return inter / torch.clamp(vol_a[..., :, None] + vol_b[..., None, :] - inter, min=1e-6)


def aligned_iou3d(boxes_a, boxes_b):
    """Element-wise 3D IoU of two equal-length box sets, (N, 7) × (N, 7) →
    (N,), in the JAX package's order of operations (iou.py:154-170;
    reference paired_boxes_iou3d_gpu): the BEV intersection of each pair
    from `iou_kernel._quad_intersection_area`, the plain twin's clip, times
    the z overlap."""
    inter_bev = iou_kernel._quad_intersection_area(boxes_to_corners_bev(boxes_a),
                                                   boxes_to_corners_bev(boxes_b))
    overlap_h = torch.clamp(
        torch.minimum(boxes_a[:, 2] + boxes_a[:, 5] / 2, boxes_b[:, 2] + boxes_b[:, 5] / 2)
        - torch.maximum(boxes_a[:, 2] - boxes_a[:, 5] / 2, boxes_b[:, 2] - boxes_b[:, 5] / 2),
        min=0.0)
    inter = inter_bev * overlap_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-6)
