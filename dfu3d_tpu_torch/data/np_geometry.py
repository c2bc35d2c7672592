"""Host-side (numpy) geometry for the data pipeline and the KITTI evaluator.

Own copy of dfu3d_tpu/data/np_geometry.py. The host data pipeline
(augmentation, gt-sampling collision tests, info generation) and the KITTI
AP's rotated overlaps need the device geometry's math in numpy: the same
Green's-theorem overlap as core/geometry/iou.py (kernel B1's function).
`tests/test_torch_port_data.py` holds it equal to the JAX package's copy.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-9
_TOL = 1e-6

_BEV_TEMPLATE = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], dtype=np.float32) / 2.0
_TEMPLATE_3D = (
    np.array(
        [
            [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
            [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        ],
        dtype=np.float32,
    )
    / 2.0
)


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7|5) → (N, 4, 2) CCW BEV corners."""
    if boxes.shape[-1] >= 7:
        ctr, dims, ang = boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6]
    else:
        ctr, dims, ang = boxes[:, 0:2], boxes[:, 2:4], boxes[:, 4]
    corners = dims[:, None, :] * _BEV_TEMPLATE[None]
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x, y = corners[..., 0], corners[..., 1]
    return np.stack([x * c - y * s, x * s + y * c], axis=-1) + ctr[:, None, :]


def boxes_to_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7+) → (N, 8, 3), reference corner ordering."""
    corners = boxes[:, None, 3:6] * _TEMPLATE_3D[None]
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    x, y = corners[..., 0], corners[..., 1]
    rot = np.stack([x * c - y * s, x * s + y * c, corners[..., 2]], axis=-1)
    return rot + boxes[:, None, 0:3]


def _edge_contributions(poly_p, poly_q, boundary_shift):
    p = poly_p
    q = np.roll(poly_p, -1, axis=-2)
    e1 = poly_q
    e2 = np.roll(poly_q, -1, axis=-2)
    d = e2 - e1
    inv_len = 1.0 / np.sqrt(np.maximum(d[..., 0] ** 2 + d[..., 1] ** 2, _EPS))

    def sides(pts):
        rel_x = pts[..., :, None, 0] - e1[..., None, :, 0]
        rel_y = pts[..., :, None, 1] - e1[..., None, :, 1]
        s = d[..., None, :, 0] * rel_y - d[..., None, :, 1] * rel_x
        return s * inv_len[..., None, :] + boundary_shift

    sp, sq = sides(p), sides(q)
    den = sp - sq
    den = np.where(np.abs(den) < _EPS, _EPS, den)
    t_cross = sp / den
    p_in, q_in = sp >= 0.0, sq >= 0.0
    t_lo_k = np.where(~p_in & q_in, t_cross, 0.0)
    t_hi_k = np.where(p_in & ~q_in, t_cross, 1.0)
    empty_k = ~p_in & ~q_in
    t_lo = np.max(np.where(empty_k, 1.0, t_lo_k), axis=-1)
    t_hi = np.min(np.where(empty_k, 0.0, t_hi_k), axis=-1)
    live = t_hi > t_lo
    seg = q - p
    px = p[..., 0] + seg[..., 0] * t_lo
    py = p[..., 1] + seg[..., 1] * t_lo
    qx = p[..., 0] + seg[..., 0] * t_hi
    qy = p[..., 1] + seg[..., 1] * t_hi
    contrib = 0.5 * (px * qy - qx * py)
    return np.sum(np.where(live, contrib, 0.0), axis=-1)


def pairwise_overlap_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7|5) × (M, 7|5) → (N, M) rotated BEV intersection area."""
    ca = boxes_to_corners_bev(boxes_a)[:, None]
    cb = boxes_to_corners_bev(boxes_b)[None, :]
    mid = (np.mean(ca, axis=-2, keepdims=True) + np.mean(cb, axis=-2, keepdims=True)) * 0.5
    ca = ca - mid
    cb = cb - mid
    area = _edge_contributions(ca, cb, +_TOL) + _edge_contributions(cb, ca, -_TOL)
    return np.maximum(area, 0.0)


def pairwise_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    inter = pairwise_overlap_bev(boxes_a, boxes_b)
    if boxes_a.shape[-1] >= 7:
        area_a, area_b = boxes_a[:, 3] * boxes_a[:, 4], boxes_b[:, 3] * boxes_b[:, 4]
    else:
        area_a, area_b = boxes_a[:, 2] * boxes_a[:, 3], boxes_b[:, 2] * boxes_b[:, 3]
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-6, None)


def points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+) × (M, 7) → (N, M) bool."""
    shifted = points[:, None, :3] - boxes[None, :, 0:3]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = shifted[..., 0] * c[None] - shifted[..., 1] * s[None]
    ly = shifted[..., 0] * s[None] + shifted[..., 1] * c[None]
    lz = shifted[..., 2]
    half = boxes[:, 3:6] * 0.5
    return (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(lz) <= half[None, :, 2])
    )


def remove_points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0 or len(points) == 0:
        return points
    inside = points_in_boxes(points, boxes).any(axis=1)
    return points[~inside]


def mask_boxes_outside_range(boxes, limit_range):
    lim = np.asarray(limit_range)
    c = boxes[:, 0:3]
    return np.all((c >= lim[0:3]) & (c <= lim[3:6]), axis=-1)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period
