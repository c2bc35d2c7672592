"""Box geometry of the serving and training paths (port of
dfu3d_tpu/core/geometry/boxes.py).

LiDAR box: [x, y, z, dx, dy, dz, heading], (x, y, z) the 3D centre, heading
around +z with x→y positive. Every function takes any leading batch dims.
"""
from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (..., N, 3 + C) rotated by angle (...,) around +z; extra
    channels pass through. Elementwise, as the JAX version."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    rx = x * c - y * s
    ry = x * s + y * c
    return torch.cat([rx[..., None], ry[..., None], points[..., 2:]], dim=-1)


# the reference's corner order (pcdet/utils/box_utils.py:44-46), times 1/2:
#         7 -------- 4
#        /|         /|
#       6 -------- 5 .
#       | |        | |
#       . 3 -------- 0
#       |/         |/
#       2 -------- 1
CORNER_TEMPLATE_3D = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
                      (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def boxes_to_corners_3d(boxes):
    """(..., 7+) lidar boxes → (..., 8, 3) corners in the reference's order."""
    template = torch.tensor(CORNER_TEMPLATE_3D, dtype=boxes.dtype, device=boxes.device) / 2.0
    corners = boxes[..., None, 3:6] * template
    corners = rotate_points_along_z(corners, boxes[..., 6])
    return corners + boxes[..., None, 0:3]


def boxes_to_corners_bev(boxes):
    """(..., 7) lidar boxes, or (..., 5) [x, y, dx, dy, angle] → (..., 4, 2)
    CCW BEV corners."""
    if boxes.shape[-1] >= 7:
        ctr, dims, ang = boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6]
    else:
        ctr, dims, ang = boxes[..., 0:2], boxes[..., 2:4], boxes[..., 4]
    # the CCW template [[1,-1],[1,1],[-1,1],[-1,-1]] / 2 times dims, exactly
    hx, hy = dims[..., 0] * 0.5, dims[..., 1] * 0.5
    x = torch.stack([hx, hx, -hx, -hx], dim=-1)
    y = torch.stack([-hy, hy, hy, -hy], dim=-1)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    corners = torch.stack([x * c - y * s, x * s + y * c], dim=-1)
    return corners + ctr[..., None, :]


def points_in_boxes(points, boxes):
    """Point-in-rotated-box tests: points (..., N, 3+), boxes (..., M, 7) →
    (..., N, M) bool, point n inside box m (boundary included). The same
    elementwise operations as the JAX version, boxes.py:108-127."""
    shifted = points[..., :, None, :3] - boxes[..., None, :, 0:3]  # (..., N, M, 3)
    c = torch.cos(-boxes[..., 6])[..., None, :]
    s = torch.sin(-boxes[..., 6])[..., None, :]
    local_x = shifted[..., 0] * c - shifted[..., 1] * s
    local_y = shifted[..., 0] * s + shifted[..., 1] * c
    local_z = shifted[..., 2]
    half = (boxes[..., 3:6] * 0.5)[..., None, :, :]  # (..., 1, M, 3)
    return ((local_x.abs() <= half[..., 0]) & (local_y.abs() <= half[..., 1])
            & (local_z.abs() <= half[..., 2]))


def enlarge_box3d(boxes, extra_width=(0.0, 0.0, 0.0)):
    """Grow dx, dy, dz of (..., 7+) boxes by `extra_width` (the JAX version,
    boxes.py:130-133)."""
    extra = torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([boxes[..., :3], boxes[..., 3:6] + extra, boxes[..., 6:]], dim=-1)
