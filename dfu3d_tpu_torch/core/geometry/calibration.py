"""KITTI calibration, host side (own numpy copy of the parser and the
`Calibration` object of dfu3d_tpu/core/geometry/calibration.py, itself the
reference's pcdet/utils/calibration_kitti.py API).

The 4×4 homogeneous matrices are built as the JAX package builds them
(`CalibMatrices.from_arrays`) and applied elementwise (`_apply44`), so the
results equal the JAX package's bit for bit on the CPU. The functional
(`CalibMatrices`) forms serve the image branch and come with it.
"""
from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    """Parse a KITTI calib txt (line layout per calibration_kitti.py:4-21)."""
    with open(calib_file) as f:
        lines = f.readlines()
    vals = {}
    for line in lines:
        line = line.strip()
        if not line or ":" not in line and " " not in line:
            continue
        key, _, rest = line.partition(":" if ":" in line else " ")
        try:
            vals[key.strip()] = np.array(rest.strip().split(), dtype=np.float32)
        except ValueError:
            continue
    return {
        "P2": vals["P2"].reshape(3, 4),
        "P3": vals.get("P3", vals["P2"]).reshape(3, 4),
        "R0": vals["R0_rect"].reshape(3, 3) if "R0_rect" in vals else vals["R0"].reshape(3, 3),
        "Tr_velo2cam": (
            vals["Tr_velo_to_cam"] if "Tr_velo_to_cam" in vals else vals["Tr_velo2cam"]
        ).reshape(3, 4),
    }


def _homogeneous(mat3x4_or_3x3):
    out = np.eye(4, dtype=np.float32)
    m = np.asarray(mat3x4_or_3x3, dtype=np.float32)
    out[:3, : m.shape[1]] = m
    return out


def _apply44(mat, pts):
    """(4,4) or (3,4) matrix applied to (..., 3) points (implicit w=1) →
    (..., 3), elementwise: the same rounding as the JAX package's form."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return np.stack(
        [x * mat[i, 0] + y * mat[i, 1] + z * mat[i, 2] + mat[i, 3] for i in range(3)], axis=-1)


class Calibration:
    """Host-side calibration object with the reference's method names
    (pcdet/utils/calibration_kitti.py:24-127 API; numpy in and out)."""

    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) else get_calib_from_file(calib_file)
        self.P2 = np.asarray(calib["P2"], dtype=np.float32)
        self.R0 = np.asarray(calib["R0"], dtype=np.float32)
        self.V2C = np.asarray(calib["Tr_velo2cam"], dtype=np.float32)
        rect_from_lidar = _homogeneous(self.R0) @ _homogeneous(self.V2C)
        self.rect_from_lidar = rect_from_lidar.astype(np.float32)
        self.lidar_from_rect = np.linalg.inv(rect_from_lidar).astype(np.float32)
        # intrinsics for img → rect back-projection (calibration_kitti.py:34-40)
        fu, fv = self.P2[0, 0], self.P2[1, 1]
        self.cu, self.cv = np.float32(self.P2[0, 2]), np.float32(self.P2[1, 2])
        self.fu, self.fv = np.float32(fu), np.float32(fv)
        self.tx, self.ty = np.float32(self.P2[0, 3] / (-fu)), np.float32(self.P2[1, 3] / (-fv))

    def cart_to_hom(self, pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), dtype=np.float32)])

    def lidar_to_rect(self, pts_lidar):
        return _apply44(self.rect_from_lidar, pts_lidar.astype(np.float32))

    def rect_to_lidar(self, pts_rect):
        return _apply44(self.lidar_from_rect, pts_rect.astype(np.float32))

    def rect_to_img(self, pts_rect):
        """(N,3) rect points → ((N,2) pixel coords, (N,) depth in the rect
        frame: the projection's z minus P2's z offset, calibration_kitti.py:84)."""
        hom = _apply44(self.P2, pts_rect.astype(np.float32))
        return hom[:, 0:2] / hom[:, 2][:, None], hom[:, 2] - self.P2[2, 3]

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Pixel (u, v) + rect-frame depth → (N,3) rect points
        (calibration_kitti.py:99-108)."""
        u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
        depth_rect = np.asarray(depth_rect, np.float32)
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=-1)

    def corners3d_to_img_boxes(self, corners3d):
        """(N,8,3) rect corners → ((N,4) [x1,y1,x2,y2], (N,8,2) corner pixels)."""
        hom = _apply44(self.P2, corners3d.astype(np.float32))
        xy = hom[..., 0:2] / hom[..., 2:3]
        return np.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=-1), xy
