"""Devkit-free nuScenes database access (own copy of
dfu3d_tpu/data/nuscenes_tables.py; numpy and the standard library only).

Loads the raw JSON tables (sample, sample_data, calibrated_sensor, ego_pose,
scene, log, sample_annotation, category, sensor) and provides the geometry
the nuScenes -> KITTI converter needs (quaternions, frame transforms, 3D
boxes), in place of the reference's `nuscenes` devkit and `pyquaternion`
(tools/nuscenes2kitti.py:1-16 of the reference).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


class Quaternion:
    """Minimal unit quaternion (w, x, y, z)."""

    def __init__(self, wxyz=None, axis=None, angle=None, matrix=None):
        if wxyz is not None:
            self.q = np.asarray(wxyz, dtype=np.float64)
        elif axis is not None:
            axis = np.asarray(axis, dtype=np.float64)
            axis = axis / np.linalg.norm(axis)
            half = angle / 2.0
            self.q = np.concatenate([[np.cos(half)], axis * np.sin(half)])
        elif matrix is not None:
            self.q = self._from_matrix(np.asarray(matrix, dtype=np.float64))
        else:
            self.q = np.array([1.0, 0, 0, 0])
        n = np.linalg.norm(self.q)
        if n > 0:
            self.q = self.q / n

    @staticmethod
    def _from_matrix(m):
        t = np.trace(m)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            return np.array(
                [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                 (m[1, 0] - m[0, 1]) / s]
            )
        i = int(np.argmax(np.diag(m)))
        if i == 0:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            return np.array(
                [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                 (m[0, 2] + m[2, 0]) / s]
            )
        if i == 1:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            return np.array(
                [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                 (m[1, 2] + m[2, 1]) / s]
            )
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        return np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    @property
    def inverse(self):
        return Quaternion(wxyz=[self.q[0], -self.q[1], -self.q[2], -self.q[3]])

    def __mul__(self, other: "Quaternion"):
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(
            wxyz=[
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ]
        )

    def rotate_vec(self, v):
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    @property
    def yaw_pitch_roll(self):
        w, x, y, z = self.q
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        return yaw, pitch, roll


def transform_matrix(translation, rotation: Quaternion, inverse=False):
    """4x4 homogeneous transform (devkit geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    if inverse:
        rot_inv = rotation.rotation_matrix.T
        tm[:3, :3] = rot_inv
        tm[:3, 3] = rot_inv @ (-np.asarray(translation, dtype=np.float64))
    else:
        tm[:3, :3] = rotation.rotation_matrix
        tm[:3, 3] = np.asarray(translation, dtype=np.float64)
    return tm


class Box:
    """3D box: center (3,), wlh (w, l, h), orientation quaternion, velocity
    (3,) — rotate() carries the velocity vector along, devkit Box semantics."""

    def __init__(self, center, wlh, orientation: Quaternion, velocity=None):
        self.center = np.asarray(center, dtype=np.float64)
        self.wlh = np.asarray(wlh, dtype=np.float64)
        self.orientation = orientation
        self.velocity = (np.full(3, np.nan) if velocity is None
                         else np.asarray(velocity, dtype=np.float64))

    def copy(self):
        return Box(self.center.copy(), self.wlh.copy(),
                   Quaternion(wxyz=self.orientation.q.copy()),
                   self.velocity.copy())

    def rotate(self, q: Quaternion):
        self.center = q.rotation_matrix @ self.center
        self.orientation = q * self.orientation
        self.velocity = q.rotation_matrix @ self.velocity

    def translate(self, t):
        self.center = self.center + np.asarray(t, dtype=np.float64)

    @property
    def rotation_matrix(self):
        return self.orientation.rotation_matrix

    def corners(self):
        """(3, 8) corners, devkit ordering (x fwd = l, y left = w, z up = h)."""
        w, l, h = self.wlh
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = np.stack([x, y, z])
        return self.rotation_matrix @ corners + self.center[:, None]


# nuScenes category → detection-challenge name (devkit
# eval.detection.utils.category_to_detection_name)
_DETECTION_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def category_to_detection_name(category_name: str) -> Optional[str]:
    return _DETECTION_MAPPING.get(category_name)


class NuScenesTables:
    """Raw-JSON nuScenes database with token-indexed lookup."""

    TABLE_NAMES = [
        "sample", "sample_data", "calibrated_sensor", "ego_pose", "scene",
        "log", "sample_annotation", "category", "sensor",
    ]

    def __init__(self, dataroot, version="v1.0-trainval"):
        self.dataroot = Path(dataroot)
        self.version = version
        table_dir = self.dataroot / version
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in self.TABLE_NAMES:
            path = table_dir / f"{name}.json"
            rows = json.loads(path.read_text()) if path.exists() else []
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    @property
    def sample(self):
        return self._tables["sample"]

    def sample_annotations_of(self, sample_token: str):
        return [
            a for a in self._tables["sample_annotation"]
            if a["sample_token"] == sample_token
        ]

    def sample_data_token(self, sample: dict, channel: str) -> str:
        """Resolve sample['data'][channel]; raw tables don't materialize the
        'data' map, so fall back to scanning sample_data."""
        if "data" in sample and channel in sample["data"]:
            return sample["data"][channel]
        for sd in self._tables["sample_data"]:
            if sd["sample_token"] != sample["token"] or not sd.get("is_key_frame", True):
                continue
            cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
            sensor = self.get("sensor", cs["sensor_token"])
            if sensor["channel"] == channel:
                return sd["token"]
        raise KeyError(f"{channel} not found for sample {sample['token']}")

    def box_velocity(self, ann: dict, max_time_diff: float = 1.5):
        """Global-frame velocity (3,) m/s of an annotation via the central
        difference of its prev/next annotation positions (devkit
        NuScenes.box_velocity semantics: one-sided at track ends, nan when
        isolated or when the sampling gap exceeds max_time_diff)."""
        has_prev = bool(ann.get("prev"))
        has_next = bool(ann.get("next"))
        if not has_prev and not has_next:
            return np.full(3, np.nan)
        first = (self.get("sample_annotation", ann["prev"])
                 if has_prev else ann)
        last = (self.get("sample_annotation", ann["next"])
                if has_next else ann)
        pos_diff = (np.asarray(last["translation"], np.float64)
                    - np.asarray(first["translation"], np.float64))
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        time_diff = t_last - t_first
        if time_diff > max_time_diff or time_diff <= 0:
            return np.full(3, np.nan)
        return pos_diff / time_diff

    def box_in_lidar_frame(self, ann: dict, lidar_sd: dict) -> Box:
        """Global-frame annotation → Box in the nuScenes lidar frame
        (devkit get_sample_data semantics; the velocity vector is rotated
        along, nuscenes_utils.get_sample_data:218-227)."""
        cs = self.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        pose = self.get("ego_pose", lidar_sd["ego_pose_token"])
        box = Box(
            ann["translation"], ann["size"], Quaternion(wxyz=ann["rotation"]),
            velocity=self.box_velocity(ann),
        )
        # global → ego
        box.translate(-np.asarray(pose["translation"]))
        box.rotate(Quaternion(wxyz=pose["rotation"]).inverse)
        # ego → sensor
        box.translate(-np.asarray(cs["translation"]))
        box.rotate(Quaternion(wxyz=cs["rotation"]).inverse)
        return box


def read_nuscenes_lidar(path) -> np.ndarray:
    """.pcd.bin → (N, 4) [x, y, z, intensity] (drops the ring index)."""
    raw = np.fromfile(str(path), dtype=np.float32).reshape(-1, 5)
    return raw[:, :4]
