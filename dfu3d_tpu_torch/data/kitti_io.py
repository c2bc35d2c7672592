"""KITTI-format file IO: label txt parser/writer, velodyne bins, image shapes.

Own copy of dfu3d_tpu/data/kitti_io.py. Format parity with the reference
(pcdet/utils/object3d_kitti.py and kitti_dataset.py:339-419's prediction
writer): these files are the interchange contract with the reference
ecosystem (pseudo-labels, predictions, gt). Image shapes come from the PNG
header, so reading them needs no imaging library.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def cls_type_to_id(cls_type: str, classes=("Car", "Pedestrian", "Cyclist", "Van")) -> int:
    if cls_type not in classes:
        return -1
    return classes.index(cls_type) + 1


class Object3d:
    """One KITTI label line (reference: object3d_kitti.Object3d)."""

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.truncation = float(label[1])
        self.occlusion = float(label[2])  # 0..3 (3 = unknown)
        self.alpha = float(label[3])
        self.box2d = np.array(
            (float(label[4]), float(label[5]), float(label[6]), float(label[7])),
            dtype=np.float32,
        )
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array(
            (float(label[11]), float(label[12]), float(label[13])), dtype=np.float32
        )
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self) -> int:
        """KITTI difficulty from 2D height / occlusion / truncation."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 2
        self.level_str = "UnKnown"
        return -1


def get_objects_from_label(label_file) -> list:
    with open(label_file, "r") as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    return [Object3d(line) for line in lines]


def read_velodyne_bin(path, num_features: int = 4) -> np.ndarray:
    return np.fromfile(str(path), dtype=np.float32).reshape(-1, num_features)


def read_velodyne_depth_npy(path) -> np.ndarray:
    """Fused/densified cloud written by the pseudo-box factory: (N, 8) fp16."""
    return np.load(str(path)).astype(np.float32)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def get_image_shape(img_path) -> np.ndarray:
    """[h, w] of a PNG, read from its IHDR chunk: the signature (8 bytes),
    the chunk's length and type (8), then width and height as big-endian
    uint32 at bytes 16-23."""
    with open(img_path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{img_path} is not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], dtype=np.int32)


def format_kitti_label_line(name, alpha, bbox, dims_lhw, loc, ry, score=None) -> str:
    """One KITTI label/prediction line. dims printed as h, w, l (KITTI order);
    truncated/occluded fixed at -1 for predictions (kitti_dataset.py:404-417)."""
    l, h, w = dims_lhw
    parts = [
        name, "-1", "-1", f"{alpha:.4f}",
        f"{bbox[0]:.4f}", f"{bbox[1]:.4f}", f"{bbox[2]:.4f}", f"{bbox[3]:.4f}",
        f"{h:.4f}", f"{w:.4f}", f"{l:.4f}",
        f"{loc[0]:.4f}", f"{loc[1]:.4f}", f"{loc[2]:.4f}", f"{ry:.4f}",
    ]
    if score is not None:
        parts.append(f"{score:.4f}")
    return " ".join(parts)


def write_kitti_label_file(path, annos_dict):
    """Write a frame's predictions in KITTI format (same column layout as the
    reference's generate_prediction_dicts --save_to_file path)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    n = len(annos_dict["name"])
    for k in range(n):
        lines.append(
            format_kitti_label_line(
                annos_dict["name"][k],
                annos_dict["alpha"][k],
                annos_dict["bbox"][k],
                annos_dict["dimensions"][k],
                annos_dict["location"][k],
                annos_dict["rotation_y"][k],
                annos_dict["score"][k] if "score" in annos_dict else None,
            )
        )
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
