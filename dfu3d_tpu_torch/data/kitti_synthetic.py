"""A synthetic KITTI-format root, written with numpy only: calib, velodyne,
label_2, image_2 (blank grayscale PNGs, written with zlib + struct) and
ImageSets, for smoke runs and tests that must not download data.

Every frame has the same calibration (a 1240 x 370 camera looking along
lidar x); its points all project into the image. The first `near_cars`
boxes are Cars 7-26 m ahead (tall enough in the image for KITTI's "easy"
difficulty); the others are of random classes 10-48 m ahead. Boxes do not
touch in BEV, lie wholly inside the image, sit on a ground plane 1.73 m
below the sensor and hold 20-200 points each; the other points lie on the
ground just below the boxes' bottoms or scatter up to 1 m above the sensor.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..core.geometry.calibration import Calibration
from . import np_geometry as npg

IMG_W, IMG_H = 1240, 370
CALIB_TXT = """P0: 700.0 0.0 620.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P1: 700.0 0.0 620.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P2: 700.0 0.0 620.0 45.0 0.0 700.0 180.0 -0.3 0.0 0.0 1.0 0.005
P3: 700.0 0.0 620.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
R0_rect: 1.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 1.0
Tr_velo_to_cam: 0.0 -1.0 0.0 0.1 0.0 0.0 -1.0 -0.2 1.0 0.0 0.0 0.3
Tr_imu_to_velo: 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0
"""
GROUND_Z = -1.73
# (length, width, height) in metres, about nuScenes' class means
CLASS_DIMS = {
    "Car": (4.6, 1.9, 1.7), "Truck": (7.0, 2.5, 2.9), "Construction_vehicle": (6.4, 2.8, 3.1),
    "Bus": (11.0, 2.9, 3.5), "Trailer": (10.0, 2.5, 3.7), "Barrier": (0.5, 2.5, 1.0),
    "Motorcycle": (2.1, 0.8, 1.5), "Bicycle": (1.7, 0.6, 1.3), "Pedestrian": (0.7, 0.7, 1.75),
    "Traffic_cone": (0.4, 0.4, 1.0),
}


def write_png(path, image):
    """An 8-bit PNG of a (H, W) gray or (H, W, 3) RGB uint8 array: signature,
    IHDR, one zlib IDAT of rows of filter byte 0 and the pixels, IEND."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    image = np.ascontiguousarray(image, np.uint8)
    height, width = image.shape[:2]
    colour = 2 if image.ndim == 3 else 0
    ihdr = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    rows = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def write_png_gray(path, width: int, height: int):
    """A blank 8-bit grayscale PNG."""
    write_png(path, np.zeros((height, width), np.uint8))


def write_png_rgb(path, image):
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png_rgb takes (H, W, 3), not {image.shape}")
    write_png(path, image)


def _in_image(calib, pts):
    img, depth = calib.lidar_to_img(pts)
    return ((img[:, 0] >= 0) & (img[:, 0] < IMG_W) & (img[:, 1] >= 0) & (img[:, 1] < IMG_H)
            & (depth >= 0))


def _place_boxes(rng, calib, class_names, n_boxes, near_cars):
    boxes, names = [], []
    for _ in range(100 * n_boxes):
        if len(boxes) == n_boxes:
            break
        near = len(boxes) < near_cars
        name = "Car" if near else class_names[rng.randint(len(class_names))]
        length, width, height = CLASS_DIMS[name]
        x = rng.uniform(7, 26) if near else rng.uniform(10, 48)
        box = np.array([x, rng.uniform(-0.8, 0.8) * x, GROUND_Z + height / 2, length, width,
                        height, rng.uniform(-np.pi, np.pi)], np.float32)
        radius = 0.5 * np.hypot(length, width)
        if any(np.hypot(*(box[:2] - b[:2])) < radius + 0.5 * np.hypot(*b[3:5]) + 0.3
               for b in boxes):
            continue
        if not _in_image(calib, npg.boxes_to_corners_3d(box[None])[0]).all():
            continue
        boxes.append(box)
        names.append(name)
    if len(boxes) < n_boxes:
        raise RuntimeError(f"could not place {n_boxes} disjoint boxes in the image")
    return np.stack(boxes), np.array(names)


def _background(rng, calib, count):
    """`count` points on the ground (just below the boxes' bottoms) or
    scattered up to 1 m above the sensor, all inside the image."""
    out, have = [np.zeros((0, 3), np.float32)], 0
    while have < count:
        n = 2 * (count - have)
        r = rng.uniform(6, 50, n)
        ang = rng.uniform(-0.7, 0.7, n)
        z = np.where(rng.uniform(0, 1, n) < 0.8, GROUND_Z - 0.05 - rng.uniform(0, 0.05, n),
                     rng.uniform(GROUND_Z, 1.0, n))
        pts = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=1).astype(np.float32)
        pts = pts[_in_image(calib, pts)]
        out.append(pts)
        have += len(pts)
    return np.concatenate(out)[:count]


def write_frame(root, idx, rng, class_names, num_points=(40000, 60000), num_boxes=(20, 40),
                near_cars=8):
    """One frame: calib, velodyne (x, y, z, intensity float32), label_2 and a
    blank image; `num_points` and `num_boxes` are inclusive ranges. Returns
    (gt boxes in lidar (N, 7), class names (N,))."""
    root = Path(root)
    for d in ("calib", "velodyne", "label_2", "image_2"):
        (root / d).mkdir(parents=True, exist_ok=True)
    (root / "calib" / f"{idx}.txt").write_text(CALIB_TXT)
    calib = Calibration(root / "calib" / f"{idx}.txt")

    boxes, names = _place_boxes(rng, calib, class_names,
                                rng.randint(num_boxes[0], num_boxes[1] + 1), near_cars)
    total = rng.randint(num_points[0], num_points[1] + 1)
    pts = []
    for b in boxes:
        local = rng.uniform(-0.49, 0.49, (rng.randint(20, 201), 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                             local[:, 0] * s + local[:, 1] * c + b[1],
                             local[:, 2] + b[2]], axis=1).astype(np.float32))
    inside = sum(len(p) for p in pts)
    pts.append(_background(rng, calib, max(total - inside, 0)))
    pts = np.concatenate(pts)
    intensity = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    np.concatenate([pts, intensity], axis=1).tofile(root / "velodyne" / f"{idx}.bin")

    lines = []
    for b, name in zip(boxes, names):
        bottom = b[0:3].copy()
        bottom[2] -= b[5] / 2
        loc_cam = calib.lidar_to_rect(bottom[None])[0]
        ry = -b[6] - np.pi / 2
        img_pts, _ = calib.lidar_to_img(npg.boxes_to_corners_3d(b[None])[0])
        x1, y1 = np.clip(img_pts.min(0), 0, [IMG_W - 1, IMG_H - 1])
        x2, y2 = np.clip(img_pts.max(0), 0, [IMG_W - 1, IMG_H - 1])
        alpha = -np.arctan2(-b[1], b[0]) + ry
        lines.append(f"{name} 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                     f"{b[5]:.2f} {b[4]:.2f} {b[3]:.2f} "
                     f"{loc_cam[0]:.2f} {loc_cam[1]:.2f} {loc_cam[2]:.2f} {ry:.2f}")
    (root / "label_2" / f"{idx}.txt").write_text("\n".join(lines) + "\n")
    write_png_gray(root / "image_2" / f"{idx}.png", IMG_W, IMG_H)
    return boxes, names


def write_root(root, num_train: int, num_val: int, class_names, seed: int = 0, **frame_kw):
    """Frames 000000 .. of a train and a val split under `root`, with
    ImageSets/train.txt and val.txt; `frame_kw` goes to `write_frame`.
    Returns (train ids, val ids)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    ids = [f"{i:06d}" for i in range(num_train + num_val)]
    for idx in ids:
        write_frame(root, idx, rng, list(class_names), **frame_kw)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:num_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[num_train:]) + "\n")
    return ids[:num_train], ids[num_train:]
