"""Synthetic DFU3D-style scenes: LiDAR + camera + depth + SEEM artifacts
(port of dfu3d_tpu/pseudo/synthetic.py, with the same RNG streams: a seed
gives the JAX package's frame, array for array).

KITTI-format frames shaped like the reference pipeline's real inputs
(352×1216 CAM_FRONT crop, ~35k-point FOV LiDAR, box-shaped vehicle point
clusters on a ground plane) with known ground-truth boxes: the substrate of
end-to-end pseudo-label → train → eval runs without nuScenes, and of
profile_pseudo.py. Images are written with the port's own PNG writer.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.geometry.calibration import Calibration
from ..data.kitti_synthetic import write_png_rgb

IMG_H, IMG_W = 352, 1216

_P2 = np.array(
    [[700.0, 0, IMG_W / 2, 0], [0, 700.0, 180, 0], [0, 0, 1, 0]], np.float32
)
_R0 = np.eye(3, dtype=np.float32)
_V2C = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], np.float32)

CALIB_TXT = (
    "P0: " + " ".join(str(v) for v in _P2.reshape(-1)) + "\n"
    "P1: " + " ".join(str(v) for v in _P2.reshape(-1)) + "\n"
    "P2: " + " ".join(str(v) for v in _P2.reshape(-1)) + "\n"
    "P3: " + " ".join(str(v) for v in _P2.reshape(-1)) + "\n"
    "R0_rect: " + " ".join(str(v) for v in _R0.reshape(-1)) + "\n"
    "Tr_velo_to_cam: " + " ".join(str(v) for v in _V2C.reshape(-1)) + "\n"
    "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0\n"
)


def make_calib() -> Calibration:
    return Calibration({"P2": _P2, "R0": _R0, "Tr_velo2cam": _V2C})


# per-class (l, w, h) size ranges and point budgets for synthetic instances
_CLASS_SPECS = {
    "Car": dict(l=(3.5, 5.0), w=(1.6, 2.0), h=(1.4, 1.8), pts=600, shell=True),
    "Pedestrian": dict(l=(0.6, 1.0), w=(0.5, 0.8), h=(1.6, 1.9), pts=200,
                       shell=False),
    "Cyclist": dict(l=(1.5, 2.0), w=(0.5, 0.8), h=(1.5, 1.8), pts=250,
                    shell=False),
}


def make_scene(seed=0, n_instances=8, n_ground=30000, pts_per_obj=600,
               class_names=("Car",)):
    """One synthetic scene → (FrameInputs, gt_boxes (K, 7), names (K,)).

    Objects are box-shaped shells (vehicles) or filled blobs (VRUs) at known
    poses; the dense depth map renders object points so the fusion pipeline
    produces in-instance pseudo points; SEEM masks are the objects' projected
    pixels. `class_names` cycles per instance; FrameInputs.classes indexes
    into it (the factory's `thing_classes`).
    """
    from .factory import FrameInputs

    rng = np.random.RandomState(seed)
    calib = make_calib()

    pts = [np.stack([
        rng.uniform(2, 60, n_ground), rng.uniform(-25, 25, n_ground),
        rng.normal(-1.7, 0.01, n_ground)], axis=1)]
    gt = []
    names = []
    cls_ids = np.zeros(n_instances, int)
    for i in range(n_instances):
        cls_ids[i] = i % len(class_names)
        name = class_names[cls_ids[i]]
        spec = _CLASS_SPECS[name]
        names.append(name)
        near = spec["shell"] is False  # VRUs nearer so clusters stay dense
        cx = rng.uniform(8, 30 if near else 45)
        cy = rng.uniform(-10, 10)
        # keep objects inside the camera FOV (|y| < ~0.8x for this P2)
        cy = np.clip(cy, -0.5 * cx, 0.5 * cx)
        l = rng.uniform(*spec["l"])
        w = rng.uniform(*spec["w"])
        h = rng.uniform(*spec["h"])
        n_pts = spec["pts"]
        th = rng.uniform(-np.pi, np.pi)
        z0 = -1.7
        if spec["shell"]:
            t = rng.uniform(0, 1, n_pts)
            side = rng.randint(0, 4, n_pts)
            xs = np.where(side == 0, -l / 2 + t * l, np.where(side == 1, l / 2,
                 np.where(side == 2, -l / 2 + t * l, -l / 2)))
            ys = np.where(side == 0, -w / 2, np.where(side == 1, -w / 2 + t * w,
                 np.where(side == 2, w / 2, -w / 2 + t * w)))
        else:
            # filled blob (a pedestrian/cyclist returns points across the body)
            xs = rng.uniform(-l / 2, l / 2, n_pts)
            ys = rng.uniform(-w / 2, w / 2, n_pts)
        c, s = np.cos(th), np.sin(th)
        pts.append(np.stack([
            xs * c - ys * s + cx, xs * s + ys * c + cy,
            rng.uniform(z0, z0 + h, n_pts)], axis=1))
        gt.append([cx, cy, z0 + h / 2, l, w, h, th])
    lidar = np.concatenate(pts).astype(np.float32)
    lidar = np.concatenate(
        [lidar, rng.uniform(0, 1, (len(lidar), 1)).astype(np.float32)], axis=1
    )
    gt = np.asarray(gt, np.float32).reshape(-1, 7)

    image = rng.randint(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8)
    # ground-consistent dense depth (what a metric depth net sees on a road
    # scene): per-pixel ray ∩ the z=-1.7 ground plane; above-horizon → 0
    # (invalid). With V2C above, lidar z = −y_rect = −(v−cy)/f·depth.
    f, cy = _P2[1, 1], _P2[1, 2]
    vv = np.arange(IMG_H, dtype=np.float32)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        ground_depth = 1.7 * f / np.maximum(vv - cy, 1e-6)
    ground_depth = np.where((vv > cy + 2) & (ground_depth < 80), ground_depth, 0)
    depth = np.broadcast_to(ground_depth.astype(np.float32),
                            (IMG_H, IMG_W)).copy()

    masks = np.zeros((n_instances, IMG_H, IMG_W), bool)
    boxes2d = np.zeros((n_instances, 4), np.float32)
    for i in range(n_instances):
        obj = pts[i + 1]
        pix, dv = calib.lidar_to_img(obj)
        pix = np.round(pix).astype(int)
        ok = ((pix[:, 0] >= 0) & (pix[:, 0] < IMG_W)
              & (pix[:, 1] >= 0) & (pix[:, 1] < IMG_H) & (dv > 0))
        if ok.sum() < 10:
            continue
        x1, y1 = pix[ok].min(0)
        x2, y2 = pix[ok].max(0)
        # tight instance mask (SEEM masks are per-pixel, not bboxes): mark the
        # projected object pixels and dilate a little
        m = np.zeros((IMG_H, IMG_W), bool)
        m[pix[ok][:, 1], pix[ok][:, 0]] = True
        for _ in range(2):
            m[1:] |= m[:-1]
            m[:-1] |= m[1:]
            m[:, 1:] |= m[:, :-1]
            m[:, :-1] |= m[:, 1:]
        masks[i] = m
        boxes2d[i] = [x1, y1, x2, y2]
        depth[pix[ok][:, 1], pix[ok][:, 0]] = dv[ok]

    frame = FrameInputs(
        frame_id=f"{seed:06d}", lidar=lidar, image=image, depth=depth,
        calib=calib, masks=masks, classes=cls_ids,
        scores=rng.uniform(0.7, 1.0, n_instances).astype(np.float32),
        boxes2d=boxes2d,
    )
    return frame, gt, names


def write_kitti_frame(root: Path, idx: str, frame, gt_boxes,
                      names=None, with_pseudo_inputs=True):
    """Write one frame in KITTI layout (+ depth/seem artifacts for the
    pseudo-box factory)."""
    from ..data import np_geometry as npg

    root = Path(root)
    for d in ("velodyne", "image_2", "calib", "label_2") + (
        ("depth", "seem") if with_pseudo_inputs else ()
    ):
        (root / d).mkdir(parents=True, exist_ok=True)

    frame.lidar.astype(np.float32).tofile(root / "velodyne" / f"{idx}.bin")
    write_png_rgb(root / "image_2" / f"{idx}.png", frame.image)
    (root / "calib" / f"{idx}.txt").write_text(CALIB_TXT)
    if with_pseudo_inputs:
        np.save(root / "depth" / f"{idx}.npy", frame.depth)
        np.savez_compressed(
            root / "seem" / f"{idx}.npz", masks=frame.masks,
            classes=frame.classes, scores=frame.scores, boxes2d=frame.boxes2d,
        )

    # ground-truth KITTI label lines (camera frame, bottom-center loc)
    calib = frame.calib
    names = names or ["Car"] * len(gt_boxes)
    lines = []
    for b, nm in zip(gt_boxes, names):
        loc = b[0:3].copy()
        loc[2] -= b[5] / 2.0
        loc_cam = calib.lidar_to_rect(loc[None])[0]
        ry = -b[6] - np.pi / 2
        corners = npg.boxes_to_corners_3d(b[None])[0]
        pix, dv = calib.lidar_to_img(corners)
        x1, y1 = pix.min(0)
        x2, y2 = pix.max(0)
        x1, x2 = np.clip([x1, x2], 0, IMG_W - 1)
        y1, y2 = np.clip([y1, y2], 0, IMG_H - 1)
        alpha = ry - np.arctan2(loc_cam[0], loc_cam[2])
        lines.append(
            f"{nm} 0.0 0 {alpha:.4f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"{b[5]:.3f} {b[4]:.3f} {b[3]:.3f} "
            f"{loc_cam[0]:.3f} {loc_cam[1]:.3f} {loc_cam[2]:.3f} {ry:.4f}"
        )
    (root / "label_2" / f"{idx}.txt").write_text(
        "\n".join(lines) + ("\n" if lines else "")
    )


def make_dataset(root: Path, n_train=64, n_val=16, n_instances=8, seed0=0,
                 class_names=("Car",)):
    """Full synthetic KITTI-format dataset with ImageSets splits."""
    root = Path(root)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    ids = []
    for i in range(n_train + n_val):
        frame, gt, names = make_scene(seed=seed0 + i, n_instances=n_instances,
                                      class_names=class_names)
        idx = f"{i:06d}"
        write_kitti_frame(root, idx, frame, gt, names=names)
        ids.append(idx)
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[n_train:]) + "\n")
    return ids[:n_train], ids[n_train:]


def bev_recovery(pred_boxes, gt_boxes, iou_thresh: float = 0.5):
    """How well LiDAR boxes (M, 7) recover a scene's gt (K, 7) in BEV: the gt
    count, how many gt have a box at BEV IoU ≥ iou_thresh, and each gt's best
    BEV IoU (0 with no box)."""
    from ..data import np_geometry as npg

    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 7)
    pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 7)
    best = np.zeros(len(gt_boxes), np.float32)
    if len(pred_boxes) and len(gt_boxes):
        best = npg.pairwise_iou_bev(gt_boxes, pred_boxes).max(axis=1)
    return {"gt": len(gt_boxes), "recalled": int((best >= iou_thresh).sum()),
            "best_iou": best.tolist()}
