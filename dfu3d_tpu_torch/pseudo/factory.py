"""Pseudo-box factory: per-frame bi-directional fusion → boxes + dense clouds
(port of dfu3d_tpu/pseudo/factory.py).

Pipeline parity with the reference (SURVEY §3.1, tools/PENet/vis_utils.py
save_depth_as_points:136-166 + my_loader.py depth2pointsrgbpm:502-617):

1. ground plane RANSAC on LiDAR → above-plane mask            (device)
2. camera→LiDAR label inheritance: project above-plane LiDAR into the
   image, assign SEEM instance ids by mask lookup               (host)
3. LiDAR→camera densification: back-project dense-depth pixels to 3D, keep
   z < 1, spherical min-range resample (la_sampling2 semantics: 0.002 rad
   cells, polar angle > 1.5 rad)                                (host)
4. per instance: pseudo points gated by the instance mask, class-conditional
   radius outlier removal (vehicles r=3.0, VRUs r=0.6), BallQuery gate
   (pseudo within 0.1 m of a real point)                        (device)
5. cluster (adaptive-range connected components) + L-shape fit → KITTI
   label lines written per frame                                (device)
6. fused cloud: [lidar(xyz, i×10, flag=2) ⧺ pseudo(xyz, 0, rgb/3, flag=1)]
   as (N, 8) fp16 → velodyne_depth/<idx>.npy                    (host)

The host steps are numpy, as in the JAX package, so that the fused cloud and
the label files repeat its own. The external foundation models stay out of
process: the factory reads their outputs as artifacts —
    seem/<idx>.npz   masks (K, H, W) bool/uint8, classes (K,) int,
                     scores (K,) float, boxes2d (K, 4)
    depth/<idx>.npy  (H, W) float32 metric depth
— or takes a `seem_adapter.SeemSegmenter` (any image → SegmentationResult
callable) through `load_frame_inputs(..., segmenter=)`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.geometry.calibration import Calibration
from ..data import kitti_io
from ..device import resolve_device
from . import ops

NUSCENES_CLASSES = [
    "Car", "Truck", "Construction_vehicle", "Bus", "Trailer",
    "Barrier", "Motorcycle", "Bicycle", "Pedestrian", "Traffic_cone",
]
VEHICLE_CLASSES = {"Car", "Truck", "Construction_vehicle", "Bus", "Trailer"}
LIDAR_CAP = 65536          # the plane program's fixed point buffer
RANSAC_ITERS = 128

# Cross-dataset factory variants (my_loader_KittiPandasetWaymo.py:883-1010):
# the KITTI/Pandaset/Waymo factories apply class (l, w) size priors
# unconditionally (:964-967) and a height prior when the measured height
# < 1 m (:908-915); the nuScenes factory (my_loader.py, the flagship path)
# has center_type=None and its size-prior branch is dead code.
_KITTI_SIZE_PRIORS = {
    "Car": (3.9, 1.6), "Pedestrian": (0.8, 0.6),
    "Cyclist": (1.76, 0.6), "Person ride a bike": (1.76, 0.6),
    "Bicycle": (1.76, 0.6),
}
_KITTI_HEIGHT_PRIORS = {
    "Car": 1.56, "Pedestrian": 1.73,
    "Cyclist": 1.73, "Person ride a bike": 1.73, "Bicycle": 1.73,
}
FACTORY_PRESETS = {
    "nuscenes": dict(size_priors=None, height_priors=None, center_type=None),
    "kitti": dict(size_priors=_KITTI_SIZE_PRIORS,
                  height_priors=_KITTI_HEIGHT_PRIORS, center_type=None),
    "waymo": dict(size_priors=_KITTI_SIZE_PRIORS,
                  height_priors=_KITTI_HEIGHT_PRIORS, center_type=None),
    "pandaset": dict(size_priors=_KITTI_SIZE_PRIORS,
                     height_priors=_KITTI_HEIGHT_PRIORS, center_type=None),
}


@dataclass
class FrameInputs:
    """All per-frame inputs, already loaded as arrays."""

    frame_id: str
    lidar: np.ndarray          # (N, 4) x y z intensity (FOV-cropped)
    image: np.ndarray          # (H, W, 3) uint8/float
    depth: np.ndarray          # (H, W) float32 metric depth (dense)
    calib: Calibration
    masks: np.ndarray          # (K, H, W) bool — SEEM instances
    classes: np.ndarray        # (K,) int — indices into class list
    scores: np.ndarray         # (K,) float
    boxes2d: np.ndarray        # (K, 4) x1 y1 x2 y2


@dataclass
class FrameOutputs:
    boxes_lidar: np.ndarray    # (M, 7)
    names: List[str]
    scores: np.ndarray         # (M,)
    boxes2d: np.ndarray        # (M, 4)
    alphas: np.ndarray         # (M,)
    fused_points: np.ndarray   # (N, 8) fp16


@dataclass
class PackedInstances:
    """The frame program's inputs: up to `max_instances` SEEM instances, the
    highest-scoring first, each padded to P points."""

    order: np.ndarray          # (k_used,) indices into the frame's instances
    names: List[str]           # (k_used,) class names
    lidar: np.ndarray          # (K, P, 3) float32
    lidar_valid: np.ndarray    # (K, P) bool
    pseudo: np.ndarray         # (K, P, 3) float32
    pseudo_valid: np.ndarray   # (K, P) bool
    radii: np.ndarray          # (K,) float32
    is_car: np.ndarray         # (K,) bool
    size_prior: np.ndarray     # (K, 2) float32, ≤ 0 disables
    height_prior: np.ndarray   # (K,) float32, ≤ 0 disables


def load_frame_inputs(root: Path, idx: str, thing_classes=None,
                      segmenter=None) -> FrameInputs:
    """One frame's inputs. The segmentation comes from the seem/<idx>.npz
    artifact by default; pass a `seem_adapter.SeemSegmenter` (or any image
    -> SegmentationResult callable) to run a segmenter in process instead
    (the reference's SegSeem arrangement, vis_utils.py:150-152)."""
    root = Path(root)
    calib = Calibration(root / "calib" / f"{idx}.txt")
    lidar = kitti_io.read_velodyne_bin(root / "velodyne" / f"{idx}.bin")
    image = kitti_io.read_png(root / "image_2" / f"{idx}.png")
    depth = np.load(root / "depth" / f"{idx}.npy").astype(np.float32)
    if segmenter is not None:
        seg = segmenter(image, frame_id=idx) if hasattr(
            segmenter, "cache_artifact") else segmenter(image)
        masks, classes = seg.masks, seg.classes
        scores, boxes2d = seg.scores, seg.boxes2d
    else:
        seem = np.load(root / "seem" / f"{idx}.npz")
        masks, classes = seem["masks"], seem["classes"]
        scores, boxes2d = seem["scores"], seem["boxes2d"]
    return FrameInputs(
        frame_id=idx, lidar=lidar, image=image, depth=depth, calib=calib,
        masks=np.asarray(masks).astype(bool),
        classes=np.asarray(classes).astype(int),
        scores=np.asarray(scores).astype(np.float32),
        boxes2d=np.asarray(boxes2d).astype(np.float32),
    )


class PseudoBoxFactory:
    """Per-frame pseudo-box generation: numpy on the host, two fixed-shape
    programs on `device` (the card unless "cpu" is asked for).

    `seed` seeds the generator of the RANSAC triples; `process_frame` also
    takes the triples from the caller. After each frame, `last_times` holds
    the host-clock seconds of its stages (plane, densify, packing,
    frame_program, post_filter; each ends with the device's results on the
    host) and `last_stats` the label propagation's sweeps and host syncs."""

    def __init__(self, thing_classes=None, max_points_per_instance: int = 2048,
                 max_clusters_per_instance: int = 4,
                 min_cluster_points: int = 5,
                 spherical_resolution: float = 0.002,
                 elevation_polar_min: float = 1.5,
                 ball_gate_c: float = 0.1,
                 max_instances: int = 16,
                 ground_z: float = 0.0,
                 z_offset: float = 1.5,
                 size_priors: Optional[dict] = None,
                 height_priors: Optional[dict] = None,
                 center_type: Optional[str] = None,
                 seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.thing_classes = list(thing_classes or NUSCENES_CLASSES)
        self.max_pts = max_points_per_instance
        self.max_clusters = max_clusters_per_instance
        self.min_cluster_points = min_cluster_points
        self.sph_res = spherical_resolution
        self.polar_min = elevation_polar_min
        self.ball_gate_c = ball_gate_c
        # frames with more SEEM instances keep the max_instances
        # highest-scoring ones (fixed shapes, as in the JAX package)
        self.max_instances = max_instances
        # box z/height ground assumptions (reference GenerateAnns hardcodes
        # ground_z=0 / z_offset=1.5 for nuScenes-kitti; see ops.box_from_corners)
        self.ground_z = float(ground_z)
        self.z_offset = float(z_offset)
        self.size_priors = size_priors
        self.height_priors = height_priors
        self.center_type = center_type
        self.generator = torch.Generator().manual_seed(seed)
        self.last_times = {}
        self.last_stats = {}

    # -- stages -------------------------------------------------------------

    def densify(self, frame: FrameInputs):
        """Depth pixels → pseudo points (x,y,z, 0, r/3,g/3,b/3, flag=1) and
        their (v, u) pixels."""
        depth = frame.depth.copy()
        depth[depth < 0.001] = 0
        vv, uu = np.nonzero(depth > 0)
        depth_val = depth[vv, uu]
        p_rect = frame.calib.img_to_rect(uu.astype(np.float32), vv.astype(np.float32), depth_val)
        p_lidar = frame.calib.rect_to_lidar(p_rect)
        rgb = frame.image[vv, uu].astype(np.float32) / 3.0

        keep = p_lidar[:, 2] < 1.0  # z < 1 (my_loader.py:540)
        p_lidar, rgb = p_lidar[keep], rgb[keep]
        pix = np.stack([vv[keep], uu[keep]], axis=1)

        # spherical min-range resample with polar-angle cut (la_sampling2:
        # to_sphere_coords keeps theta = arccos(z/r) > polar_min)
        r = np.linalg.norm(p_lidar, axis=1)
        theta = np.arccos(np.clip(p_lidar[:, 2] / np.maximum(r, 1e-9), -1, 1))
        phi = np.arctan2(p_lidar[:, 1], p_lidar[:, 0])
        ok = theta > self.polar_min
        bins_t = (theta / self.sph_res).astype(np.int64)
        bins_p = ((phi + np.pi) / self.sph_res).astype(np.int64)
        bin_id = bins_t * 4_000_000 + bins_p
        # one int64 sort key (bin, range quantised to 2^20 steps over 200 m)
        r_q = np.minimum(r * (1 << 20) / 200.0, (1 << 20) - 1).astype(np.int64)
        order = np.argsort((bin_id << 20) | r_q, kind="stable")
        sorted_bin = bin_id[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = sorted_bin[1:] != sorted_bin[:-1]
        keep_mask = np.zeros(len(order), dtype=bool)
        keep_mask[order[first]] = True
        keep_mask &= ok

        pseudo = np.zeros((keep_mask.sum(), 8), np.float32)
        pseudo[:, 0:3] = p_lidar[keep_mask]
        pseudo[:, 4:7] = rgb[keep_mask]
        pseudo[:, 7] = 1.0
        return pseudo, pix[keep_mask]

    def _pad(self, pts):
        n = len(pts)
        cap = self.max_pts
        out = np.zeros((cap, 3), np.float32)
        take = min(n, cap)
        if take:
            if n > cap:
                sel = np.random.RandomState(0).choice(n, cap, replace=False)
                out[:] = pts[sel, :3]
                take = cap
            else:
                out[:take] = pts[:take, :3]
        valid = np.zeros(cap, bool)
        valid[:take] = True
        return out, valid

    @staticmethod
    def _pad_any(pts, cap):
        out = np.zeros((cap, pts.shape[1]), np.float32)
        take = min(len(pts), cap)
        out[:take] = pts[:take]
        valid = np.zeros(cap, bool)
        valid[:take] = True
        return out, valid

    def plane_and_above(self, lidar, triples=None):
        """Stage 1 on the device: the ground plane (4,) and the above-plane
        mask of `lidar` (points beyond LIDAR_CAP are dropped). `triples`
        (RANSAC_ITERS, 3) defaults to a draw from the factory's generator."""
        pad_lidar, pad_valid = self._pad_any(lidar[:, :3], LIDAR_CAP)
        valid = torch.from_numpy(pad_valid)
        if triples is None:
            triples = ops.sample_ground_triples(valid, RANSAC_ITERS, self.generator)
        plane, above_pad = ops.plane_and_above(
            torch.from_numpy(pad_lidar).to(self.device), valid.to(self.device),
            torch.as_tensor(np.array(triples, np.int64)).to(self.device))
        plane, above_pad = plane.cpu().numpy(), above_pad.cpu().numpy()
        if len(lidar) > len(above_pad):
            above = np.zeros(len(lidar), bool)
            above[: len(above_pad)] = above_pad
        else:
            above = above_pad[: len(lidar)]
        return plane, above

    def pack_instances(self, frame: FrameInputs, lidar_above, pseudo, pseudo_pix):
        """Stages 2 and 4's inputs on the host: the above-plane LiDAR in the
        image and the pseudo points, split by SEEM instance mask and padded."""
        img_h, img_w = frame.depth.shape[:2]
        pts_img, pts_depth = frame.calib.lidar_to_img(lidar_above[:, :3])
        pix = np.round(pts_img).astype(np.int64)
        in_img = ((pix[:, 0] >= 0) & (pix[:, 0] < img_w)
                  & (pix[:, 1] >= 0) & (pix[:, 1] < img_h) & (pts_depth > 0))
        kcap = self.max_instances
        order = np.argsort(-np.asarray(frame.scores))[:kcap]
        packed = PackedInstances(
            order=order, names=[],
            lidar=np.zeros((kcap, self.max_pts, 3), np.float32),
            lidar_valid=np.zeros((kcap, self.max_pts), bool),
            pseudo=np.zeros((kcap, self.max_pts, 3), np.float32),
            pseudo_valid=np.zeros((kcap, self.max_pts), bool),
            radii=np.full(kcap, 0.6, np.float32), is_car=np.zeros(kcap, bool),
            size_prior=np.full((kcap, 2), -1.0, np.float32),
            height_prior=np.full(kcap, -1.0, np.float32))
        lid_in, lid_pix = lidar_above[in_img], pix[in_img]
        for slot, k in enumerate(order):
            mask = frame.masks[k]
            cls_name = self.thing_classes[int(frame.classes[k])]
            packed.names.append(cls_name)
            packed.radii[slot] = 3.0 if cls_name in VEHICLE_CLASSES else 0.6
            packed.is_car[slot] = cls_name == "Car"
            if self.size_priors and cls_name in self.size_priors:
                packed.size_prior[slot] = self.size_priors[cls_name]
            if self.height_priors and cls_name in self.height_priors:
                packed.height_prior[slot] = self.height_priors[cls_name]
            obj_lidar = lid_in[mask[lid_pix[:, 1], lid_pix[:, 0]]]
            obj_pseudo = pseudo[mask[pseudo_pix[:, 0], pseudo_pix[:, 1]]]
            packed.lidar[slot], packed.lidar_valid[slot] = self._pad(obj_lidar)
            packed.pseudo[slot], packed.pseudo_valid[slot] = self._pad(obj_pseudo)
        return packed

    def run_frame_program(self, packed: PackedInstances, stats=None):
        """Stages 4 and 5 on the device, every instance at once → numpy
        boxes (K, C, 7), ok (K, C), counts (K, C), n_obj (K,)."""
        def dev(a):
            return torch.from_numpy(a).to(self.device)

        out = ops.frame_program(
            dev(packed.lidar), dev(packed.lidar_valid), dev(packed.pseudo),
            dev(packed.pseudo_valid), dev(packed.radii), dev(packed.is_car),
            dev(packed.size_prior), dev(packed.height_prior),
            num_clusters=self.max_clusters, min_pts=self.min_cluster_points,
            ball_gate_c=self.ball_gate_c, ground_z=self.ground_z, z_offset=self.z_offset,
            center_type=self.center_type, stats=stats)
        return tuple(t.cpu().numpy() for t in out)

    def process_frame(self, frame: FrameInputs, triples=None) -> FrameOutputs:
        """One frame's boxes and fused cloud. `triples` (RANSAC_ITERS, 3)
        point indices replace the generator's draw for the ground plane."""
        times, stats = {}, {"sweeps": 0, "syncs": 0}
        lidar = frame.lidar
        t0 = time.perf_counter()
        _, above = self.plane_and_above(lidar, triples)
        t1 = time.perf_counter()
        pseudo, pseudo_pix = self.densify(frame)
        t2 = time.perf_counter()
        packed = self.pack_instances(frame, lidar[above], pseudo, pseudo_pix)
        t3 = time.perf_counter()
        times.update(plane=t1 - t0, densify=t2 - t1, packing=t3 - t2)

        boxes_out, names_out, scores_out, boxes2d_out, alphas_out = [], [], [], [], []
        if len(packed.order):
            boxes_k, ok_k, _, _ = self.run_frame_program(packed, stats)
            t3b = time.perf_counter()
            times["frame_program"] = t3b - t3
            t3 = t3b
            for slot, k in enumerate(packed.order):
                for c in range(self.max_clusters):
                    if not ok_k[slot, c]:
                        continue
                    box = np.asarray(boxes_k[slot, c], np.float32)
                    if not np.all(np.isfinite(box)) or box[3] <= 0 or box[4] <= 0:
                        continue
                    rotation_cam = -box[6] - np.pi / 2
                    theta = np.arctan(-box[0] / (box[1] + 1e-8))
                    alphas_out.append(rotation_cam - theta)
                    boxes_out.append(box)
                    names_out.append(packed.names[slot])
                    scores_out.append(float(frame.scores[k]))
                    boxes2d_out.append(np.asarray(frame.boxes2d[k], np.float32))
        else:
            times["frame_program"] = 0.0

        # 6. fused cloud
        new_lidar = np.zeros((len(lidar), 8), np.float32)
        new_lidar[:, 0:4] = lidar[:, 0:4]
        new_lidar[:, 3] *= 10.0
        new_lidar[:, 7] = 2.0
        fused = np.concatenate([new_lidar, pseudo], axis=0).astype(np.float16)
        times["post_filter"] = time.perf_counter() - t3
        self.last_times, self.last_stats = times, stats

        return FrameOutputs(
            boxes_lidar=np.asarray(boxes_out, np.float32).reshape(-1, 7),
            names=names_out,
            scores=np.asarray(scores_out, np.float32),
            boxes2d=np.stack(boxes2d_out) if boxes2d_out else np.zeros((0, 4), np.float32),
            alphas=np.asarray(alphas_out, np.float32),
            fused_points=fused,
        )

    def write_frame(self, root: Path, frame: FrameInputs, out: FrameOutputs,
                    label_dir: str = "label_train"):
        """Write the KITTI label txt + fused velodyne_depth npy."""
        root = Path(root)
        (root / label_dir).mkdir(parents=True, exist_ok=True)
        (root / "velodyne_depth").mkdir(parents=True, exist_ok=True)

        lines = []
        for i in range(len(out.boxes_lidar)):
            b = out.boxes_lidar[i]
            # KITTI location is the BOTTOM center in rect coords (the
            # reference's GenerateAnns writes the box center, my_loader.py:
            # 677-680, which the KITTI read path then shifts up by h/2)
            center = b[0:3].copy()
            center[2] -= b[5] / 2.0
            center_cam = frame.calib.lidar_to_rect(center[None])[0]
            ry = -b[6] - np.pi / 2
            x1, y1, x2, y2 = out.boxes2d[i]
            # KITTI line: h=height, w=width, l=length (GenerateAnns layout)
            lines.append(
                f"{out.names[i]} 0 0 {out.alphas[i]} {x1} {y1} {x2} {y2} "
                f"{b[5]} {b[4]} {b[3]} "
                f"{center_cam[0]} {center_cam[1]} {center_cam[2]} {ry}"
            )
        (root / label_dir / f"{frame.frame_id}.txt").write_text(
            "\n".join(lines) + ("\n" if lines else ""))
        np.save(root / "velodyne_depth" / f"{frame.frame_id}.npy", out.fused_points)
