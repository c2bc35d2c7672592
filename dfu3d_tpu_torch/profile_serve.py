"""Where the serving time goes, on the card.

    python -m dfu3d_tpu_torch.profile_serve [--model pillar|voxel|pointrcnn|second|pp|
                                                     second_iou|voxel_rcnn|pv_rcnn|
                                                     parta2|pv_rcnn_plusplus]
                                            [--batches 8] [--out FILE.json]

Runs an eval step (`make_eval_step`) at full width: the flagship
CenterPoint-pillar (256 x 512 BEV), voxel CenterPoint
(cbgs_voxel01_res3d_centerpoint, 1024 x 1024 x 40 grid), PointRCNN
(pointrcnn_nuscenes2kitti), SECOND multi-head (cbgs_second_multihead,
1024 x 1024 x 40 grid, max_voxels 60,000) or PointPillar multi-head
(cbgs_pp_multihead, 512 x 512 pillars), or one of the two-stage KITTI
detectors (second_iou.yaml, voxel_rcnn_car.yaml, pv_rcnn.yaml, PartA2.yaml,
pv_rcnn_plusplus.yaml, 1408 x 1600 x 40 grid, max_voxels 40,000). CenterPoint: B=4, 60,000 uniform
points in a 50 m extent, 256 gt slots. PointRCNN: B=4 frames of a
synthetic KITTI root (40,000-60,000 points in the camera frustum, 20-40
boxes; uniform points would give PointNet++'s 0.1 m balls no neighbours)
read through KittiDataset in test mode, so 16,384 sampled points each.
SECOND and PointPillar: B=4 key frames of a synthetic nuScenes root
(`data.nuscenes_synthetic`: 10 sweeps of 34,000 points, 20-40 boxes of the
ten classes) read through NuScenesDataset in test mode, at most 65,536
points each. The two-stage detectors: B=4 frames of a synthetic KITTI
root (40,000-60,000 points in the frustum, 20-40 boxes of the config's
classes) read through KittiDataset in test mode, at most 32,768 points
each. bf16 autocast, weights from `seeded_weights_`. It reports,
as one JSON object (printed, and written to --out):

* step_ms: host clock per step, no instrumentation (median over batches);
* phase_ms: the same step with a device sync at each phase boundary
  (pillar: batch upload, VFE, 2D backbone, head convs, decode + NMS,
  recall; voxel: batch upload, voxelize + MeanVFE, neighbour tables, sparse
  convs, height compression, 2D backbone, head convs, decode + NMS, recall;
  pointrcnn: the exclusive time of each span, a span's nested spans
  apart: each SA level and its FPS and ball queries, each FP level and
  its 3-NN, the point head, the proposal layer with its B1 launch and
  keep-scan, the RoI pooling, the RoI head with its FPS and ball queries,
  the final NMS with its B1 launch and keep-scan, the recall IoU with its
  B1 launch, and the rest of the step; pointrcnn also reports fps_share,
  the FPS spans' share of the instrumented step; second and pp: the
  exclusive ms of the spans of `anchor_phase_times`: the VFE, the
  neighbour tables, the sparse convs with their B2 launches, the 2D
  backbone, the head, the decode, the NMS with its B1 launch and keep-scan,
  the recall IoU with its B1 launch, and the rest; the two-stage
  detectors: the spans of `two_stage_phase_times`: the trunk (PartA2's
  decoder apart), the RPN, the proposals, PV-RCNN's and PV-RCNN++'s VSA
  and FPS (fps_share), PartA2's part head, the RoI pooling and head, the
  final NMS, the recall IoU);
* nms_scan: fixed-point iterations of the keep-scan per call and its time;
* profile: torch.profiler over the batches (PointRCNN: the first two),
  device time by kernel name and the device's busy share of the window.

Needs a CUDA device; numbers are tagged with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

from .core import pointnet2
from .core.geometry import iou_kernel
from .core.geometry import nms as nms_mod
from .data.batch import synthetic_batch
from .flagship import flagship, seeded_weights_
from .core.voxel import gather_gemm_kernel
from .models import pointpillar as pointpillar_mod
from .models import pointrcnn as pointrcnn_mod
from .models import roi_head
from .models import second_iou as second_iou_mod
from .train import train_state
from .train.train_state import make_eval_step
from .zoo import (NUSCENES_BATCH_SIZE, POINTRCNN_BATCH_SIZE, kitti_batches, nuscenes_batches,
                  parta2, pointrcnn, pointrcnn_batches, pp_multihead, pv_rcnn, pv_rcnn_plusplus,
                  second_iou, second_multihead, voxel_centerpoint, voxel_rcnn,
                  write_pointrcnn_root)

RECALL_THRESH = (0.3, 0.5, 0.7)


def _run(step, batch):
    """One step, through to its recall counters on the host."""
    *_, recall = step(batch)
    return {k: int(v) for k, v in recall.items()}


def _phase_times(model, step, batch):
    """One step with a sync and a host timestamp at each phase boundary."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    hooks = [model.vfe.register_forward_pre_hook(lambda m, a: mark("upload"))]
    voxel = model.use_voxel_backbone
    names = ((("vfe", "voxelize_vfe"), ("backbone_3d", "sparse_convs")) if voxel
             else (("vfe", "vfe"),))
    names += (("backbone_2d", "backbone_2d"), ("dense_head", "dense_head"))
    for module, name in names:
        hooks.append(getattr(model, module).register_forward_hook(
            lambda m, a, o, name=name: mark(name)))
    if voxel:
        hooks.append(model.backbone_2d.register_forward_pre_hook(
            lambda m, a: mark("height_compression")))
    wrapped = [(model.dense_head, "generate_predicted_boxes", "decode_nms")]
    if voxel:
        wrapped.append((model.backbone_3d, "plan", "neighbour_tables"))
    for obj, attr, name in wrapped:
        def timed(*a, orig=getattr(obj, attr), name=name, **k):
            out = orig(*a, **k)
            mark(name)
            return out
        setattr(obj, attr, timed)
    try:
        mark("start")
        _run(step, batch)
        mark("recall")
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
        for h in hooks:
            h.remove()
    return {b[0]: (b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])}


class Spans:
    """Exclusive host-clock ms of nested spans, with a device sync at each
    span's start and end. A span opened inside another is keyed
    "<outer>.<name>" and its time is taken out of the outer span's."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.stack = []  # [name, ms of the nested spans]
        self.saved = []

    def wrap(self, obj, attr, name):
        """Time every call of obj.attr as span `name` until `restore`."""
        orig = getattr(obj, attr)
        self.saved.append((obj, attr, orig, attr in vars(obj)))

        def timed(*a, **k):
            key = f"{self.stack[-1][0]}.{name}" if self.stack else name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append([key, 0.0])
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                _, nested = self.stack.pop()
                self.ms[key] += dt - nested
                if self.stack:
                    self.stack[-1][1] += dt

        setattr(obj, attr, timed)

    def restore(self):
        for obj, attr, orig, own in reversed(self.saved):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self.saved = []


def timed_spans(wraps, run, batch):
    """run(batch) with each (obj, attr, name) of `wraps` timed as a span of
    `Spans`: the exclusive ms of each span, "rest" and the whole "step"."""
    spans = Spans()
    try:
        for obj, attr, name in wraps:
            spans.wrap(obj, attr, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(batch)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        spans.restore()
    phases = dict(spans.ms)
    phases["rest"] = total - sum(phases.values())
    phases["step"] = total
    return phases


def pointrcnn_phase_times(model, run, batch, optimizer=None):
    """One PointRCNN step, `run(batch)` (an eval step, or with its
    `optimizer` a train step), with every span of `Spans` timed. A train
    step adds the point targets, the point losses, the RoI targets (with
    their B1 launch), the RCNN loss, the backward and the clip + optimizer
    update."""
    wraps = [(mod, "forward", f"backbone.{name}")
             for name, mod in model.backbone.named_children()]
    wraps += [(model.point_head, "forward", "point_head"),
              (model.roi_head, "forward", "roi_head"), (model, "pool_rois", "pool_rois"),
              (pointnet2, "farthest_point_sample", "fps"), (pointnet2, "ball_query", "ball_query"),
              (pointnet2, "three_nn", "three_nn"), (roi_head, "proposal_layer", "proposal_layer"),
              (roi_head, "final_nms", "final_nms"),
              (train_state, "pairwise_iou3d", "recall_iou"), (iou_kernel, "overlap_bev", "b1"),
              (nms_mod, "_suppression_scan", "keep_scan")]
    if optimizer is not None:
        wraps += [(pointrcnn_mod, "assign_point_targets", "point_targets"),
                  (pointrcnn_mod, "sigmoid_focal_loss", "point_loss"),
                  (pointrcnn_mod, "weighted_smooth_l1", "point_loss"),
                  (roi_head, "assign_roi_targets", "roi_targets"),
                  (roi_head, "roi_head_loss", "rcnn_loss"),
                  (torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


def anchor_phase_times(model, run, batch, optimizer=None):
    """One step of an anchor detector (PointPillar or SECONDNet), `run(batch)`
    (an eval step, or with its `optimizer` a train step), with every span of
    `Spans` timed: the VFE, the neighbour tables and the sparse convs with
    their B2 launches (SECONDNet), the 2D backbone, the head, the decode, the
    NMS with its B1 launch and keep-scan, the recall IoU with its B1 launch;
    a train step adds the anchor targets, the loss, the backward (with B2's
    dX launches) and the clip + optimizer update."""
    wraps = [(model.vfe, "forward", "vfe"), (model.backbone_2d, "forward", "backbone_2d"),
             (model.dense_head, "forward", "dense_head"),
             (pointpillar_mod, "decode_anchor_predictions", "decode"),
             (pointpillar_mod, "nms_bev", "nms"), (iou_kernel, "overlap_bev", "b1"),
             (nms_mod, "_suppression_scan", "keep_scan"),
             (train_state, "pairwise_iou3d", "recall_iou")]
    if hasattr(model, "backbone_3d"):
        wraps += [(model.backbone_3d, "plan", "neighbour_tables"),
                  (model.backbone_3d, "forward", "sparse_convs"),
                  (gather_gemm_kernel, "gather_gemm", "b2")]
    if optimizer is not None:
        wraps += [(model, "assign_targets", "anchor_targets"),
                  (pointpillar_mod, "anchor_head_loss", "loss"),
                  (torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


def anchor_profile(model, run, batches, optimizer=None):
    """Where an anchor detector's step goes, `run(batch)` running an eval
    step or (given its `optimizer`) a train step through to its result on
    the host: phase_ms, the median over the batches of each span's
    exclusive ms (`anchor_phase_times`), and keep_scan (`keep_scans`)."""
    phases = [anchor_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    return {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys},
            "keep_scan": keep_scans(run, batches)}


def two_stage_phase_times(model, run, batch, optimizer=None):
    """One step of a two-stage voxel detector (SECONDNetIoU, VoxelRCNN,
    PVRCNN, PVRCNNPlusPlus or PartA2Net), `run(batch)` (an eval step, or
    with its `optimizer` a train step), with every span of `Spans` timed:
    the VFE, the neighbour tables and the sparse convs with their B2
    launches (the trunk; PartA2's SparseUNet encoder, its decoder apart as
    unet_decoder), the 2D backbone, the head (the RPN), the proposals with
    their B1 launch and keep-scan, PV-RCNN's and PV-RCNN++'s voxel set
    abstraction (vsa: the SA or vector pools) with its FPS (PV-RCNN++: over
    the points near the RoIs, keypoint_mask apart), PartA2's part head, the
    RoI pooling (PartA2's RoI-aware pools, PV-RCNN++'s grid vector pools),
    the RoI head (FC stacks; PartA2's conv blocks too), the final NMS with
    its B1 launch and keep-scan, the recall IoU with its B1 launch; a train
    step adds the anchor targets, the RPN loss, the RoI targets with their
    B1 launch, the RCNN loss, the keypoint segmentation loss or PartA2's
    part losses, the backward (with B2's dX launches) and the clip +
    optimizer update."""
    from .models import parta2 as parta2_mod

    trunk = next(getattr(model, n) for n in ("unet", "encoder", "backbone_3d")
                 if hasattr(model, n))
    wraps = [(model.vfe, "forward", "vfe"), (trunk, "plan", "neighbour_tables"),
             (trunk, "forward", "sparse_convs"), (gather_gemm_kernel, "gather_gemm", "b2"),
             (model.backbone_2d, "forward", "backbone_2d"),
             (model.dense_head, "forward", "dense_head"), (model, "proposals", "proposals"),
             (iou_kernel, "overlap_bev", "b1"), (nms_mod, "_suppression_scan", "keep_scan"),
             (roi_head, "final_nms", "final_nms"),
             (train_state, "pairwise_iou3d", "recall_iou")]
    heads = [n for n in ("shared_fc", "iou_fc", "cls_fc", "reg_fc", "cls_pred", "reg_pred",
                         "roi_head") if hasattr(model, n)]
    wraps += [(getattr(model, n), "forward", "roi_head") for n in heads]
    pools = [m for n, m in model.named_children() if n.startswith(("pool_", "grid_sa",
                                                                   "grid_vp"))]
    wraps += [(m, "forward", "roi_pool") for m in pools]
    if hasattr(model, "unet"):   # PartA2
        wraps += [(getattr(model.unet, n), "forward", "unet_decoder")
                  for n in ("up3", "up2", "up1")]
        wraps += [(parta2_mod, "parent_gather", "unet_decoder"),
                  (model.seg_mlp, "forward", "part_head"), (model.seg_out, "forward", "part_head"),
                  (model.part_out, "forward", "part_head"),
                  (parta2_mod, "roiaware_pool", "roi_pool")]
    elif not pools:   # SECOND-IoU
        wraps.append((second_iou_mod, "bev_roi_align", "roi_pool"))
    if hasattr(model, "vsa_pools"):   # PV-RCNN, PV-RCNN++
        wraps += [(model, "roi_sources", "vsa"), (pointnet2, "farthest_point_sample", "fps")]
        if hasattr(model, "keypoint_mask"):
            wraps.append((model, "keypoint_mask", "keypoint_mask"))
    if optimizer is not None:
        wraps += [(model, "assign_targets", "anchor_targets"),
                  (pointpillar_mod, "anchor_head_loss", "rpn_loss"),
                  (roi_head, "assign_roi_targets", "roi_targets"),
                  (roi_head, "roi_head_loss", "rcnn_loss"),
                  (second_iou_mod, "iou_loss", "rcnn_loss"),
                  (torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
        if hasattr(model, "vsa_pools"):
            wraps.append((model, "source_loss", "kp_seg_loss"))
        if hasattr(model, "unet"):
            wraps.append((model, "part_loss", "part_loss"))
    return timed_spans(wraps, run, batch)


def two_stage_profile(model, run, batches, optimizer=None):
    """Where a two-stage voxel detector's step goes, `run(batch)` running an
    eval step or (given its `optimizer`) a train step through to its result
    on the host: phase_ms, the median over the batches of each span's
    exclusive ms (`two_stage_phase_times`); keep_scan (`keep_scans`); for
    PV-RCNN and PV-RCNN++ fps_share, the FPS span's share of the
    instrumented step."""
    phases = [two_stage_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    out = {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys}}
    if hasattr(model, "vsa_pools"):
        out["fps_share"] = statistics.median(
            sum(v for k, v in p.items() if k.endswith("fps")) / p["step"] for p in phases)
    out["keep_scan"] = keep_scans(run, batches)
    return out


TWO_STAGE = {"second_iou": second_iou, "voxel_rcnn": voxel_rcnn, "pv_rcnn": pv_rcnn,
             "parta2": parta2, "pv_rcnn_plusplus": pv_rcnn_plusplus}


def kitti_workload(cfg, work, num_batches: int, batch_size: int, training: bool = False):
    """`num_batches` batches of `batch_size` frames of a synthetic KITTI root
    written under `work` (`zoo.write_pointrcnn_root`: 40,000-60,000 points
    in the camera frustum, 20-40 boxes of the config's classes; in train
    mode with its gt database), read through KittiDataset."""
    info = write_pointrcnn_root(cfg, Path(work), num_batches * batch_size, training=training)
    return kitti_batches(cfg, work, info, num_batches, batch_size, training=training)


def nuscenes_workload(cfg, work, num_batches: int, training: bool = False):
    """`num_batches` batches of a synthetic nuScenes root written under
    `work` (NUSCENES_BATCH_SIZE key frames each, 10 sweeps of 34,000
    points, 20-40 boxes of the ten classes), read through NuScenesDataset."""
    from .data import nuscenes_synthetic

    n = NUSCENES_BATCH_SIZE * num_batches
    written = nuscenes_synthetic.write_root(work, n_train=n if training else 0,
                                            n_val=0 if training else n)
    info = nuscenes_synthetic.write_infos(work, written)["train" if training else "val"]
    return nuscenes_batches(cfg, work, info, num_batches, training=training)


def keep_scans(run, batches):
    """Runs each batch once, `run(batch)`, with the NMS keep-scan timed: per
    call, the IoU matrix's shape, the scan's fixed-point iterations (one
    host sync each, plus one) and its host-clock ms."""
    scans, orig = [], nms_mod._suppression_scan

    def timed(iou_mat, valid, thresh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep, iterations = orig(iou_mat, valid, thresh)
        torch.cuda.synchronize()
        scans.append({"shape": list(iou_mat.shape), "iterations": iterations,
                      "ms": (time.perf_counter() - t0) * 1e3})
        return keep, iterations

    nms_mod._suppression_scan = timed
    try:
        for batch in batches:
            run(batch)
    finally:
        nms_mod._suppression_scan = orig
    return scans


def pointrcnn_profile(model, run, batches, optimizer=None):
    """Where a PointRCNN step's time goes, `run(batch)` running an eval
    step or (given its `optimizer`) a train step through to its result on
    the host: phase_ms, the median over the batches of
    each span's exclusive ms (`pointrcnn_phase_times`); fps_ms and
    fps_share, the FPS spans' ms and their share of the instrumented step
    (medians); the FPS iterations per step; keep_scan, `keep_scans` over the
    batches."""
    phases = [pointrcnn_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    fps_ms = [sum(v for k, v in p.items() if k.endswith(".fps")) for p in phases]
    return {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys},
            "fps_ms": statistics.median(fps_ms),
            "fps_share": statistics.median(f / p["step"] for f, p in zip(fps_ms, phases)),
            "fps_iterations_per_step": sum(getattr(model.backbone, f"sa_{i}").npoint
                                           for i in range(model.backbone.num_levels))
            + sum(n for n in model.roi_head.sa_npoints if n > 0),
            "keep_scan": keep_scans(run, batches)}


def device_profile(run, steps: int):
    """torch.profiler over run(), which runs `steps` steps and waits for
    their results: (the profile, {wall and device-busy ms per step, the idle
    share of the window, device time by kernel name}). Ranges
    (record_function) also appear on the device's timeline; only kernels
    and copies count as busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            us = evt.time_range.elapsed_us()
            busy_us += us
            by_name[evt.name][0] += us
            by_name[evt.name][1] += 1
    if busy_us == 0:
        return prof, {"device_time": "not measured (the profiler saw no device events)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return prof, {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "top_kernels": [{"name": k[:120], "ms_per_step": v[0] / steps / 1e3,
                         "calls_per_step": v[1] / steps} for k, v in top],
    }


def _profile(step, batches):
    def run():
        for batch in batches:
            _run(step, batch)

    return device_profile(run, len(batches))[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("pillar", "voxel", "pointrcnn", "second", "pp",
                                         *TWO_STAGE), default="pillar")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    build = {"pillar": flagship, "voxel": voxel_centerpoint, "pointrcnn": pointrcnn,
             "second": second_multihead, "pp": pp_multihead, **TWO_STAGE}[args.model]
    cfg, grid, model = build(device="cuda")
    seeded_weights_(model, seed=0)
    step = make_eval_step(model, RECALL_THRESH, device="cuda", dtype=torch.bfloat16)
    if args.model == "pointrcnn":
        with tempfile.TemporaryDirectory() as work:
            info = write_pointrcnn_root(cfg, Path(work), POINTRCNN_BATCH_SIZE * args.batches)
            batches = pointrcnn_batches(cfg, Path(work), info, args.batches)
        workload = ("PointRCNN pointrcnn_nuscenes2kitti (4.04 M parameters), B=4 synthetic "
                    "KITTI frames sampled to 16384 points (40000-60000 in the frustum, 20-40 "
                    "boxes)")
    elif args.model in TWO_STAGE:
        with tempfile.TemporaryDirectory() as work:
            batches = kitti_workload(cfg, Path(work), args.batches, 4)
        workload = (f"{cfg.MODEL.NAME} {args.model} 1408x1600x40 grid, max_voxels 40000, B=4 "
                    "synthetic KITTI frames (40000-60000 points in the frustum, at most 32768 "
                    "per frame, 20-40 boxes)")
    elif args.model in ("second", "pp"):
        with tempfile.TemporaryDirectory() as work:
            batches = nuscenes_workload(cfg, Path(work), args.batches)
        workload = (("SECOND cbgs_second_multihead 1024x1024x40 grid, max_voxels 60000"
                     if args.model == "second" else "PointPillar cbgs_pp_multihead 512x512")
                    + ", AnchorHeadMulti, B=4 synthetic nuScenes key frames with 9 sweeps "
                      "(34000 points each, at most 65536 per frame, 20-40 boxes)")
    else:
        batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s) for s in range(args.batches)]
        workload = ("flagship CenterPoint-pillar 256x512 BEV" if args.model == "pillar" else
                    "voxel CenterPoint 1024x1024x40 grid, max_voxels 60000") + \
            ", B=4, 60000 points, 256 gt slots"
    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        step(batch)
    torch.cuda.synchronize()

    step_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        _run(step, batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)

    if args.model == "pointrcnn":
        extra = pointrcnn_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
    elif args.model in ("second", "pp"):
        extra = anchor_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
    elif args.model in TWO_STAGE:
        extra = two_stage_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
    else:
        phases = [_phase_times(model, step, b) for b in batches]
        phase_ms = {k: statistics.median(p[k] for p in phases) for k in phases[0]}
        extra, scans = {}, keep_scans(step, batches)

    result = {
        "device": smi.stdout.strip(),
        "workload": workload + ", bf16 autocast, seeded random weights",
        "batches": args.batches,
        "step_ms": {"median": statistics.median(step_ms), "all": step_ms},
        "phase_ms": phase_ms,
        **extra,
        "nms_scan": {"calls_per_step": len(scans) / len(batches),
                     "shapes": sorted({tuple(s["shape"]) for s in scans}),
                     "iterations": [s["iterations"] for s in scans],
                     "host_syncs_per_call": [s["iterations"] + 1 for s in scans],
                     "ms": [s["ms"] for s in scans]},
        # PointRCNN's trace holds ~50,000 launches a step: two steps suffice
        "profile": _profile(step, batches[:2] if args.model == "pointrcnn" else batches),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
