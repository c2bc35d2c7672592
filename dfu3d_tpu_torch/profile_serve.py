"""Where the serving time goes, on the card.

    python -m dfu3d_tpu_torch.profile_serve [--model pillar|voxel|pointrcnn|second|pp|
                                                     second_iou|voxel_rcnn|pv_rcnn|
                                                     parta2|pv_rcnn_plusplus|voxelnext|
                                                     voxelnext_tta|voxelnext_iou_large|
                                                     pillarnet|pillarnet_waymo|transfusion|
                                                     dsvt_pillar|dsvt_voxel|mppnet|
                                                     mppnet_16|mppnet_e2e|bevfusion|
                                                     caddn|voxel_rcnn_focal]
                                            [--batches 8] [--out FILE.json]

Runs an eval step (`make_eval_step`) at full width: the flagship
CenterPoint-pillar (256 x 512 BEV), voxel CenterPoint
(cbgs_voxel01_res3d_centerpoint, 1024 x 1024 x 40 grid), PointRCNN
(pointrcnn_nuscenes2kitti), SECOND multi-head (cbgs_second_multihead,
1024 x 1024 x 40 grid, max_voxels 60,000) or PointPillar multi-head
(cbgs_pp_multihead, 512 x 512 pillars), or one of the two-stage KITTI
detectors (second_iou.yaml, voxel_rcnn_car.yaml, pv_rcnn.yaml, PartA2.yaml,
pv_rcnn_plusplus.yaml, 1408 x 1600 x 40 grid, max_voxels 40,000), or one of the
fully sparse detectors (`zoo.voxelnext`, `voxelnext_tta`,
`voxelnext_iou_large`, `pillarnet`, `pillarnet_waymo`: nuScenes, Waymo and
KITTI configs, built as the CLIs build them), or TransFusion-L
(`zoo.transfusion`, transfusion_lidar, 1440 x 1440 x 40 grid, max_voxels
160,000), or DSVT-Pillar / DSVT-Voxel (`zoo.dsvt_pillar`, `zoo.dsvt_voxel`,
the Waymo DSVT configs, 468 x 468 (x 32) grid, 60,000 voxels per frame, on
`waymo_batches`), or MPPNet (`zoo.mppnet_4frames`, `mppnet_16frames`) or
MPPNetE2E (`zoo.mppnet_e2e`, through its memory bank over one sequence of
requests 0.1 s apart) on the Waymo MPPNet configs (1504 x 1504 x 40 grid,
150,000 voxels per frame, B=2 on `waymo_sequence_batches`: 150,000 points
per frame, 4 or 16 frames), or a camera detector (`zoo.bevfusion`,
`zoo.caddn`, `zoo.voxel_rcnn_focal` on bevfusion.yaml, CaDDN.yaml,
voxel_rcnn_focal.yaml, B=4 on `zoo.camera_batches`, with the BN
statistics of the first batch). CenterPoint: B=4, 60,000 uniform
points in a 50 m extent, 256 gt slots. PointRCNN: B=4 frames of a
synthetic KITTI root (40,000-60,000 points in the camera frustum, 20-40
boxes; uniform points would give PointNet++'s 0.1 m balls no neighbours)
read through KittiDataset in test mode, so 16,384 sampled points each.
SECOND, PointPillar, VoxelNeXt and TransFusion: B=4 key frames of a synthetic nuScenes root
(`data.nuscenes_synthetic`: 10 sweeps of 34,000 points, 20-40 boxes of the
ten classes) read through NuScenesDataset in test mode, at most 65,536
points each. The two-stage detectors: B=4 frames of a synthetic KITTI
root (40,000-60,000 points in the frustum, 20-40 boxes of the config's
classes) read through KittiDataset in test mode, at most 32,768 points
each. bf16 autocast, weights from `seeded_weights_` (the fully sparse
detectors but PillarNet Waymo with the BN statistics of the first batch,
`calibrate_bn_`, as chip_smoke.py serves them). It reports,
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
  final NMS, the recall IoU; the fully sparse detectors: the spans of
  `fully_sparse_phase_times`: voxelize, tables, the trunk's convs with
  their B2 launches, VoxelNeXt's BEV collapse, conv_out + shared conv,
  heads and double-flip merge, PillarNet's height compression, conv5 and
  neck, the decode, the NMS with B1 and the keep-scan, the recall IoU;
  transfusion: the spans of `transfusion_phase_times`: voxelize, tables,
  the trunk with B2, height compression, 2D backbone, shared conv + heat
  map, query init (local max, top-K), position embeddings, self- and
  cross-attention, FFN, branches, decode, the recall IoU with B1; dsvt:
  the spans of `dsvt_phase_times`: voxelize + VFE, the partition (sorts,
  ranks, set ids, the voxel model's pool indices), position embeddings,
  set attention (with the set buffers' scatter and gather), FFN + norms,
  the voxel model's pools, the BEV scatter, 2D backbone, head, decode, the
  NMS with B1 and its keep-scan, the recall IoU with B1; and set_shares,
  the share of each frame's voxels that reach a set in each layer; mppnet:
  the spans of `mppnet_phase_times`: voxelize + VFE, tables, the trunk
  with B2, 2D backbone, anchor head, proposals with B1 and the keep-scan,
  the trajectory with B1, crops, geometry MLP, proxy pooling, motion,
  group fusion, encoder layers, heads, refine, the bank match with B1, the
  recall IoU with B1; and the dead frames' share of the head; the camera
  detectors: the spans of `camera_phase_times`, and for the focal Voxel
  R-CNN the dilated voxels each focal layer kept against its cap);
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
from .flagship import calibrate_bn_, flagship, seeded_weights_
from .core.voxel import gather_gemm_kernel
from .models import pointpillar as pointpillar_mod
from .models import pointrcnn as pointrcnn_mod
from .models import roi_head
from .models import second_iou as second_iou_mod
from .train import train_state
from .train.train_state import make_eval_step
from .zoo import (CAMERA_RIGS, NUSCENES_BATCH_SIZE, POINTRCNN_BATCH_SIZE, bevfusion,
                  camera_batches, caddn, dsvt_pillar, dsvt_voxel, voxel_rcnn_focal,
                  kitti_batches, mppnet_16frames, mppnet_4frames, mppnet_e2e, nuscenes_batches,
                  parta2, pillarnet, pillarnet_waymo, pointrcnn, pointrcnn_batches, pp_multihead,
                  pv_rcnn, pv_rcnn_plusplus, second_iou, second_multihead, transfusion,
                  voxel_centerpoint, voxel_rcnn, voxelnext, voxelnext_iou_large, voxelnext_tta,
                  waymo_batches, waymo_sequence_batches, write_pointrcnn_root)

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


def fully_sparse_phase_times(model, run, batch, optimizer=None):
    """One step of VoxelNeXt or PillarNet, `run(batch)` (an eval step, or
    with its `optimizer` a train step), with every span of `Spans` timed:
    the voxelize (MeanVFE, or PillarNet's pillar VFE), the neighbour tables
    (the trunk's `plan`; VoxelNeXt's BEV tables), the trunk's sparse convs
    with their B2 launches; VoxelNeXt: the BEV collapse, conv_out + the
    shared conv, the heads, the double-flip merge; PillarNet: the height
    compression, the dense conv5 stage, the V1 neck, the head; then the
    decode with the NMS (B1 and the keep-scan) and the recall IoU (B1). A
    train step adds the targets, the loss, the backward (with B2's dX
    launches) and the clip + optimizer update."""
    from .models import losses as losses_mod
    from .models import pillarnet as pillarnet_mod
    from .models import voxelnext as voxelnext_mod

    wraps = [(model.vfe, "forward", "voxelize"), (model.backbone_3d, "plan", "tables"),
             (model.backbone_3d, "forward", "backbone_convs"),
             (gather_gemm_kernel, "gather_gemm", "b2"), (iou_kernel, "overlap_bev", "b1"),
             (nms_mod, "_suppression_scan", "keep_scan"),
             (train_state, "pairwise_iou3d", "recall_iou")]
    if isinstance(model, voxelnext_mod.VoxelNeXt):
        wraps += [(model, "bev_tables", "tables"),
                  (voxelnext_mod, "sparse_bev_collapse", "bev_collapse"),
                  (model.conv_out, "forward", "conv_out_shared"),
                  (model.shared_conv, "forward", "conv_out_shared"),
                  (model, "merge_double_flip", "tta_merge"), (model, "decode", "decode"),
                  (voxelnext_mod, "nms_bev", "nms")]
        wraps += [(getattr(model, f"head_{g}"), "forward", "head")
                  for g in range(len(model.class_groups))]
        loss_fns = [(losses_mod, "focal_loss_centernet"), (losses_mod, "reg_loss_centernet"),
                    (voxelnext_mod, "aligned_iou3d")]
    else:
        wraps += [(pillarnet_mod, "height_compression", "height_compression"),
                  (model.conv5_down, "forward", "conv5"), (model.conv5_a, "forward", "conv5"),
                  (model.conv5_b, "forward", "conv5"), (model.backbone_2d, "forward", "neck"),
                  (model.dense_head, "forward", "head")]
        if hasattr(model, "anchors_flat"):
            wraps += [(pointpillar_mod, "decode_anchor_predictions", "decode"),
                      (pointpillar_mod, "nms_bev", "nms")]
            loss_fns = [(pointpillar_mod, "anchor_head_loss")]
        else:
            wraps += [(model.dense_head, "generate_predicted_boxes", "decode")]
            loss_fns = [(model.dense_head, "get_loss")]
    if optimizer is not None:
        wraps += [(torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer"),
                  (model.dense_head, "assign_targets", "targets") if hasattr(model, "dense_head")
                  and not hasattr(model, "anchors_flat") else (model, "assign_targets", "targets")]
        wraps += [(obj, attr, "loss") for obj, attr in loss_fns]
    return timed_spans(wraps, run, batch)


def fully_sparse_profile(model, run, batches, optimizer=None):
    """Where a VoxelNeXt or PillarNet step goes, `run(batch)` running an eval
    step or (given its `optimizer`) a train step through to its result on
    the host: phase_ms, the median over the batches of each span's
    exclusive ms (`fully_sparse_phase_times`), and keep_scan
    (`keep_scans`)."""
    phases = [fully_sparse_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    return {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys},
            "keep_scan": keep_scans(run, batches)}


def transfusion_phase_times(model, run, batch, optimizer=None):
    """One TransFusion step, `run(batch)` (an eval step, or with its
    `optimizer` a train step), with every span of `Spans` timed: voxelize
    (MeanVFE), the neighbour tables, the trunk's sparse convs with their B2
    launches, the height compression, the 2D backbone, the shared conv and
    the dense heat map, the query init (its local max and top-K apart),
    the position embeddings, the self-attention, the cross-attention, the
    FFN, the branches, the decode and the recall IoU with its B1 launch. A
    train step adds the heat-map targets, the assignment cost, the host
    Hungarian, the losses, the backward (with B2's dX launches) and the
    clip + optimizer update."""
    from .models import transfusion as transfusion_mod
    from .models import transfusion_head as head_mod

    head = model.dense_head
    wraps = [(model.vfe, "forward", "voxelize"), (model.backbone_3d, "plan", "tables"),
             (model.backbone_3d, "forward", "trunk"), (gather_gemm_kernel, "gather_gemm", "b2"),
             (transfusion_mod, "height_compression", "height_compression"),
             (model.backbone_2d, "forward", "backbone_2d"),
             (head, "heatmap", "shared_conv_heatmap"), (head, "init_queries", "query_init"),
             (head, "local_max", "local_max"), (head_mod, "top_k", "top_k"),
             (head.self_posembed, "forward", "position_embedding"),
             (head.cross_posembed, "forward", "position_embedding"),
             (head.self_attn, "forward", "self_attention"),
             (head.cross_attn, "forward", "cross_attention"),
             (head.linear1, "forward", "ffn"), (head.linear2, "forward", "ffn"),
             (head, "branch", "branches"), (head, "decode", "decode"),
             (iou_kernel, "overlap_bev", "b1"), (train_state, "pairwise_iou3d", "recall")]
    if optimizer is not None:
        wraps += [(head, "heatmap_targets", "heatmap_targets"), (head, "match_cost", "cost"),
                  (head_mod, "hungarian_match", "hungarian"),
                  (head_mod, "greedy_match", "greedy"), (head, "loss", "losses"),
                  (torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


def transfusion_profile(model, run, batches, optimizer=None):
    """Where a TransFusion step goes, `run(batch)` running an eval step or
    (given its `optimizer`) a train step through to its result on the host:
    phase_ms, the median over the batches of each span's exclusive ms
    (`transfusion_phase_times`); in training also the host Hungarian's
    calls per step (each copies its cost to the host once: one sync) and
    their host ms."""
    from .models import transfusion_head as head_mod

    calls = []
    solve = head_mod.hungarian_match

    def counted(cost, gt_valid):
        t0 = time.perf_counter()
        try:
            return solve(cost, gt_valid)
        finally:
            calls.append((time.perf_counter() - t0) * 1e3)

    head_mod.hungarian_match = counted
    try:
        phases = [transfusion_phase_times(model, run, b, optimizer) for b in batches]
    finally:
        head_mod.hungarian_match = solve
    keys = sorted({k for p in phases for k in p})
    out = {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys}}
    if optimizer is not None:
        out["hungarian_calls_per_step"] = len(calls) / len(batches)
        out["hungarian_host_ms"] = statistics.median(calls) if calls else 0.0
    return out


def dsvt_phase_times(model, run, batch, optimizer=None):
    """One step of a DSVT CenterPoint, `run(batch)` (an eval step, or with
    its `optimizer` a train step), with every span of `Spans` timed:
    voxelize + VFE, the partition (the backbone's `plan`: sorts, ranks, set
    ids, the voxel model's pool indices), the position embeddings, the set
    attention (the set buffers' scatter and gather with it), the FFN and the
    norms, the voxel model's pools, the BEV scatter, the 2D backbone, the
    head, the decode with the NMS (B1 and the keep-scan) and the recall IoU
    (B1). A train step adds the targets, the loss, the backward and the
    clip + optimizer update."""
    from .models import dsvt as dsvt_mod

    wraps = [(model.vfe, "forward", "voxelize_vfe"), (model.backbone_3d, "plan", "partition"),
             (dsvt_mod, "position_embedding", "position_embeddings"),
             (dsvt_mod, "to_sets", "set_attention"), (dsvt_mod, "from_sets", "set_attention"),
             (dsvt_mod, "set_attention", "set_attention"), (dsvt_mod, "ffn_norms", "ffn_norms"),
             (dsvt_mod, "block_norm", "ffn_norms"), (dsvt_mod, "pool", "pools"),
             (dsvt_mod, "scatter_bev", "bev_scatter"),
             (model.backbone_2d, "forward", "backbone_2d"), (model.dense_head, "forward", "head"),
             (model.dense_head, "generate_predicted_boxes", "decode"),
             (iou_kernel, "overlap_bev", "b1"), (nms_mod, "_suppression_scan", "keep_scan"),
             (train_state, "pairwise_iou3d", "recall_iou")]
    if optimizer is not None:
        wraps += [(model.dense_head, "assign_targets", "targets"),
                  (model.dense_head, "get_loss", "loss"), (torch.Tensor, "backward", "backward"),
                  (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


@torch.no_grad()
def dsvt_set_shares(model, batch):
    """The share of each frame's valid voxels that reach a set, per layer
    ([layer][frame]), with the frame's occupied cells before and after the
    voxel cap: the pooled B · MAX_SETS cap hands the sets out first-come
    over the batch."""
    from .core.voxel import dynamic_voxelize
    from .models import dsvt as dsvt_mod

    dev = next(model.parameters()).device
    batch = batch.to(dev)
    b = batch.points.shape[0]
    vox = dynamic_voxelize(model.vfe.grid, batch.points, batch.points_valid,
                           model.vfe.max_voxels)
    plans = dsvt_mod.dsvt_plan(model.vfe, model.backbone_3d, batch.points, batch.points_valid)
    return {"set_shares": dsvt_mod.set_shares(plans, b),
            "occupied_cells_per_frame": vox.num_unique.tolist(),
            "voxels_per_frame": vox.num_voxels.tolist(),
            "max_sets_per_frame": model.backbone_3d.max_sets}


def dsvt_profile(model, run, batches, optimizer=None):
    """Where a DSVT step goes, `run(batch)` running an eval step or (given
    its `optimizer`) a train step through to its result on the host:
    phase_ms, the median over the batches of each span's exclusive ms
    (`dsvt_phase_times`), keep_scan (`keep_scans`, serving only) and the
    first batch's `dsvt_set_shares`."""
    phases = [dsvt_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    return {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys},
            "keep_scan": keep_scans(run, batches) if optimizer is None else [],
            **dsvt_set_shares(model, batches[0])}


# the head's spans whose work is per frame computed from points
MPPNET_FRAME_SPANS = ("crops", "geometry_mlp", "proxy_pooling", "motion")
MPPNET_HEAD_SPANS = MPPNET_FRAME_SPANS + ("group_fusion", "encoder", "heads")


def mppnet_phase_times(model, run, batch, optimizer=None):
    """One step of MPPNet or MPPNetE2E, `run(batch)` (an eval step, a bank
    step, or with its `optimizer` a train step), with every span of `Spans`
    timed: voxelize + VFE, the neighbour tables, the trunk with its B2
    launches, the 2D backbone, the anchor head, the proposals with their B1
    launch and keep-scan, the trajectory with its B1 launches, the crops,
    the geometry MLP, the proxy pooling (its ball queries apart), the
    motion stream, the group fusion, the encoder layers, the heads and the
    trajectory branch, the refine, the bank match with its B1 launch, the
    recall IoU with its B1 launch; a train step adds the anchor targets, the
    anchor loss, the RoI targets with their B1 launch, the head losses, the
    backward (B2's dX) and the clip + optimizer update."""
    head = model.roi_head
    wraps = [(model.vfe, "forward", "voxelize_vfe"), (model.backbone_3d, "plan", "tables"),
             (model.backbone_3d, "forward", "trunk"), (gather_gemm_kernel, "gather_gemm", "b2"),
             (model.backbone_2d, "forward", "backbone_2d"),
             (model.dense_head, "forward", "anchor_head"), (model, "proposals", "proposals"),
             (model, "trajectory", "trajectory"), (head, "crops", "crops"),
             (head, "geometry_features", "geometry_mlp"),
             (head, "pool_to_proxies", "proxy_pooling"), (pointnet2, "ball_query", "ball_query"),
             (head, "motion_features", "motion"), (head, "group_frames", "group_fusion"),
             (head, "encode", "encoder"), (head, "heads", "heads"), (model, "refine", "refine"),
             (iou_kernel, "overlap_bev", "b1"), (nms_mod, "_suppression_scan", "keep_scan"),
             (train_state, "pairwise_iou3d", "recall_iou")]
    if hasattr(model, "match_bank"):
        wraps.append((model, "match_bank", "bank_match"))
    if optimizer is not None:
        wraps += [(model, "assign_targets", "anchor_targets"), (model, "rpn_loss", "anchor_loss"),
                  (roi_head, "assign_roi_targets", "roi_targets"),
                  (model, "head_losses", "head_losses"),
                  (torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


def mppnet_dead_frames(head):
    """The frames no group reads (JAX's (gi + j · stride) % T arrangement)."""
    read = {f for frames in head.frame_groups() for f in frames}
    return [f for f in range(head.num_frames) if f not in read]


def mppnet_profile(model, run, batches, optimizer=None, fresh_frames=None):
    """Where an MPPNet step goes, `run(batch)` running an eval step, a bank
    step or (given its `optimizer`) a train step through to its result on
    the host: phase_ms, the median over the batches of each span's
    exclusive ms (`mppnet_phase_times`); keep_scan (`keep_scans`, serving
    only); dead_frames, the frames that feed no group, and
    dead_frame_share_of_head, the share of the head's spans spent on them:
    the per-frame spans (crops, geometry MLP, proxy pooling, motion) times
    the dead frames' share of the frames computed (`fresh_frames`, default
    all; a bank step computes frame 0's geometry only, its motion for all),
    over the head's spans."""
    phases = [mppnet_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    phase_ms = {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys}
    head = model.roi_head
    dead = mppnet_dead_frames(head)
    t = head.num_frames
    fresh = fresh_frames or t

    def span(name):   # with its nested spans
        return sum(v for k, v in phase_ms.items() if k == name or k.startswith(name + "."))

    def dead_share(frames):   # of the first `frames` frames, those no group reads
        return sum(f < frames for f in dead) / frames

    per_frame = sum(span(k) * dead_share(t if k == "motion" else fresh)
                    for k in MPPNET_FRAME_SPANS)
    head_ms = sum(span(k) for k in MPPNET_HEAD_SPANS)
    return {"phase_ms": phase_ms,
            "keep_scan": keep_scans(run, batches) if optimizer is None else [],
            "dead_frames": dead, "head_ms": head_ms,
            "dead_frame_share_of_head": per_frame / head_ms if head_ms else 0.0}


def camera_phase_times(model, run, batch, optimizer=None):
    """One step of a camera detector, `run(batch)` (an eval step, or with
    its `optimizer` a train step), with every span of `Spans` timed.
    BevFusion: the Swin stages, the FPN, the depth net, the geometry,
    bev_pool, the rest of the view transform (its downsample convs), the
    lidar trunk (voxelize, tables, the sparse convs with B2), the fuser,
    the 2D backbone, the head, the decode, the recall IoU with B1. CaDDN:
    the ResNet layers (or the compact DDN), ASPP, the frustum features,
    frustum_to_voxel, the collapse, the 2D backbone, the head, the decode,
    the NMS with B1 and its keep-scan, the recall IoU. The focal Voxel
    R-CNN: the image convs with the projection, the focal layers (their
    importance and main convs with B2), the rest of the trunk (VFE, tables,
    the other sparse convs), the 2D backbone, the RPN, the proposals, the
    RoI pooling and head, the final NMS, the recall IoU. A train step adds
    its targets and losses (CaDDN's depth loss apart), the backward and the
    clip + optimizer update."""
    from .models import caddn as caddn_mod
    from .models.image import depth_lss as lss_mod

    wraps = [(iou_kernel, "overlap_bev", "b1"), (gather_gemm_kernel, "gather_gemm", "b2"),
             (nms_mod, "_suppression_scan", "keep_scan"),
             (train_state, "pairwise_iou3d", "recall_iou"),
             (model.backbone_2d, "forward", "backbone_2d")]
    name = type(model).__name__
    if name == "BevFusion":
        vt = model.vtransform
        wraps += [(model.image_backbone, "run_stage", "swin_stages"),
                  (model.image_neck, "forward", "fpn"), (vt, "depth_net", "depth_net"),
                  (vt, "get_geometry", "geometry"), (lss_mod, "bev_pool", "bev_pool"),
                  (vt, "forward", "view_transform"), (model, "lidar_bev", "trunk"),
                  (model.fuser, "forward", "fuser"), (model.dense_head, "forward", "head"),
                  (model.dense_head, "decode", "decode")]
        if optimizer is not None:
            wraps.append((model.dense_head, "loss", "loss"))
    elif name == "CaDDN":
        ddn = model.ddn
        wraps += ([(ddn, "resnet_layer", "resnet"), (ddn.aspp, "forward", "aspp")]
                  if hasattr(ddn, "aspp") else [(ddn, "forward", "ddn")])
        wraps += [(model, "frustum_features", "frustum_features"),
                  (caddn_mod, "frustum_to_voxel", "frustum_to_voxel"),
                  (model, "collapse", "collapse"), (model.dense_head, "forward", "head"),
                  (model, "decode", "decode")]
        if optimizer is not None:
            wraps += [(model, "assign_targets", "anchor_targets"),
                      (pointpillar_mod, "anchor_head_loss", "rpn_loss"),
                      (model, "depth_loss", "depth_loss")]
    else:   # the focal Voxel R-CNN
        enc = model.encoder
        wraps += [(model.vfe, "forward", "vfe"), (enc, "forward", "trunk"),
                  *[(getattr(enc, f"focal{s}"), "forward", "focal_layers") for s in (1, 2, 3)],
                  (model.dense_head, "forward", "dense_head"), (model, "proposals", "proposals"),
                  (roi_head, "final_nms", "final_nms")]
        if model.use_img:
            wraps.append((model, "voxel_image_feats", "image_convs"))
        heads = [n for n in ("shared_fc", "cls_fc", "reg_fc", "cls_pred", "reg_pred")]
        wraps += [(getattr(model, n), "forward", "roi_head") for n in heads]
        wraps += [(m, "forward", "roi_pool") for n, m in model.named_children()
                  if n.startswith("pool_")]
        if optimizer is not None:
            wraps += [(model, "assign_targets", "anchor_targets"),
                      (pointpillar_mod, "anchor_head_loss", "rpn_loss"),
                      (roi_head, "assign_roi_targets", "roi_targets"),
                      (roi_head, "roi_head_loss", "rcnn_loss")]
    if optimizer is not None:
        wraps += [(torch.Tensor, "backward", "backward"), (optimizer, "step", "clip_optimizer")]
    return timed_spans(wraps, run, batch)


def focal_dilation(model, run, batch):
    """Per focal layer of one step: its dilate_cap and the dilated voxels it
    kept per frame (the cap binds where they reach it)."""
    kept = {}
    layers = [(s, getattr(model.encoder, f"focal{s}")) for s in (1, 2, 3)]
    for s, layer in layers:
        def counted(*a, layer=layer, s=s):
            coords, valid = type(layer).dilate(layer, *a)
            kept[f"focal{s}"] = {"dilate_cap": layer.dilate_cap,
                                 "kept_per_frame": valid.sum(1).tolist()}
            return coords, valid
        layer.dilate = counted
    try:
        run(batch)
    finally:
        for _, layer in layers:
            del layer.dilate
    return kept


def camera_profile(model, run, batches, optimizer=None):
    """Where a camera detector's step goes, `run(batch)` running an eval
    step or (given its `optimizer`) a train step through to its result on
    the host: phase_ms, the median over the batches of each span's
    exclusive ms (`camera_phase_times`); keep_scan (`keep_scans`, serving);
    for the focal Voxel R-CNN focal_dilation (`focal_dilation`, first
    batch)."""
    phases = [camera_phase_times(model, run, b, optimizer) for b in batches]
    keys = sorted({k for p in phases for k in p})
    out = {"phase_ms": {k: statistics.median(p.get(k, 0.0) for p in phases) for k in keys},
           "keep_scan": keep_scans(run, batches) if optimizer is None else []}
    if hasattr(model, "encoder") and hasattr(model.encoder, "focal1"):
        out["focal_dilation"] = focal_dilation(model, run, batches[0])
    return out


CAMERA = {"bevfusion": bevfusion, "caddn": caddn, "voxel_rcnn_focal": voxel_rcnn_focal}
CAMERA_RIG = {"bevfusion": "nuscenes", "caddn": "kitti", "voxel_rcnn_focal": "kitti"}


def camera_workload(name, cfg, num_batches: int, training: bool = False):
    """The batches of a camera model's cell, `zoo.camera_batches` on its rig
    (B=4: nuScenes' six cameras at 256 x 704 or KITTI's front camera at
    375 x 1242), and their description."""
    rig = CAMERA_RIG[name]
    size = CAMERA_RIGS[rig]
    return (camera_batches(cfg, num_batches, rig, size, seed=1 if training else 0),
            f"B=4 frames made in memory (zoo.camera_batches: {rig} rig, "
            f"{'6 cameras' if rig == 'nuscenes' else '1 camera'} at {size[0]}x{size[1]}, "
            f"{'65536 points with 9-sweep time lags' if rig == 'nuscenes' else '32768 points'}, "
            "depth maps projected from the points, 20-40 boxes)")


def mppnet_step(model, device="cuda", dtype=torch.bfloat16):
    """run(batch) → (boxes, scores, labels, valid, recall): the eval step of
    an MPPNet, or for MPPNetE2E one request of a sequence through its memory
    bank, which the step carries from call to call (`run.reset(batch_size)`
    starts a sequence with an empty bank; `run.bank()` is the bank)."""
    from .models.mppnet import make_bank_eval_step

    if not hasattr(model, "predict_with_bank"):
        step = make_eval_step(model, RECALL_THRESH, device=device, dtype=dtype)
        step.reset = lambda batch_size: None
        return step
    bank_step = make_bank_eval_step(model, RECALL_THRESH, device=device, dtype=dtype)
    state = {}

    def run(batch):
        if "bank" not in state:
            run.reset(batch.points.shape[0])
        out, state["bank"] = bank_step(batch, state["bank"])
        return out

    run.reset = lambda batch_size: state.update(bank=model.empty_bank(batch_size))
    run.bank = lambda: state["bank"]
    return run


DSVT = {"dsvt_pillar": dsvt_pillar, "dsvt_voxel": dsvt_voxel}
MPPNET = {"mppnet": mppnet_4frames, "mppnet_16": mppnet_16frames, "mppnet_e2e": mppnet_e2e}


FULLY_SPARSE = {"voxelnext": voxelnext, "voxelnext_tta": voxelnext_tta,
                "voxelnext_iou_large": voxelnext_iou_large, "pillarnet": pillarnet,
                "pillarnet_waymo": pillarnet_waymo}


def fully_sparse_workload(name, cfg, work, num_batches: int, training: bool = False):
    """The batches of a fully sparse model's cell: a synthetic nuScenes root
    (VoxelNeXt's nuScenes configs), a synthetic KITTI root (PillarNet's
    KITTI config) or `waymo_batches` (the Waymo configs, from memory), and
    its description."""
    if name in ("voxelnext", "voxelnext_tta"):
        return (nuscenes_workload(cfg, work, num_batches, training),
                "B=4 synthetic nuScenes key frames with 9 sweeps (34000 points each, at most "
                "65536 per frame, 20-40 boxes)")
    if name == "pillarnet":
        return (kitti_workload(cfg, work, num_batches, 4, training),
                "B=4 synthetic KITTI frames (40000-60000 points in the frustum, 20-40 boxes)")
    return (waymo_batches(cfg, num_batches, seed=1 if training else 0),
            "B=4 Waymo-range frames made in memory (zoo.waymo_batches: 150000 points, 20-40 "
            "boxes of Vehicle, Pedestrian, Cyclist)")


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


def cfg_max_voxels(model):
    """The voxel (or pillar) cap a model was built with."""
    return getattr(model.vfe, "max_voxels", None) or model.vfe.max_pillars


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
                                         *TWO_STAGE, *FULLY_SPARSE, "transfusion", *DSVT,
                                         *MPPNET, *CAMERA),
                    default="pillar")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    build = {"pillar": flagship, "voxel": voxel_centerpoint, "pointrcnn": pointrcnn,
             "second": second_multihead, "pp": pp_multihead, **TWO_STAGE,
             **FULLY_SPARSE, "transfusion": transfusion, **DSVT, **MPPNET, **CAMERA}[args.model]
    cfg, grid, model = build(device="cuda")
    seeded_weights_(model, seed=0)
    step = make_eval_step(model, RECALL_THRESH, device="cuda", dtype=torch.bfloat16)
    if args.model in MPPNET:
        e2e = args.model == "mppnet_e2e"
        step = mppnet_step(model)
        batches = waymo_sequence_batches(cfg, args.batches, model.num_frames, sequence=e2e)
        workload = (f"{cfg.MODEL.NAME} {args.model} {'x'.join(map(str, grid.grid_size))} grid, "
                    f"{cfg_max_voxels(model)} voxels per frame, {model.num_frames} frames in "
                    f"{model.roi_head.num_groups} groups, B=2 multi-frame Waymo-range scenes made "
                    "in memory (zoo.waymo_sequence_batches: 150000 points per frame, 20-40 "
                    "moving boxes of Vehicle, Pedestrian, Cyclist"
                    + ("; one sequence 0.1 s apart, through the memory bank)" if e2e else ")"))
    elif args.model in CAMERA:
        batches, data = camera_workload(args.model, cfg, args.batches)
        workload = f"{cfg.MODEL.NAME} {args.model} at full width, {data}"
    elif args.model == "pointrcnn":
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
    elif args.model in FULLY_SPARSE:
        with tempfile.TemporaryDirectory() as work:
            batches, data = fully_sparse_workload(args.model, cfg, Path(work), args.batches)
        workload = (f"{cfg.MODEL.NAME} {args.model} {'x'.join(map(str, grid.grid_size))} grid, "
                    f"max_voxels {cfg_max_voxels(model)}, {data}")
    elif args.model in DSVT:
        batches = waymo_batches(cfg, args.batches)
        workload = (f"CenterPoint {args.model} {'x'.join(map(str, grid.grid_size))} grid, "
                    f"{cfg_max_voxels(model)} voxels per frame, B=4 Waymo-range frames made in "
                    "memory (zoo.waymo_batches: 150000 points, 20-40 boxes of Vehicle, "
                    "Pedestrian, Cyclist)")
    elif args.model == "transfusion":
        with tempfile.TemporaryDirectory() as work:
            batches = nuscenes_workload(cfg, Path(work), args.batches)
        workload = ("TransFusion-L transfusion_lidar 1440x1440x40 grid, max_voxels 160000, B=4 "
                    "synthetic nuScenes key frames with 9 sweeps (34000 points each, at most "
                    "65536 per frame, 20-40 boxes)")
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
    if args.model in (*FULLY_SPARSE, "transfusion", *CAMERA) and args.model != "pillarnet_waymo":
        calibrate_bn_(model, batches[0])   # as chip_smoke.py's phases 15, 16 and 19 serve them
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
    elif args.model in FULLY_SPARSE:
        extra = fully_sparse_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
    elif args.model in DSVT:
        extra = dsvt_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
        torch.cuda.reset_peak_memory_stats()
        _run(step, batches[0])
        extra["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    elif args.model in MPPNET:
        step.reset(batches[0].points.shape[0])
        extra = mppnet_profile(model, lambda b: _run(step, b), batches,
                               fresh_frames=1 if args.model == "mppnet_e2e" else None)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
        torch.cuda.reset_peak_memory_stats()
        _run(step, batches[0])
        extra["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    elif args.model in CAMERA:
        extra = camera_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), extra.pop("keep_scan")
        torch.cuda.reset_peak_memory_stats()
        _run(step, batches[0])
        extra["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    elif args.model == "transfusion":   # no NMS, so no keep-scan
        extra = transfusion_profile(model, lambda b: _run(step, b), batches)
        phase_ms, scans = extra.pop("phase_ms"), []
        torch.cuda.reset_peak_memory_stats()
        _run(step, batches[0])
        extra["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
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
