"""Where the training time goes, on the card.

    python -m dfu3d_tpu_torch.profile_train [--model pillar|voxel|pointrcnn|second|
                                                     second_iou|voxel_rcnn|pv_rcnn|
                                                     parta2|pv_rcnn_plusplus]
                                            [--steps 8] [--out FILE.json]

Runs train steps (`make_train_step`) at full width: the flagship
CenterPoint-pillar (256 x 512 BEV) or voxel CenterPoint
(cbgs_voxel01_res3d_centerpoint, 1024 x 1024 x 40 grid, 10-column gt for its
vel branch), B=4, 60,000 uniform points in a 50 m extent, 256 gt slots (16
valid); or PointRCNN (pointrcnn_nuscenes2kitti), B=4 frames of a synthetic
KITTI root (40,000-60,000 points in the camera frustum, 20-40 boxes of the
config's classes) read through KittiDataset in train mode (gt sampling from
the root's gt database, flip, rotation, scaling, translation, then 16,384
sampled points), each batch with `zoo.proposal_gt`'s 16 gt per frame made
of the model's proposals just before its step, outside the timed step, so
that every step has RoIs over REG_FG_THRESH; or SECOND multi-head
(cbgs_second_multihead, 1024 x 1024 x 40 grid, max_voxels 60,000), B=4 key
frames of a synthetic nuScenes root (10 sweeps of 34,000 points, 20-40
boxes of the ten classes) read through NuScenesDataset in train mode
(class-balanced resampling, flip, rotation, scaling; no gt sampling: no
nuScenes gt database exists). bf16 autocast, weights from
`seeded_weights_`, the config's adam_onecycle over 1000 steps. It reports,
as one JSON object (printed, and written to --out):

* step_ms: host clock per step, no instrumentation (median over steps), and
  samples_per_s = 4 / step_ms; PointRCNN adds each step's rcnn_reg_loss
  and step_ms_after_profiler, three steps timed after torch.profiler has
  run in the process (slower on the host: the metric is read before it);
* phase_ms: the same step with a device sync at each phase boundary:
  upload; the features, split into the VFE (voxelize + MeanVFE on the voxel
  path), the neighbour and transpose tables (voxel only) and the backbones
  and head convs; targets + loss; backward; clip + optimizer. PointRCNN:
  the exclusive ms of each span of `profile_serve.pointrcnn_phase_times`
  (each SA level with its FPS and ball queries, each FP level with its
  3-NN, the point head, the point targets and losses, the proposal layer
  with its B1 launch and keep-scan, the RoI targets with their B1 launch,
  the RoI pooling, the RoI head with its FPS, the RCNN loss, the backward,
  clip + optimizer), with fps_share and the keep-scan's iterations.
  SECOND: the spans of `profile_serve.anchor_phase_times` with the
  optimizer: the VFE, the neighbour tables, the sparse convs with their B2
  launches, the 2D backbone, the head, the anchor targets, the loss, the
  backward with B2's dX launches, clip + optimizer. second_iou,
  voxel_rcnn, pv_rcnn (KITTI configs, B = BATCH_SIZE_PER_GPU frames of a
  synthetic KITTI root read in train mode with gt sampling, 16 gt per
  frame made of proposals as for PointRCNN): the spans of
  `profile_serve.two_stage_phase_times` with the optimizer;
* profile: torch.profiler over the steps: the device's busy ms per step, its
  idle share of the profiled window and of step_ms (the profiler stretches
  its window), device time by kernel name, and the sparse
  convs' split: B2's forward and dX launches (told apart by their order in
  each step: the forward's come first) and the dW gathers and matmuls (a
  profiler range around `sparse_backbone.weight_grad`).

Needs a CUDA device; numbers are tagged with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from .core.voxel import gather_gemm_kernel
from .data.batch import synthetic_batch
from .flagship import flagship, seeded_weights_
from .models import sparse_backbone
from .profile_serve import (TWO_STAGE, anchor_profile, device_profile, kitti_workload,
                            nuscenes_workload, pointrcnn_profile, two_stage_profile)
from .train.train_state import create_train_state, make_train_step
from .zoo import (POINTRCNN_BATCH_SIZE, pointrcnn, pointrcnn_batches, proposal_gt,
                  second_multihead, voxel_centerpoint, write_pointrcnn_root)

TOTAL_STEPS = 1000
B2_KERNELS = ("gather_gemm_tc_kernel", "gather_gemm_kernel")
DW_RANGE = "sparse_conv_dW"


def _phase_times(model, optimizer, step, batch):
    """One step with a sync and a host timestamp at each phase boundary."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    hooks = [model.vfe.register_forward_pre_hook(lambda m, a: mark("upload")),
             model.vfe.register_forward_hook(lambda m, a, o: mark("vfe")),
             model.dense_head.register_forward_hook(lambda m, a, o: mark("backbones_head"))]
    get_loss, opt_step = model.get_loss, optimizer.step
    voxel = model.use_voxel_backbone
    if voxel:
        plan = model.backbone_3d.plan

        def timed_plan(*a, **k):
            out = plan(*a, **k)
            mark("neighbour_tables")
            return out

        model.backbone_3d.plan = timed_plan

    def timed_loss(*a, **k):
        out = get_loss(*a, **k)
        mark("targets_loss")
        return out

    def timed_step():
        mark("backward")
        out = opt_step()
        mark("clip_optimizer")
        return out

    model.get_loss, optimizer.step = timed_loss, timed_step
    try:
        mark("start")
        float(step(batch)["loss"])
    finally:
        del model.get_loss, optimizer.step
        if voxel:
            del model.backbone_3d.plan
        for h in hooks:
            h.remove()
    return {b[0]: (b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])}


def _profile(step, batches, b2_forward_per_step):
    """`device_profile` of the steps, plus the sparse convs' split: B2's
    forward and dX launches and the dW range."""
    from torch.profiler import record_function

    weight_grad = sparse_backbone.weight_grad

    def ranged(*a, **k):
        with record_function(DW_RANGE):
            return weight_grad(*a, **k)

    def run():
        for batch in batches:
            float(step(batch)["loss"])

    sparse_backbone.weight_grad = ranged
    try:
        prof, out = device_profile(run, len(batches))
    finally:
        sparse_backbone.weight_grad = weight_grad
    b2 = sorted((evt.time_range.start, evt.time_range.elapsed_us()) for evt in prof.events()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and any(k in evt.name for k in B2_KERNELS))
    n = len(batches)
    if b2 and "device_busy_ms_per_step" in out:
        per_step = len(b2) // n
        fwd = [us for i, (_, us) in enumerate(b2) if i % per_step < b2_forward_per_step]
        dx = [us for i, (_, us) in enumerate(b2) if i % per_step >= b2_forward_per_step]
        # the kernels the host-side ranges launched (the range's own span on
        # the device's timeline, idle gaps included, does not count)
        dw_us = sum(evt.device_time_total for evt in prof.events()
                    if evt.name == DW_RANGE and evt.device_type == torch.autograd.DeviceType.CPU)
        out["sparse_convs"] = {
            "b2_launches_per_step": per_step,
            "b2_forward": {"launches_per_step": len(fwd) / n, "ms_per_step": sum(fwd) / n / 1e3},
            "b2_dx": {"launches_per_step": len(dx) / n, "ms_per_step": sum(dx) / n / 1e3},
            "dw_gather_matmul_ms_per_step": (dw_us / n / 1e3 if dw_us else
                                             "not measured (no device time under the range)"),
        }
    return out


def pointrcnn_train(steps: int, device_name: str) -> dict:
    """profile_train --model pointrcnn: step times, the spans of
    `pointrcnn_profile` over the steps, and the device profile of two."""
    import tempfile

    cfg, _, model = pointrcnn(device="cuda", train=True)
    seeded_weights_(model, seed=0)
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL_STEPS)
    step = make_train_step(model, state.optimizer, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as work:
        info = write_pointrcnn_root(cfg, Path(work), POINTRCNN_BATCH_SIZE * steps, training=True)
        batches = pointrcnn_batches(cfg, Path(work), info, steps, training=True)

    def run(batch):
        return {k: float(v) for k, v in step(batch).items()}

    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        run(proposal_gt(model, batch, torch.bfloat16))
    step_ms, reg_loss = [], []
    for batch in batches:
        batch = proposal_gt(model, batch, torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run(batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        reg_loss.append(metrics["rcnn_reg_loss"])
    median = statistics.median(step_ms)
    batches = [proposal_gt(model, b, torch.bfloat16) for b in batches]
    spans = pointrcnn_profile(model, run, batches, state.optimizer)
    # its trace holds ~50,000 launches a step: two steps suffice
    profile = device_profile(lambda: [run(b) for b in batches[:2]], 2)[1]
    after_ms = []
    for batch in batches[:3]:
        t0 = time.perf_counter()
        run(batch)
        after_ms.append((time.perf_counter() - t0) * 1e3)
    if "device_busy_ms_per_step" in profile:
        profile["device_idle_share_of_step_ms"] = 1 - profile["device_busy_ms_per_step"] / median
    scans = spans.pop("keep_scan")
    return {
        "device": device_name,
        "workload": "PointRCNN pointrcnn_nuscenes2kitti (4.04 M parameters), B=4 synthetic "
                    "KITTI frames (40000-60000 points in the frustum, 20-40 boxes) read in "
                    "train mode with the augmentations and sampled to 16384 points, 16 gt per "
                    "frame made of proposals, bf16 autocast, seeded random weights, "
                    "adam_onecycle over 1000 steps",
        "steps": steps,
        "step_ms": {"median": median, "all": step_ms},
        "samples_per_s": 4 / (median / 1e3),
        "step_ms_after_profiler": after_ms,
        "rcnn_reg_loss": reg_loss,
        **spans,
        "nms_scan": {"calls_per_step": len(scans) / len(batches),
                     "shapes": sorted({tuple(c["shape"]) for c in scans}),
                     "iterations": [c["iterations"] for c in scans],
                     "ms": [c["ms"] for c in scans]},
        "profile": profile,
    }


VOXEL8X_FORWARD_B2 = 12  # VoxelBackBone8x's sparse convs


def second_train(steps: int, device_name: str) -> dict:
    """profile_train --model second: step times, the spans of
    `anchor_profile` over the steps with the optimizer, and the device
    profile with the sparse convs' split."""
    import tempfile

    cfg, _, model = second_multihead(device="cuda", train=True)
    seeded_weights_(model, seed=0)
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL_STEPS)
    step = make_train_step(model, state.optimizer, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as work:
        batches = nuscenes_workload(cfg, Path(work), steps, training=True)

    def run(batch):
        return {k: float(v) for k, v in step(batch).items()}

    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        run(batch)
    step_ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run(batch))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(step_ms)
    spans = anchor_profile(model, run, batches, state.optimizer)
    profile = _profile(step, batches, VOXEL8X_FORWARD_B2)
    if "device_busy_ms_per_step" in profile:
        profile["device_idle_share_of_step_ms"] = 1 - profile["device_busy_ms_per_step"] / median
    scans = spans.pop("keep_scan")
    return {
        "device": device_name,
        "workload": "SECOND cbgs_second_multihead 1024x1024x40 grid, max_voxels 60000, "
                    "AnchorHeadMulti (327680 anchors per frame), B=4 synthetic nuScenes key "
                    "frames with 9 sweeps (34000 points each, at most 65536 per frame) read in "
                    "train mode (CBGS, flip, rotation, scaling), bf16 autocast, seeded random "
                    "weights, adam_onecycle over 1000 steps",
        "steps": steps,
        "step_ms": {"median": median, "all": step_ms},
        "samples_per_s": 4 / (median / 1e3),
        "losses": losses,
        **spans,
        "nms_scan": {"calls_per_step": len(scans) / len(batches)},
        "profile": profile,
    }


ENCODER_FORWARD_B2 = 9  # SparseEncoder's sparse convs (Voxel R-CNN, PV-RCNN, PV-RCNN++)
UNET_FORWARD_B2 = 12    # SparseUNet's (PartA2)


def two_stage_train(name: str, steps: int, device_name: str) -> dict:
    """profile_train --model second_iou|voxel_rcnn|pv_rcnn|parta2|pv_rcnn_plusplus:
    step times at the
    config's BATCH_SIZE_PER_GPU, the spans of `two_stage_profile` over the
    steps with the optimizer, and the device profile with the sparse convs'
    split. Each batch gets `zoo.proposal_gt`'s 16 gt per frame just before
    its step, outside the timed step, so that every step has RoIs over
    REG_FG_THRESH."""
    import tempfile

    cfg, _, model = TWO_STAGE[name](device="cuda", train=True)
    seeded_weights_(model, seed=0)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL_STEPS)
    step = make_train_step(model, state.optimizer, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as work:
        batches = kitti_workload(cfg, Path(work), steps, b, training=True)

    def run(batch):
        return {k: float(v) for k, v in step(batch).items()}

    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        run(proposal_gt(model, batch, torch.bfloat16))
    step_ms, losses = [], []
    for batch in batches:
        batch = proposal_gt(model, batch, torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run(batch))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(step_ms)
    batches = [proposal_gt(model, batch, torch.bfloat16) for batch in batches]
    spans = two_stage_profile(model, run, batches, state.optimizer)
    forward_b2 = {"second_iou": VOXEL8X_FORWARD_B2, "parta2": UNET_FORWARD_B2}.get(
        name, ENCODER_FORWARD_B2)
    profile = _profile(step, batches, forward_b2)
    if "device_busy_ms_per_step" in profile:
        profile["device_idle_share_of_step_ms"] = 1 - profile["device_busy_ms_per_step"] / median
    scans = spans.pop("keep_scan")
    return {
        "device": device_name,
        "workload": f"{cfg.MODEL.NAME} ({name}) 1408x1600x40 grid, max_voxels 16000, B={b} "
                    "synthetic KITTI frames (40000-60000 points in the frustum, at most 32768 "
                    "per frame, 20-40 boxes) read in train mode (gt sampling, flip, rotation, "
                    "scaling), 16 gt per frame made of proposals, bf16 autocast, seeded random "
                    "weights, adam_onecycle over 1000 steps",
        "steps": steps,
        "step_ms": {"median": median, "all": step_ms},
        "samples_per_s": b / (median / 1e3),
        "losses": losses,
        **spans,
        "nms_scan": {"calls_per_step": len(scans) / len(batches),
                     "shapes": sorted({tuple(c["shape"]) for c in scans})},
        "profile": profile,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("pillar", "voxel", "pointrcnn", "second", *TWO_STAGE),
                    default="pillar")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    if args.model in TWO_STAGE:
        _write(two_stage_train(args.model, args.steps, smi.stdout.strip()), args.out)
        return
    if args.model in ("pointrcnn", "second"):
        run = pointrcnn_train if args.model == "pointrcnn" else second_train
        _write(run(args.steps, smi.stdout.strip()), args.out)
        return
    voxel = args.model == "voxel"
    cfg, _, model = (voxel_centerpoint if voxel else flagship)(device="cuda", train=True)
    seeded_weights_(model, seed=0)
    state = create_train_state(model, cfg.OPTIMIZATION, TOTAL_STEPS)
    step = make_train_step(model, state.optimizer, device="cuda", dtype=torch.bfloat16)
    batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s, velocity=voxel)
               for s in range(args.steps)]
    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        float(step(batch)["loss"])
    torch.cuda.synchronize()

    step_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        float(step(batch)["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)

    phases = [_phase_times(model, state.optimizer, step, b) for b in batches]
    phase_ms = {k: statistics.median(p[k] for p in phases) for k in phases[0]}

    # B2 launches of the forward of one step (read where the loss starts)
    gather_gemm_kernel.launches = 0
    counted = {}
    get_loss = model.get_loss

    def counting_loss(*a, **k):
        counted.setdefault("forward", gather_gemm_kernel.launches)
        return get_loss(*a, **k)

    model.get_loss = counting_loss
    try:
        float(step(batches[0])["loss"])
    finally:
        del model.get_loss
    forward = counted["forward"]
    median = statistics.median(step_ms)
    result = {
        "device": smi.stdout.strip(),
        "workload": ("flagship CenterPoint-pillar 256x512 BEV" if not voxel else
                     "voxel CenterPoint 1024x1024x40 grid, max_voxels 60000, 10-column gt")
                    + ", B=4, 60000 points, 256 gt slots (16 valid), bf16 autocast, seeded "
                      "random weights, adam_onecycle over 1000 steps",
        "steps": args.steps,
        "step_ms": {"median": median, "all": step_ms},
        "samples_per_s": 4 / (median / 1e3),
        "phase_ms": phase_ms,
        "b2_launches_per_step": {"forward": forward,
                                 "dx": gather_gemm_kernel.launches - forward},
        "profile": _profile(step, batches, forward),
    }
    busy = result["profile"].get("device_busy_ms_per_step")
    if busy is not None:
        # the profiler's own cost stretches its window; against the step
        # time taken without it the card idles for this share
        result["profile"]["device_idle_share_of_step_ms"] = 1 - busy / median
    _write(result, args.out)


def _write(result, out):
    text = json.dumps(result, indent=1)
    print(text)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)


if __name__ == "__main__":
    main()
