"""Where the serving time goes, on the card.

    python -m dfu3d_tpu_torch.profile_serve [--model pillar|voxel] [--batches 8]
                                            [--out FILE.json]

Runs an eval step (`make_eval_step`) at full width: the flagship
CenterPoint-pillar (256 x 512 BEV) or voxel CenterPoint
(cbgs_voxel01_res3d_centerpoint, 1024 x 1024 x 40 grid). B=4, 60,000
uniform points in a 50 m extent, 256 gt slots, bf16 autocast, weights from
`seeded_weights_`. It reports, as one JSON object (printed, and written to
--out):

* step_ms: host clock per step, no instrumentation (median over batches);
* phase_ms: the same step with a device sync at each phase boundary
  (pillar: batch upload, VFE, 2D backbone, head convs, decode + NMS,
  recall; voxel: batch upload, voxelize + MeanVFE, neighbour tables, sparse
  convs, height compression, 2D backbone, head convs, decode + NMS, recall);
* nms_scan: fixed-point iterations of the keep-scan per step and its time;
* profile: torch.profiler over the batches, device time by kernel name and
  the device's busy share of the window.

Needs a CUDA device; numbers are tagged with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from .core.geometry import nms as nms_mod
from .data.batch import synthetic_batch
from .flagship import flagship, seeded_weights_
from .train.train_state import make_eval_step
from .zoo import voxel_centerpoint

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
    ap.add_argument("--model", choices=("pillar", "voxel"), default="pillar")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cfg, grid, model = (flagship if args.model == "pillar" else voxel_centerpoint)(device="cuda")
    seeded_weights_(model, seed=0)
    step = make_eval_step(model, RECALL_THRESH, device="cuda", dtype=torch.bfloat16)
    batches = [synthetic_batch(4, 60000, 256, 50.0, seed=s) for s in range(args.batches)]
    for batch in batches[:2]:  # warm-up: kernel build and load, cuDNN plans
        step(batch)
    torch.cuda.synchronize()

    step_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        _run(step, batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)

    phases = [_phase_times(model, step, b) for b in batches]
    phase_ms = {k: statistics.median(p[k] for p in phases) for k in phases[0]}

    scans = []
    orig_scan = nms_mod._suppression_scan

    def timed_scan(iou_mat, valid, thresh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep, iterations = orig_scan(iou_mat, valid, thresh)
        torch.cuda.synchronize()
        scans.append(((time.perf_counter() - t0) * 1e3, iterations, tuple(iou_mat.shape)))
        return keep, iterations

    nms_mod._suppression_scan = timed_scan
    try:
        for batch in batches:
            step(batch)
    finally:
        nms_mod._suppression_scan = orig_scan

    result = {
        "device": smi.stdout.strip(),
        "workload": ("flagship CenterPoint-pillar 256x512 BEV" if args.model == "pillar" else
                     "voxel CenterPoint 1024x1024x40 grid, max_voxels 60000")
                    + ", B=4, 60000 points, 256 gt slots, bf16 autocast, seeded random weights",
        "batches": args.batches,
        "step_ms": {"median": statistics.median(step_ms), "all": step_ms},
        "phase_ms": phase_ms,
        "nms_scan": {"calls_per_step": len(scans) / len(batches),
                     "shape": list(scans[0][2]),
                     "iterations": [s[1] for s in scans],
                     "host_syncs_per_call": [s[1] + 1 for s in scans],
                     "ms": [s[0] for s in scans]},
        "profile": _profile(step, batches),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
