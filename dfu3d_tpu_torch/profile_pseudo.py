"""Where the pseudo-box pipeline's time goes, on the card (the port of
bench_pseudo.py's two stages).

    python -m dfu3d_tpu_torch.profile_pseudo [--frames 24] [--out FILE.json]

Frames are `pseudo.synthetic.make_scene` scenes (352 × 1216 image, ~35,000
LiDAR points, 8 Car instances), made on the host before any clock starts,
one seed each. Two stages, as the reference runs them (tools/PENet/main.py
completes depth in its own pass, the box factory reads the result):

* depth: `tools.complete_depth.DepthCompleter` per frame, for the compact
  `enet` and the reference-exact `enet_ref`, bf16 autocast at 352 × 1216,
  seeded random weights; frames/s over the timed frames, and the nets'
  multiply-accumulates per frame (counted on the meta device) with the
  bound they give at the card's dense bf16 rate;
* factory: `PseudoBoxFactory.process_frame` at its defaults (16 instances,
  2,048 points each, 4 clusters, 128 RANSAC hypotheses, 65,536-point LiDAR
  cap) on the camera-FOV LiDAR, as tools.generate_pseudo_boxes feeds it;
  frames/s, the median host-clock ms of its stages (plane, densify,
  instance packing, frame program, post-filter), the label propagation's
  sweeps and host syncs per frame, and the adjacency product's
  multiply-accumulates per frame.

Each stage also runs under torch.profiler for device busy ms per frame and
the idle share of the window. The chained rate is 1 / (1/depth + 1/factory)
per depth net. One JSON object is printed (and written to --out), with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .profile_serve import device_profile
from .pseudo.factory import PseudoBoxFactory
from .pseudo.synthetic import IMG_H, IMG_W, make_scene
from .tools.complete_depth import DepthCompleter, build_depth_model
from .tools.generate_pseudo_boxes import fov_only

BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
DEPTH_MODELS = ("enet", "enet_ref")


def count_macs(name: str, h: int = IMG_H, w: int = IMG_W) -> int:
    """Multiply-accumulates of one (1, ·, h, w) forward of a depth net, from
    its convolutions' shapes on the meta device: a conv's output elements ×
    Cin·kh·kw, a transposed conv's input elements × Cout·kh·kw."""
    model = build_depth_model(name, "meta")
    macs = []

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs.append(inp[0].numel() * mod.out_channels * k)
        else:
            macs.append(out.numel() * mod.in_channels // mod.groups * k)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    rgb, d = torch.zeros(1, 3, h, w, device="meta"), torch.zeros(1, 1, h, w, device="meta")
    with torch.no_grad():
        if name == "enet_ref":
            model(rgb, d, torch.zeros(1, 2, h, w, device="meta"),
                  torch.zeros(1, 3, 3, device="meta"))
        else:
            model(rgb, d, 600.0, 180.0, 700.0, 700.0)
    return int(sum(macs))


def depth_stage(name, frames, device, warmup=2, profiled=4):
    torch.manual_seed(0)
    completer = DepthCompleter(build_depth_model(name, device), name, IMG_H, IMG_W, device,
                               torch.bfloat16)
    for f in frames[:warmup]:
        completer(f.image, f.lidar, f.calib)
    timed = frames[warmup:]
    t0 = time.perf_counter()
    for f in timed:
        out = completer(f.image, f.lidar, f.calib)
    seconds = time.perf_counter() - t0
    if not np.isfinite(out).all():
        raise RuntimeError(f"{name}: depth map not finite")

    def run():
        for f in timed[:profiled]:
            completer(f.image, f.lidar, f.calib)

    macs = count_macs(name)
    return {"frames": len(timed), "seconds": seconds, "frames_per_s": len(timed) / seconds,
            "ms_per_frame": seconds / len(timed) * 1e3, "macs_per_frame": macs,
            "bound_ms": 2 * macs / BF16_PEAK * 1e3,
            "profile": device_profile(run, profiled)[1]}


def factory_stage(frames, device, warmup=2, profiled=4):
    factory = PseudoBoxFactory(device=device, seed=0)
    for f in frames[:warmup]:
        factory.process_frame(f)
    timed = frames[warmup:]
    stages, stats, boxes = [], [], []
    t0 = time.perf_counter()
    for f in timed:
        out = factory.process_frame(f)
        stages.append(factory.last_times)
        stats.append(factory.last_stats)
        boxes.append(len(out.boxes_lidar))
    seconds = time.perf_counter() - t0

    def run():
        for f in timed[:profiled]:
            factory.process_frame(f)

    k, p = factory.max_instances, factory.max_pts
    return {"frames": len(timed), "seconds": seconds, "frames_per_s": len(timed) / seconds,
            "ms_per_frame": seconds / len(timed) * 1e3,
            "stage_ms": {s: statistics.median(t[s] for t in stages) * 1e3 for s in stages[0]},
            "sweeps_per_frame": statistics.mean(s["sweeps"] for s in stats),
            "syncs_per_frame": statistics.mean(s["syncs"] for s in stats),
            "sweeps_max": max(s["sweeps"] for s in stats),
            "boxes_per_frame": statistics.mean(boxes),
            "adjacency_macs_per_frame": k * p ** 3,
            "adjacency_bound_ms": 2 * k * p ** 3 / BF16_PEAK * 1e3,
            "profile": device_profile(run, profiled)[1]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=24, help="frames per stage, warm-up included")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pseudo needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)

    t0 = time.perf_counter()
    depth_frames = [make_scene(seed=s)[0] for s in range(args.frames)]
    factory_frames = [fov_only(make_scene(seed=10_000 + s)[0]) for s in range(args.frames)]
    make_s = time.perf_counter() - t0
    depth = {name: depth_stage(name, depth_frames, device) for name in DEPTH_MODELS}
    factory = factory_stage(factory_frames, device)
    result = {
        "device": smi.stdout.strip(),
        "workload": "make_scene frames (352x1216, ~35k LiDAR points, 8 Car instances); depth "
                    "bf16 at 352x1216 with seeded random weights; factory at its defaults on "
                    "the FOV LiDAR",
        "make_frames_s": make_s,
        "depth": depth,
        "factory": factory,
        "chained_frames_per_s": {name: 1.0 / (1.0 / d["frames_per_s"]
                                              + 1.0 / factory["frames_per_s"])
                                 for name, d in depth.items()},
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return result


if __name__ == "__main__":
    main()
