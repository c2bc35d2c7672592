"""Depth completion's effect on the pseudo-box factory (port of the JAX
package's tools/dev/depth_e2e.py).

On one synthetic KITTI-format set (`pseudo.synthetic.make_dataset`, Car
only), the factory's per-class precision and recall at BEV IoU 0.5
(`tools.e2e_synthetic.factory_quality`) under three depth sources:

  gt_depth        — the synthesizer's dense depth (the factory's upper bound)
  sparse_depth    — the LiDAR projected into the image (no completion)
  completed_depth — an ENet trained by `tools.train_depth --synthetic` and run
                    through `tools.complete_depth --ckpt` (the reference
                    pipeline's PENet pass, tools/PENet/main.py train → evaluate)

    python -m dfu3d_tpu_torch.tools.depth_e2e [--frames 24] [--epochs 12] \\
        [--workdir output/depth_e2e] [--device cuda]

Prints one JSON line per source and writes only under --workdir (a later run
reuses its dataset and its trained checkpoint). The JAX script runs each CLI
in a subprocess; here each runs in process, with the CLIs' own defaults
(max(32, 2 · frames) synthetic frames at 352 × 1216, widths 32-256, bf16).
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ..device import resolve_device


def main(argv=None):
    """Returns {source: the factory's quality}."""
    from ..core.geometry.calibration import Calibration
    from ..data import kitti_io
    from ..pseudo.synthetic import make_dataset
    from . import complete_depth, generate_pseudo_boxes, train_depth
    from .e2e_synthetic import factory_quality

    ap = argparse.ArgumentParser(description="dfu3d_tpu_torch depth sources vs the factory")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--workdir", type=str, default="output/depth_e2e")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    device = ["--device", args.device]

    work = Path(args.workdir)
    root = work / "data"
    if not (root / "ImageSets" / "train.txt").exists():
        make_dataset(root, n_train=args.frames, n_val=2, class_names=("Car",))
    ids = sorted(p.stem for p in (root / "velodyne").glob("*.bin"))
    # keep the gt depth: each source overwrites depth/
    gt_dir = root / "depth_gt"
    if not gt_dir.exists():
        shutil.copytree(root / "depth", gt_dir)

    results = {}

    def source(name):
        generate_pseudo_boxes.main(["--detpath", str(root), "--ground_z", "-1.7", "--z_offset",
                                    "0.0", "--classes", "Car", *device])
        results[name] = factory_quality(root, ["Car"])
        print(json.dumps({"arm": name, **results[name]}), flush=True)

    # 1. the synthesizer's dense depth
    for i in ids:
        shutil.copy(gt_dir / f"{i}.npy", root / "depth" / f"{i}.npy")
    source("gt_depth")

    # 2. the LiDAR's sparse depth
    for i in ids:
        lidar = kitti_io.read_velodyne_bin(root / "velodyne" / f"{i}.bin")
        calib = Calibration(root / "calib" / f"{i}.txt")
        h, w = np.load(gt_dir / f"{i}.npy").shape
        np.save(root / "depth" / f"{i}.npy",
                complete_depth.sparse_depth_from_lidar(lidar, calib, h, w))
    source("sparse_depth")

    # 3. a trained ENet completes this set's frames from their sparse input
    out = work / "depth_run"
    ckpt = out / "best_ckpt.pth"
    if not ckpt.exists():
        train_depth.main(["--synthetic", str(max(32, 2 * args.frames)), "--epochs",
                          str(args.epochs), "--model", "enet", "--out", str(out), *device])
    complete_depth.main(["--detpath", str(root), "--ckpt", str(ckpt), *device])
    source("completed_depth")
    return results


if __name__ == "__main__":
    main()
