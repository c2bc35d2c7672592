"""Pseudo-box generation (port of the JAX package's
tools/generate_pseudo_boxes.py; the reference's `tools/PENet/main.py
--command evaluate --detpath …`, SURVEY §3.1). SEEM masks and dense depth are
read as artifacts (seem/<idx>.npz, depth/<idx>.npy; pseudo/factory.py has
the format); the factory's two device programs run on --device.

    python -m dfu3d_tpu_torch.tools.generate_pseudo_boxes --detpath ROOT \\
        [--start 0 --end N] [--label_dir label_train] [--dataset nuscenes] \\
        [--device cuda] [--seed 0]

Writes <label_dir>/<idx>.txt (KITTI label lines) and velodyne_depth/<idx>.npy
(the fused (N, 8) fp16 cloud) per frame.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from ..data.kitti_dataset import KittiDataset
from ..pseudo.factory import FACTORY_PRESETS, PseudoBoxFactory, load_frame_inputs
from ..utils.common import create_logger


def fov_only(frame):
    """The frame with its LiDAR cut to the points that project into the image
    (KittiDataset.get_fov_flag), as --fov_only does."""
    pts_rect = frame.calib.lidar_to_rect(frame.lidar[:, 0:3])
    frame.lidar = frame.lidar[KittiDataset.get_fov_flag(pts_rect, frame.depth.shape[:2],
                                                        frame.calib)]
    return frame


def main(argv=None):
    """Returns {"frames": [ids done], "boxes": {id: count}, "seconds",
    "frames_per_s"}."""
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch pseudo-box generation")
    parser.add_argument("--detpath", type=str, required=True,
                        help="KITTI-format root with velodyne/ image_2/ calib/ depth/ seem/")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=None)
    parser.add_argument("--label_dir", type=str, default="label_train")
    parser.add_argument("--fov_only", action="store_true", default=True)
    parser.add_argument("--ground_z", type=float, default=0.0,
                        help="scene ground elevation in the lidar frame "
                             "(reference GenerateAnns hardcodes 0)")
    parser.add_argument("--z_offset", type=float, default=1.5,
                        help="box bottom offset (reference hardcodes 1.5)")
    parser.add_argument("--dataset", type=str, default="nuscenes",
                        choices=["nuscenes", "kitti", "waymo", "pandaset"],
                        help="factory variant preset: class size/height priors + center "
                             "placement (reference my_loader_KittiPandasetWaymo.py:883-1010; "
                             "nuscenes = the flagship path, no priors)")
    parser.add_argument("--center_type", type=str, default=None,
                        choices=["ori", "prior_centerline", "prior_linecorner", "prior_center"],
                        help="override the preset's center placement strategy")
    parser.add_argument("--classes", type=str, default=None,
                        help="comma-separated thing-class vocabulary the seem/<idx>.npz class "
                             "indices point into (default: the 10-class nuScenes list)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the RANSAC triples' generator")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    logger = create_logger()
    root = Path(args.detpath)
    ids = sorted(p.stem for p in (root / "velodyne").glob("*.bin"))[args.start:args.end]
    logger.info(f"{len(ids)} frames to process")

    thing_classes = args.classes.split(",") if args.classes else None
    preset = dict(FACTORY_PRESETS[args.dataset])
    if args.center_type:
        preset["center_type"] = args.center_type
    factory = PseudoBoxFactory(ground_z=args.ground_z, z_offset=args.z_offset,
                               thing_classes=thing_classes, seed=args.seed,
                               device=args.device, **preset)
    t0 = time.time()
    done, boxes = [], {}
    for idx in ids:
        try:
            frame = load_frame_inputs(root, idx)
        except FileNotFoundError as e:
            logger.warning(f"{idx}: missing input ({e}); skipped")
            continue
        if args.fov_only:
            frame = fov_only(frame)
        out = factory.process_frame(frame)
        factory.write_frame(root, frame, out, label_dir=args.label_dir)
        done.append(idx)
        boxes[idx] = len(out.boxes_lidar)
        if len(done) % 50 == 0:
            logger.info(f"{len(done)}/{len(ids)} frames  "
                        f"({len(done) / (time.time() - t0):.2f} frames/s)")
    seconds = max(time.time() - t0, 1e-6)
    logger.info(f"done: {len(done)} frames at {len(done) / seconds:.2f} frames/s")
    return {"frames": done, "boxes": boxes, "seconds": seconds,
            "frames_per_s": len(done) / seconds}


if __name__ == "__main__":
    main()
