"""Demo: run a trained detector on raw point-cloud files and render them
(port of tools/demo.py, the reference's tools/demo.py without open3d).

    python -m dfu3d_tpu_torch.tools.demo --cfg_file CFG --ckpt CKPT \\
        --data_path DIR_OR_FILE [--out_dir demo_out] [--ext .bin] [--view bev|3d] \\
        [--device cuda|cpu] [--dtype bfloat16|float32]

Each file (.bin: float32 rows of x, y, z, intensity; .npy: its first four
columns) is padded to the config's MAX_POINTS_PER_FRAME and predicted alone
through the model's eval step (`predict_files`: decode and NMS, B1 on the
card); the kept boxes are then drawn, top-down (`draw_bev`) or with
`visual_utils.draw_scenes` (--view 3d), one PNG per file in --out_dir.
Rendering needs matplotlib; prediction does not.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import DTYPES


def load_points(path) -> np.ndarray:
    """(N, 4) float32 points of a .npy or .bin file."""
    path = Path(path)
    if path.suffix == ".npy":
        pts = np.load(path).astype(np.float32)
    else:
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return pts[:, :4]


def batch_of(points, n_max: int, m_max: int):
    """One frame as a PointBatch of B=1: the first n_max points, padded, and
    no gt (the JAX demo's `batch_of`)."""
    from ..data.batch import PointBatch

    n = min(len(points), n_max)
    return PointBatch.from_numpy(
        np.pad(points[:n_max], ((0, n_max - n), (0, 0)))[None],
        (np.arange(n_max) < n)[None],
        np.zeros((1, m_max, 8), np.float32), np.zeros((1, m_max), bool))


def frame_caps(cfg):
    """(points, gt slots) of a frame's batch: the config's
    MAX_POINTS_PER_FRAME and MAX_GT_PER_FRAME (65,536 and 256 by default)."""
    data = cfg.DATA_CONFIG
    return int(data.get("MAX_POINTS_PER_FRAME", 65536)), int(data.get("MAX_GT_PER_FRAME", 256))


def predict_files(model, files, n_max: int, m_max: int, device="cuda", dtype=None):
    """Each file's kept predictions through the model's eval step, one frame
    per request: [(points, boxes (K, 7+), scores (K,), labels (K,))] as numpy."""
    import torch

    from ..train.train_state import make_eval_step

    step = make_eval_step(model, device=device, dtype=dtype or torch.float32)
    out = []
    for f in files:
        pts = load_points(f)
        boxes, scores, labels, valid = (x[0].cpu() for x in step(batch_of(pts, n_max, m_max)))
        out.append((pts, boxes[valid].float().numpy(), scores[valid].float().numpy(),
                    labels[valid].numpy()))
    return out


def draw_bev(points, boxes, scores, labels, class_names, out_png,
             xlim=(0, 60), ylim=(-40, 40)):
    """Top-down PNG: the points coloured by height, each box's outline with
    its class name and score."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.np_geometry import boxes_to_corners_bev

    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(points[:, 0], points[:, 1], s=0.2, c=points[:, 2], cmap="viridis")
    if len(boxes):
        corners = boxes_to_corners_bev(boxes.astype(np.float32))
        for c, s, l in zip(corners, scores, labels):
            poly = np.concatenate([c, c[:1]], axis=0)
            ax.plot(poly[:, 0], poly[:, 1], "-r", linewidth=1.2)
            name = class_names[int(l) - 1] if 0 < int(l) <= len(class_names) else "?"
            ax.text(c[0, 0], c[0, 1], f"{name} {s:.2f}", color="red", fontsize=7)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_title(Path(out_png).stem)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render(preds, files, cfg, out_dir, view: str = "bev"):
    """One PNG per file in out_dir: `draw_bev` over the config's range, or
    `visual_utils.draw_scenes` (matplotlib) for view '3d'. Returns the paths."""
    from .visual_utils import draw_scenes

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    written = []
    for f, (pts, boxes, scores, labels) in zip(files, preds):
        png = out_dir / f"{Path(f).stem}.png"
        if view == "3d":
            draw_scenes(pts, ref_boxes=boxes, ref_scores=scores, ref_labels=labels,
                        class_names=cfg.CLASS_NAMES, out_png=str(png), backend="mpl")
        else:
            draw_bev(pts, boxes, scores, labels, cfg.CLASS_NAMES, png,
                     xlim=(pcr[0], pcr[3]), ylim=(pcr[1], pcr[4]))
        written.append(png)
    return written


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch demo")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--data_path", type=str, required=True,
                        help="dir of .bin/.npy point clouds, or a single file")
    parser.add_argument("--out_dir", type=str, default="demo_out")
    parser.add_argument("--ext", type=str, default=".bin")
    parser.add_argument("--view", type=str, default="bev", choices=["bev", "3d"],
                        help="bev: top-down PNG; 3d: visual_utils.draw_scenes")
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")
    return parser.parse_args(argv)


def main(argv=None):
    """Predict and render every file; returns (predictions, PNG paths)."""
    from ..device import resolve_device
    from ..train.checkpoint import load_model_state
    from ..utils.common import close_logger, create_logger
    from ..utils.config import CfgDict, cfg_from_yaml_file
    from .common import build_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    logger = create_logger()
    try:
        cfg = cfg_from_yaml_file(args.cfg_file, CfgDict())
        data_path = Path(args.data_path)
        files = sorted(data_path.glob(f"*{args.ext}")) if data_path.is_dir() else [data_path]
        logger.info(f"{len(files)} files")
        model = build_model(cfg, "test", device)
        if args.ckpt:
            epoch, _ = load_model_state(args.ckpt, model, logger)
            logger.info(f"loaded ckpt epoch {epoch}")
        preds = predict_files(model, files, *frame_caps(cfg), device, DTYPES[args.dtype])
        for f, p in zip(files, preds):
            logger.info(f"{Path(f).name}: {len(p[1])} boxes")
        written = render(preds, files, cfg, args.out_dir, args.view)
        logger.info(f"wrote {len(written)} renderings to {args.out_dir}")
        return preds, written
    finally:
        close_logger(logger)


if __name__ == "__main__":
    main()
