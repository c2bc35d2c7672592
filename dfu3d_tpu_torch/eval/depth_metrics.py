"""Depth-completion metrics (port of dfu3d_tpu/eval/depth_metrics.py;
reference tools/PENet/metrics.py:13-180 + helper.py:9-14 csv fieldnames).

RMSE / MAE (mm), iRMSE / iMAE (1/km), absrel, squared_rel, lg10, delta1-3 and
silog over the valid (gt > 0.1 m) pixels, as one masked reduction on the
tensors' device (`evaluate_depth`); a host-side accumulator
(`DepthAverageMeter`) and the reference's train.csv / val.csv / best.txt
writer (`DepthCsvLogger`); and the per-epoch image comparison rows
[rgb | sparse | prediction | gt], jet-coloured, written as a PNG with zlib
(no PIL, no matplotlib: the jet table is an own copy of matplotlib's).
"""
from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np
import torch

# csv schema from reference helper.py:9-14 (fieldnames), minus the photometric
# / timing entries the reference itself leaves at 0 in depth-only training
DEPTH_CSV_FIELDS = [
    "epoch", "rmse", "photo", "mae", "irmse", "imae", "mse", "absrel",
    "lg10", "silog", "squared_rel", "delta1", "delta2", "delta3",
    "data_time", "gpu_time",
]

METRIC_KEYS = [
    "irmse", "imae", "mse", "rmse", "mae", "absrel", "squared_rel", "lg10",
    "delta1", "delta2", "delta3", "silog",
]


def evaluate_depth(pred, target):
    """Masked depth metrics (reference metrics.py Result.evaluate:65-102).

    pred / target: tensors (or arrays) of one shape, metres; valid = target >
    0.1 m. Returns {name: 0-dim fp32 tensor} on pred's device: mse / rmse /
    mae in mm, irmse / imae in 1/km, absrel / squared_rel / lg10 / deltas
    dimensionless, silog in log(m)·100."""
    pred = torch.as_tensor(pred).float()
    target = torch.as_tensor(target, device=pred.device).float()
    valid = target > 0.1
    n = torch.clamp(valid.sum(), min=1).float()

    def vmean(x):
        return torch.sum(torch.where(valid, x, 0.0)) / n

    out_mm = 1e3 * pred
    tgt_mm = 1e3 * target
    abs_diff = torch.abs(out_mm - tgt_mm)

    mse = vmean(abs_diff ** 2)
    mae = vmean(abs_diff)
    # log / ratio terms are only read under the mask; clamp to keep them finite
    safe_out = torch.clamp(out_mm, min=1e-6)
    safe_tgt = torch.clamp(tgt_mm, min=1e-6)
    lg10 = vmean(torch.abs(torch.log10(safe_out) - torch.log10(safe_tgt)))
    absrel = vmean(abs_diff / safe_tgt)
    squared_rel = vmean((abs_diff / safe_tgt) ** 2)

    ratio = torch.maximum(safe_out / safe_tgt, tgt_mm / safe_out)
    delta1 = vmean((ratio < 1.25).float())
    delta2 = vmean((ratio < 1.25 ** 2).float())
    delta3 = vmean((ratio < 1.25 ** 3).float())

    err_log = torch.log(torch.clamp(target, min=1e-9)) - torch.log(torch.clamp(pred, min=1e-9))
    nsl = vmean(err_log ** 2)
    log_mean = vmean(err_log)
    silog = torch.sqrt(torch.clamp(nsl - log_mean ** 2, min=0.0)) * 100.0

    inv_out_km = 1.0 / torch.clamp(1e-3 * pred, min=1e-9)
    inv_tgt_km = 1.0 / torch.clamp(1e-3 * target, min=1e-9)
    abs_inv = torch.abs(inv_out_km - inv_tgt_km)
    irmse = torch.sqrt(vmean(abs_inv ** 2))
    imae = vmean(abs_inv)

    return {
        "irmse": irmse, "imae": imae, "mse": mse, "rmse": torch.sqrt(mse),
        "mae": mae, "absrel": absrel, "squared_rel": squared_rel,
        "lg10": lg10, "delta1": delta1, "delta2": delta2, "delta3": delta3,
        "silog": silog,
    }


def metrics_to_host(result: dict) -> dict:
    """evaluate_depth's tensors → plain floats, in one transfer."""
    values = torch.stack([result[k] for k in METRIC_KEYS]).tolist()
    return dict(zip(METRIC_KEYS, values))


def evaluate_depth_np(pred: np.ndarray, target: np.ndarray) -> dict:
    """Host / numpy convenience wrapper returning plain floats (on the CPU)."""
    return metrics_to_host(evaluate_depth(torch.as_tensor(np.asarray(pred, np.float32)),
                                          torch.as_tensor(np.asarray(target, np.float32))))


class DepthAverageMeter:
    """Count-weighted accumulator (reference metrics.py AverageMeter:105-150,
    without the gpu-timing warmup machinery — timing is tracked apart)."""

    def __init__(self):
        self.count = 0.0
        self.sums = {k: 0.0 for k in METRIC_KEYS}

    def update(self, result: dict, n: int = 1):
        self.count += n
        for k in METRIC_KEYS:
            self.sums[k] += n * float(result[k])

    def average(self) -> dict:
        if self.count == 0:
            return {k: math.inf for k in METRIC_KEYS}
        return {k: self.sums[k] / self.count for k in METRIC_KEYS}


class DepthCsvLogger:
    """train.csv / val.csv / best.txt writer (reference helper.logger:17-143)
    in the reference's csv schema; a val epoch is the best when its rmse is
    below every earlier one's (helper.rank_conditional_save_best)."""

    def __init__(self, output_dir):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.best_rmse = math.inf
        for split in ("train", "val"):
            p = self.output_dir / f"{split}.csv"
            if not p.exists():
                with open(p, "w", newline="") as f:
                    csv.DictWriter(f, fieldnames=DEPTH_CSV_FIELDS).writeheader()

    def append(self, split: str, epoch: int, avg: dict,
               data_time: float = 0.0, gpu_time: float = 0.0) -> bool:
        row = {"epoch": epoch, "photo": 0.0,
               "data_time": round(data_time, 4), "gpu_time": round(gpu_time, 4)}
        row.update({k: round(avg[k], 6) for k in METRIC_KEYS})
        with open(self.output_dir / f"{split}.csv", "a", newline="") as f:
            csv.DictWriter(f, fieldnames=DEPTH_CSV_FIELDS).writerow(row)
        is_best = split == "val" and avg["rmse"] < self.best_rmse
        if is_best:
            self.best_rmse = avg["rmse"]
            (self.output_dir / "best.txt").write_text(
                "epoch={}\nrmse={:.3f}\nmae={:.3f}\nirmse={:.3f}\nimae={:.3f}\n"
                "silog={:.3f}\nsquared_rel={:.6f}\ndelta1={:.4f}\nabsrel={:.6f}\n"
                "lg10={:.6f}\n".format(
                    epoch, avg["rmse"], avg["mae"], avg["irmse"], avg["imae"],
                    avg["silog"], avg["squared_rel"], avg["delta1"],
                    avg["absrel"], avg["lg10"]))
        return is_best


# ---------------------------------------------------------------------------
# Image-comparison logger (reference helper.logger.conditional_save_img_
# comparison + vis_utils.merge_into_row, tools/PENet/helper.py:129-154 /
# vis_utils.py:23-90): per val epoch, up to 8 rows of
# [rgb | colorized sparse input | colorized prediction | colorized gt]
# written as comparison_<epoch>.png, re-saved as comparison_best.png when
# the epoch sets a new best.
# ---------------------------------------------------------------------------

# matplotlib's jet (_cm._jet_data): (x, y0, y1) breakpoints per channel
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1, 0, 0)),
}
_LUT_N = 256


def _lookup_table(data, n=_LUT_N):
    """matplotlib.colors._create_lookup_table with gamma 1."""
    adata = np.asarray(data, np.float64)
    x = adata[:, 0] * (n - 1)
    y0, y1 = adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet(values: np.ndarray) -> np.ndarray:
    """matplotlib.cm.jet(values)[..., :3] for floats in [0, 1]: the 256-entry
    table, entry ⌊v·256⌋ (255 at v = 1)."""
    lut = np.stack([_lookup_table(_JET[c]) for c in ("red", "green", "blue")], axis=-1)
    xa = np.asarray(values, np.float64) * _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    return lut[np.clip(xa, 0, _LUT_N - 1).astype(int)]


def _depth_colorize(depth: np.ndarray) -> np.ndarray:
    """(H, W) metric depth → (H, W, 3) uint8 jet (vis_utils.depth_colorize)."""
    d = np.asarray(depth, np.float32)
    lo, hi = float(np.min(d)), float(np.max(d))
    d = (d - lo) / max(hi - lo, 1e-6)
    return (255 * jet(d)).astype(np.uint8)


def comparison_row(rgb, sparse_d, pred, gt) -> np.ndarray:
    """One comparison row (vis_utils.merge_into_row: rgb, d, pred, gt)."""
    rgb8 = np.asarray(rgb)
    if rgb8.dtype != np.uint8:
        rgb8 = np.clip(rgb8 * (255.0 if rgb8.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    parts = [rgb8, _depth_colorize(np.asarray(sparse_d)), _depth_colorize(np.asarray(pred)),
             _depth_colorize(np.asarray(gt))]
    return np.hstack(parts)


def save_img_comparison(path, rows) -> None:
    """Stack rows (vis_utils.add_row) and write an RGB PNG (save_image)."""
    from ..data.kitti_synthetic import write_png_rgb

    if not rows:
        return
    write_png_rgb(path, np.vstack(rows))
