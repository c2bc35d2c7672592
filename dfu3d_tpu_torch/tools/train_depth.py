"""Depth-completion training (port of the JAX package's tools/train_depth.py;
reference tools/PENet/main.py train mode): trains ENet / PENetC1 / PENetC2 so
that `tools.complete_depth --ckpt` has weights to load.

    python -m dfu3d_tpu_torch.tools.train_depth --synthetic 32 --epochs 3
    python -m dfu3d_tpu_torch.tools.train_depth --detpath ROOT --model penet_c2 \\
        [--freeze_backbone] [--criterion l1|l2] [--device cuda] [--dtype bfloat16|float32]

The reference's protocol, as the JAX script has it:

* criterion: masked L2 (default) or masked L1 (main.py:199-200,
  criteria.py:6-30);
* ENet stage supervision: loss = (1-w1-w2)·fused + w1·cd + w2·dd with
  w = (0.2, 0.2) for epoch <= 1, (0.05, 0.05) for epoch <= 3, then fused only
  (main.py:296-315); a CSPN net is supervised on its refined output only,
  optionally with its ENet backbone frozen (main.py:145-146, 432): the
  backbone's parameters get no update and no Adam state, its BN running
  statistics still update (it runs in train mode);
* Adam (b1 0.9, b2 0.999, eps 1e-8) with the reference's per-epoch step decay
  (helper.py:216-239) as a per-step piecewise-constant schedule whose scales
  multiply at epoch · steps_per_epoch: the 'pe' curve when a CSPN net trains
  with its backbone, the 'e' curve otherwise;
* per epoch: RMSE / MAE / iRMSE / ... of the train steps' predictions and of
  a val pass, train.csv / val.csv / best.txt in the reference's schema, up to
  8 comparison rows per val epoch (comparison_<epoch>.png), and, when val
  RMSE improves, comparison_best.png and the weights as a torch state_dict
  (best_ckpt.pth).

Supervision: `--gt_dir` reads dense gt maps <idx>.npy; otherwise each frame's
LiDAR pixels are split at random into input (keep_frac) and held-out
supervision. `--synthetic N` makes N piecewise-planar frames instead (5 %
of their pixels as input). One numpy RandomState(--seed) draws the frames,
the splits and each epoch's order in the JAX script's sequence; the weights
are the port's own initialisation from a torch.Generator seeded with --seed.
B = 1 per step. bfloat16 runs the nets under autocast (the JAX script builds
them in bf16); float32 runs true fp32 convolutions (TF32 off) on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..eval.depth_metrics import (METRIC_KEYS, DepthAverageMeter, DepthCsvLogger,
                                  comparison_row, evaluate_depth, save_img_comparison)
from ..models.depth_completion import DEPTH_MODELS, masked_l1_loss, masked_l2_loss
from ..utils.common import create_logger
from .common import DTYPES
from .complete_depth import bottom_crop, fp32_math, sparse_depth_from_lidar

MODELS = ("enet", "penet_c1", "penet_c2")
DEFAULT_WIDTHS = (32, 64, 128, 256)
# the reference's step decay as cumulative scales at epoch boundaries
# (JAX script :211-212): 'pe' for a CSPN net trained whole, 'e' otherwise
DECAY_PE = {10: 0.5, 20: 0.2, 30: 0.1, 40: 0.05, 50: 0.02}
DECAY_E = {10: 0.5, 15: 0.2, 25: 0.1}


def stage_weights(epoch: int):
    """ENet deep-supervision weights (reference main.py:296-303)."""
    if epoch <= 1:
        return 0.2, 0.2
    if epoch <= 3:
        return 0.05, 0.05
    return 0.0, 0.0


def lr_for_epoch(lr_init: float, epoch: int, cspn: bool) -> float:
    """Step decay (reference helper.adjust_learning_rate:216-239)."""
    lr = lr_init
    if cspn:
        for e, f in ((10, 0.5), (20, 0.1), (30, 0.01), (40, 5e-4), (50, 1e-5)):
            if epoch >= e:
                lr = lr_init * f
    else:
        for e, f in ((10, 0.5), (15, 0.1), (25, 0.01)):
            if epoch >= e:
                lr = lr_init * f
    return lr


def lr_at_step(lr_init: float, step: int, steps_per_epoch: int, pe_decay: bool) -> float:
    """optax.piecewise_constant_schedule(lr_init, {e · steps_per_epoch: f})
    at update `step` (0 for the first): every scale whose boundary the step
    has reached multiplies in."""
    lr = lr_init
    for e, f in sorted((DECAY_PE if pe_decay else DECAY_E).items()):
        if step >= e * steps_per_epoch:
            lr *= f
    return lr


def synthetic_frame(rng, h, w):
    """Piecewise-planar depth + shaded rgb: a cheap scene with real structure
    (planes at varied slopes) so completion from sparse samples is learnable.
    Draws from `rng` in the JAX script's order."""
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    depth = np.full((h, w), 20.0, np.float32)
    depth += 10.0 * vv / h * rng.uniform(0.5, 1.5)
    for _ in range(4):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        rw, rh = rng.uniform(w * 0.1, w * 0.4), rng.uniform(h * 0.1, h * 0.4)
        box = (np.abs(uu - cx) < rw) & (np.abs(vv - cy) < rh)
        depth[box] = rng.uniform(3.0, 15.0)
    rgb = np.stack([depth / 30.0] * 3, axis=-1)
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    return rgb.astype(np.float32), depth


def load_kitti_frame(root: Path, idx: str, h: int, w: int, gt_dir):
    """One KITTI-format frame cropped at the bottom centre: (rgb (h, w, 3) in
    [0, 1], LiDAR sparse depth (h, w), dense gt (h, w) from gt_dir or None,
    the crop's intrinsics (cu, cv, fu, fv))."""
    from ..core.geometry.calibration import Calibration
    from ..data import kitti_io

    calib = Calibration(root / "calib" / f"{idx}.txt")
    lidar = kitti_io.read_velodyne_bin(root / "velodyne" / f"{idx}.bin")
    image = kitti_io.read_png(root / "image_2" / f"{idx}.png")
    full_h, full_w = image.shape[:2]
    crop, left, top = bottom_crop(image, h, w)
    rgb = crop.astype(np.float32) / 255.0
    sd, _, _ = bottom_crop(sparse_depth_from_lidar(lidar, calib, full_h, full_w), h, w)
    gt = None
    if gt_dir is not None:
        p = Path(gt_dir) / f"{idx}.npy"
        if p.exists():
            gt = bottom_crop(np.load(p).astype(np.float32), h, w)[0]
    return rgb, sd, gt, (calib.cu - left, calib.cv - top, calib.fu, calib.fv)


def make_frames(args, rng):
    """The (rgb, sparse input, supervision, intrinsics) frames, drawn from `rng`
    as the JAX script draws them."""
    h, w = args.height, args.width
    frames = []
    if args.synthetic:
        for _ in range(args.synthetic):
            rgb, dense = synthetic_frame(rng, h, w)
            keep = rng.rand(h, w) < 0.05  # LiDAR-like 5% coverage
            sd = np.where(keep, dense, 0.0).astype(np.float32)
            sup = np.where(~keep, dense, 0.0).astype(np.float32)
            frames.append((rgb, sd, sup, (w / 2.0, h / 2.0, 720.0, 720.0)))
        return frames
    if not args.detpath:
        raise SystemExit("train_depth: --detpath or --synthetic is required")
    root = Path(args.detpath)
    for idx in sorted(p.stem for p in (root / "velodyne").glob("*.bin")):
        rgb, sd_full, gt, intr = load_kitti_frame(root, idx, h, w, args.gt_dir)
        if gt is not None:
            frames.append((rgb, sd_full, gt, intr))
        else:
            keep = rng.rand(h, w) < args.keep_frac
            sd = np.where(keep & (sd_full > 0), sd_full, 0.0)
            sup = np.where(~keep & (sd_full > 0), sd_full, 0.0)
            frames.append((rgb, sd.astype(np.float32), sup.astype(np.float32), intr))
    return frames


def split_frames(frames, val_frac):
    """(val, train): the first round(N · val_frac) frames (at least 1) are val."""
    n_val = max(1, int(round(len(frames) * val_frac)))
    return frames[:n_val], frames[n_val:]


@torch.no_grad()
def init_weights_(model, generator):
    """The port's initialisation: every conv kernel normal with variance
    1 / fan-in (flax's lecun_normal scale; a transposed conv's fan-in is its
    input channels × window), biases 0, BN at identity, drawn on the CPU from
    `generator` in state_dict order."""
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            fan_in = p.shape[0] * p[0, 0].numel() if "ConvTranspose" in name else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
        elif name.endswith("bias"):
            p.zero_()


def build_model(name: str, widths, seed: int, device):
    """DEPTH_MODELS[name] at `widths` on `device`, initialised from `seed`."""
    model = DEPTH_MODELS[name](widths=tuple(widths), device=device)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model


def depth_loss(out, sup, criterion, cspn: bool, w1: float = 0.0, w2: float = 0.0):
    """(loss, the supervised prediction): a CSPN net's refined output alone,
    ENet's fused, cd and dd outputs weighted by the stage weights."""
    if cspn:
        refined = out[0]
        return criterion(refined, sup), refined
    fused, cd, dd = out
    loss = ((1.0 - w1 - w2) * criterion(fused, sup) + w1 * criterion(cd, sup)
            + w2 * criterion(dd, sup))
    return loss, fused


def true_fp32(device, dtype):
    """TF32 off on the card for an fp32 run; nothing otherwise."""
    if dtype == torch.float32 and device.type == "cuda":
        return fp32_math(False)
    return contextlib.nullcontext()


def precision(device, dtype):
    """bf16 autocast, or true fp32 (TF32 off) on the card."""
    if dtype == torch.float32:
        return true_fp32(device, dtype)
    return torch.autocast(device.type, dtype=dtype)


def frame_tensors(frame, device):
    """A frame as (rgb (1, 3, H, W), sparse (1, 1, H, W), supervision
    (1, 1, H, W)) on `device`, and its intrinsics."""
    rgb, sd, sup, intr = frame
    rgb = torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1)))[None]
    return (rgb.to(device), torch.from_numpy(sd)[None, None].to(device),
            torch.from_numpy(sup)[None, None].to(device)), intr


def trainable_parameters(model, cspn: bool, freeze_backbone: bool):
    """The parameters the optimizer updates: all but a CSPN net's backbone
    when it is frozen (those stop asking for gradients)."""
    frozen = cspn and freeze_backbone
    params = []
    for name, p in model.named_parameters():
        if frozen and name.startswith("backbone."):
            p.requires_grad_(False)
        else:
            params.append(p)
    return params


class DepthTrainStep:
    """One update of the JAX script's train_step: forward in train mode, the
    loss, backward, Adam at the schedule's rate for the update count.
    `__call__(frame, w1, w2)` → (loss, the supervised prediction, the
    supervision), tensors on the device."""

    def __init__(self, model, cspn: bool, criterion, lr: float, steps_per_epoch: int,
                 pe_decay: bool, freeze_backbone: bool, device, dtype):
        self.model, self.cspn, self.criterion = model, cspn, criterion
        self.lr, self.spe, self.pe_decay = lr, steps_per_epoch, pe_decay
        self.device, self.dtype = device, dtype
        self.params = trainable_parameters(model, cspn, freeze_backbone)
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def __call__(self, frame, w1=0.0, w2=0.0):
        (rgb, sd, sup), intr = frame_tensors(frame, self.device)
        self.model.train()
        with precision(self.device, self.dtype):
            out = self.model(rgb, sd, *intr)
        loss, pred = depth_loss(out, sup, self.criterion, self.cspn, w1, w2)
        self.optimizer.zero_grad(set_to_none=True)
        with true_fp32(self.device, self.dtype):    # the backward's convolutions too
            loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at_step(self.lr, self.step, self.spe, self.pe_decay)
        self.optimizer.step()
        self.step += 1
        return loss.detach(), pred.detach(), sup


@torch.no_grad()
def eval_pred(model, frame, device, dtype):
    """The eval-mode prediction (fused or refined) of one frame: (pred, sup)."""
    (rgb, sd, sup), intr = frame_tensors(frame, device)
    model.eval()
    with precision(device, dtype):
        return model(rgb, sd, *intr)[0], sup


def metrics_and_loss(pred, sup, loss=None):
    """The frame's depth metrics (and the loss), as floats in one transfer."""
    result = evaluate_depth(pred[0, 0], sup[0, 0])
    vals = [result[k] for k in METRIC_KEYS] + ([loss.float()] if loss is not None else [])
    out = torch.stack(vals).tolist()
    return dict(zip(METRIC_KEYS + (["loss"] if loss is not None else []), out))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dfu3d_tpu_torch depth-completion training")
    ap.add_argument("--detpath", type=str, default=None)
    ap.add_argument("--gt_dir", type=str, default=None,
                    help="dense gt depth maps <idx>.npy (KITTI depth-completion groundtruth); "
                         "default: held-out LiDAR")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic piecewise-planar frames")
    ap.add_argument("--model", type=str, default="enet", choices=list(MODELS))
    ap.add_argument("--criterion", type=str, default="l2", choices=["l1", "l2"])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--keep_frac", type=float, default=0.8,
                    help="fraction of LiDAR pixels fed as input; the rest supervise "
                         "(ignored with --gt_dir)")
    ap.add_argument("--val_frac", type=float, default=0.1)
    ap.add_argument("--freeze_backbone", action="store_true",
                    help="freeze the ENet backbone when training a CSPN variant "
                         "(reference main.py --freeze-backbone)")
    ap.add_argument("--out", type=str, default="output/depth_runs/run0")
    ap.add_argument("--widths", type=int, nargs="+", default=None,
                    help="override encoder widths (small nets for tests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES),
                    help="bfloat16: autocast; float32: true fp32 convolutions (TF32 off)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the card unless 'cpu' is asked for")
    return ap.parse_args(argv)


def train(argv=None):
    """Run the CLI; returns {"best_rmse", "model", "frames" (val, train),
    "orders": each epoch's train order, "steps": per step {"epoch", "loss",
    the depth metrics, "host_ms" (from the frame on the host to its metrics on
    the host)}, "epochs": per epoch the train and val averages, "ckpt": the
    best checkpoint's path or None}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    logger = create_logger()
    rng = np.random.RandomState(args.seed)
    h, w = args.height, args.width

    frames = make_frames(args, rng)
    val_frames, train_frames = split_frames(frames, args.val_frac)
    logger.info(f"depth train: {len(train_frames)} train / {len(val_frames)} val frames "
                f"@ {h}x{w}")

    widths = tuple(args.widths) if args.widths else DEFAULT_WIDTHS
    model = build_model(args.model, widths, args.seed, device)
    cspn = args.model != "enet"
    pe_decay = cspn and not args.freeze_backbone
    criterion = masked_l2_loss if args.criterion == "l2" else masked_l1_loss
    step = DepthTrainStep(model, cspn, criterion, args.lr,
                          max(1, len(train_frames)), pe_decay, args.freeze_backbone, device,
                          dtype)

    out_dir = Path(args.out)
    csvlog = DepthCsvLogger(out_dir)
    ckpt = None
    steps, epochs, orders = [], [], []
    for epoch in range(args.epochs):
        lr = lr_for_epoch(args.lr, epoch, pe_decay)
        w1, w2 = stage_weights(epoch) if not cspn else (0.0, 0.0)
        meter, t0 = DepthAverageMeter(), time.time()
        order = rng.permutation(len(train_frames))
        orders.append(order)
        for i in order:
            t = time.perf_counter()
            loss, pred, sup = step(train_frames[i], w1, w2)
            vals = metrics_and_loss(pred, sup, loss)
            steps.append({"epoch": epoch, **vals, "host_ms": (time.perf_counter() - t) * 1e3})
            meter.update(vals)
        train_avg = meter.average()
        csvlog.append("train", epoch, train_avg, gpu_time=time.time() - t0)
        logger.info(f"epoch {epoch} lr={lr:.2e} train rmse={train_avg['rmse']:.1f}mm"
                    f" mae={train_avg['mae']:.1f}mm delta1={train_avg['delta1']:.3f}")

        meter, comp_rows = DepthAverageMeter(), []
        for frame in val_frames:
            pred, sup = eval_pred(model, frame, device, dtype)
            meter.update(metrics_and_loss(pred, sup))
            if len(comp_rows) < 8:
                # reference conditional_save_img_comparison (helper.py:139):
                # up to 8 [rgb|sparse|pred|gt] rows per val epoch
                comp_rows.append(comparison_row(frame[0], frame[1],
                                                pred[0, 0].float().cpu().numpy(), frame[2]))
        save_img_comparison(out_dir / f"comparison_{epoch}.png", comp_rows)
        avg = meter.average()
        if csvlog.append("val", epoch, avg):
            if comp_rows:
                save_img_comparison(out_dir / "comparison_best.png", comp_rows)
            ckpt = out_dir / "best_ckpt.pth"
            torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
            logger.info(f"  new best (val rmse {avg['rmse']:.1f}mm) → {ckpt}")
        logger.info(f"epoch {epoch} val rmse={avg['rmse']:.1f}mm "
                    f"irmse={avg['irmse']:.2f} imae={avg['imae']:.2f}")
        epochs.append({"epoch": epoch, "lr": lr, "train": train_avg, "val": avg})
    return {"best_rmse": csvlog.best_rmse, "model": model, "frames": (val_frames, train_frames),
            "orders": orders, "steps": steps, "epochs": epochs, "ckpt": ckpt}


def main(argv=None):
    """The CLI; returns the best val RMSE (mm), as the JAX script does."""
    return train(argv)["best_rmse"]


if __name__ == "__main__":
    main()
