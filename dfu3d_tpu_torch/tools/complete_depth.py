"""Depth completion: `depth/<idx>.npy` artifacts for the pseudo-box factory from
LiDAR + image (port of the JAX package's tools/complete_depth.py; reference:
the PENet path of tools/PENet/main.py, which DepthAnything supersedes at run
time there — an external metric-depth model can drop its maps into the same
layout).

    python -m dfu3d_tpu_torch.tools.complete_depth --detpath ROOT \\
        [--model enet|enet_ref] [--ckpt STATE_DICT.pth | --torch_ckpt pe.pth.tar] \\
        [--height 352 --width 1216] [--widths 32 64 128 256] [--out_dir DIR] \\
        [--device cuda] [--dtype bfloat16]

Each frame's image is cropped to (height, width) at the bottom centre
(PENet's BottomCrop; zeros where the image is smaller), the LiDAR projected
into a sparse depth image, the net run on the crop with the intrinsics
shifted by it, and the prediction placed back into a full-frame map. Without
a checkpoint the weights are torch's initialisation from --seed
(placeholder depth).
"""
from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import numpy as np
import torch

from ..core.geometry.calibration import Calibration
from ..data import kitti_io
from ..device import resolve_device
from ..utils.common import create_logger
from .common import DTYPES


def sparse_depth_from_lidar(lidar, calib, h, w):
    """Project LiDAR into a sparse depth image (PENet my_loader.load_depth_input)."""
    pts_img, depth = calib.lidar_to_img(lidar[:, :3])
    pix = np.round(pts_img).astype(int)
    ok = (pix[:, 0] >= 0) & (pix[:, 0] < w) & (pix[:, 1] >= 0) & (pix[:, 1] < h) & (depth > 0)
    out = np.zeros((h, w), np.float32)
    out[pix[ok, 1], pix[ok, 0]] = depth[ok]
    return out


def bottom_crop(image, h, w):
    """(h, w) crop at the bottom centre (left = (W - w) // 2, top = H - h,
    both at least 0), zero-filled where the image is smaller, as PIL's crop
    gives it. Returns (crop, left, top)."""
    full_h, full_w = image.shape[:2]
    left, top = max((full_w - w) // 2, 0), max(full_h - h, 0)
    out = np.zeros((h, w) + image.shape[2:], image.dtype)
    part = image[top:top + h, left:left + w]
    out[:part.shape[0], :part.shape[1]] = part
    return out, left, top


def position_plane(h, w):
    """CoordConv position plane (reference CoordConv.AddCoordsNp): (2, h, w),
    u then v, each normalised to [-1, 1] over the crop."""
    uu, vv = np.meshgrid(np.linspace(-1, 1, w, dtype=np.float32),
                         np.linspace(-1, 1, h, dtype=np.float32))
    return np.stack([uu, vv])


def build_depth_model(name: str, device, widths=None):
    """enet_ref, or the compact ENet at `widths` (default (32, 64, 128, 256))."""
    from ..models.depth_completion import ENet
    from ..models.penet_ref import ENetRef

    if name == "enet_ref":
        return ENetRef(device=device)
    return ENet(widths, device=device) if widths else ENet(device=device)


@contextlib.contextmanager
def fp32_math(tf32: bool):
    """cuDNN's convolutions and cuBLAS's matmuls in TF32 (torch's default for
    cuDNN) or in true fp32, for the duration of the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class DepthCompleter:
    """One depth net on `device` under `dtype` autocast: `__call__(image,
    lidar, calib)` → the full-frame (H, W) float32 depth map. float32 runs
    the card's convolutions and matmuls in true fp32, or in TF32 when `tf32`."""

    def __init__(self, model, name: str, height: int, width: int, device, dtype,
                 tf32: bool = False):
        self.model, self.name = model, name
        self.h, self.w = height, width
        self.device, self.dtype, self.tf32 = device, dtype, tf32
        self.position = torch.from_numpy(position_plane(height, width))[None].to(device)

    @torch.no_grad()
    def __call__(self, image, lidar, calib):
        full_h, full_w = image.shape[:2]
        crop, left, top = bottom_crop(image, self.h, self.w)
        sd_full = sparse_depth_from_lidar(lidar, calib, full_h, full_w)
        sd, _, _ = bottom_crop(sd_full, self.h, self.w)
        rgb = torch.from_numpy(crop.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
        rgb, sd = rgb.to(self.device), torch.from_numpy(sd)[None, None].to(self.device)
        cu, cv = np.float32(calib.cu - left), np.float32(calib.cv - top)
        fp32 = self.dtype == torch.float32
        precision = (fp32_math(self.tf32) if fp32 and self.device.type == "cuda"
                     else contextlib.nullcontext())
        with precision, torch.autocast(self.device.type, dtype=self.dtype, enabled=not fp32):
            if self.name == "enet_ref":
                K = torch.tensor([[[calib.fu, 0.0, cu], [0.0, calib.fv, cv], [0.0, 0.0, 1.0]]],
                                 dtype=torch.float32, device=self.device)
                fused = self.model(rgb, sd, self.position, K)["output"]
            else:
                fused = self.model(rgb, sd, cu, cv, calib.fu, calib.fv)[0]
        out = np.zeros((full_h, full_w), np.float32)
        crop_depth = fused[0, 0].float().cpu().numpy()
        out[top:top + self.h, left:left + self.w] = crop_depth[:min(self.h, full_h - top),
                                                               :min(self.w, full_w - left)]
        return out


def main(argv=None):
    """Returns {"written": [paths], "report": the --torch_ckpt conversion
    report or None}."""
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch depth completion")
    parser.add_argument("--detpath", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="the port's state_dict (.pth) of the chosen model")
    parser.add_argument("--model", type=str, default="enet", choices=["enet", "enet_ref"],
                        help="enet: the compact net; enet_ref: the reference-exact PENet "
                             "ENet, which loads released checkpoints through --torch_ckpt")
    parser.add_argument("--torch_ckpt", type=str, default=None,
                        help="released PENet checkpoint (e.pth.tar / pe.pth.tar), carried "
                             "across by convert.enet_mapping (needs --model enet_ref)")
    parser.add_argument("--height", type=int, default=352)
    parser.add_argument("--width", type=int, default=1216)
    parser.add_argument("--widths", type=int, nargs="+", default=None,
                        help="the compact ENet's encoder widths, as tools.train_depth "
                             "--widths trained it (default 32 64 128 256)")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=None)
    parser.add_argument("--out_dir", type=str, default=None,
                        help="where the maps go (default: DETPATH/depth)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds torch's initialisation where no checkpoint is given")
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES),
                        help="bfloat16: autocast; float32: true fp32 convolutions (TF32 off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)
    if args.torch_ckpt and args.model != "enet_ref":
        parser.error("--torch_ckpt needs --model enet_ref")

    from .. import convert

    device = resolve_device(args.device)
    logger = create_logger()
    root = Path(args.detpath)
    out_dir = Path(args.out_dir) if args.out_dir else root / "depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    ids = sorted(p.stem for p in (root / "velodyne").glob("*.bin"))[args.start:args.end]

    torch.manual_seed(args.seed)
    model = build_depth_model(args.model, device, args.widths)
    report = None
    if args.torch_ckpt:
        report = convert.load_enet_reference(model, convert.load_torch_state(args.torch_ckpt))
        logger.info(f"converted {len(report['converted'])} tensors from {args.torch_ckpt} "
                    f"(missing: {len(report['missing_in_torch'])})")
    elif args.ckpt:
        model.load_state_dict(torch.load(args.ckpt, map_location=device))
    completer = DepthCompleter(model, args.model, args.height, args.width, device,
                               DTYPES[args.dtype])
    written = []
    for idx in ids:
        calib = Calibration(root / "calib" / f"{idx}.txt")
        lidar = kitti_io.read_velodyne_bin(root / "velodyne" / f"{idx}.bin")
        image = kitti_io.read_png(root / "image_2" / f"{idx}.png")
        np.save(out_dir / f"{idx}.npy", completer(image, lidar, calib))
        written.append(out_dir / f"{idx}.npy")
    logger.info(f"wrote {len(written)} depth maps to {out_dir}")
    return {"written": written, "report": report}


if __name__ == "__main__":
    main()
