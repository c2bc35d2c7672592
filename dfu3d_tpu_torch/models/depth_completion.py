"""Compact two-branch depth completion, ENet-style (port of the serving part of
dfu3d_tpu/models/depth_completion.py; reference: tools/PENet/model.py).

* `geometry_feature` — (u, v, depth) → camera-frame xyz channels
  (basic.py:270).
* Two encoder–decoder branches with skips: color-dominant (rgb + sparse
  depth + geometry) and depth-dominant (sparse depth + the color branch's
  depth + geometry); each outputs (depth, confidence).
* Confidence-softmax fusion of the two branch depths.

Tensors are NCHW. Submodules carry the flax module names (color_branch,
ConvBnRelu_3, Conv_0, BatchNorm_0, ...), so `convert.params_from_jax` maps the
JAX package's variables mechanically. flax convolutions pad SAME: XLA pads a
stride-2 3×3 conv (0, 1) on an even size and (1, 1) on an odd one, where
torch's padding=1 would pad (1, 1) and shift the output by a pixel, so the
pads here are computed from the input size as XLA computes them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


def geometry_feature(depth, cu, cv, fu, fv):
    """(B, 1, H, W) depth → (B, 3, H, W) camera xyz (reference GeometryFeature);
    the intrinsics are numbers or 0-dim tensors."""
    h, w = depth.shape[-2:]
    vv = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    uu = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=depth.device)

    x = (uu - scalar(cu)) * depth / scalar(fu)
    y = (vv - scalar(cv)) * depth / scalar(fv)
    return torch.cat([x, y, depth], dim=1)


def same_pads(size: int, kernel: int, stride: int):
    """XLA's SAME padding (lo, hi) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class BatchNorm2d(nn.Module):
    """flax BatchNorm in eval over dim 1 (running statistics, eps 1e-5) in
    fp32, the result cast back to the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                         training=False, eps=self.eps)
        return y.to(x.dtype)


class ConvBnRelu(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1, kernel: int = 3):
        super().__init__()
        self.stride, self.kernel = stride, kernel
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        (t, b), (left, r) = (same_pads(s, self.kernel, self.stride) for s in x.shape[-2:])
        return F.relu(self.BatchNorm_0(self.Conv_0(F.pad(x, (left, r, t, b)))))


class DeconvBnRelu(nn.Module):
    """flax ConvTranspose(2×2, stride 2, SAME): no overlap, output = 2 · input."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_channels, features, 2, 2, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class EncoderDecoder(nn.Module):
    """Strided encoder + skip-connected decoder → (depth, confidence), each
    (B, 1, H, W); H and W must be multiples of 2^(len(widths) - 1)."""

    def __init__(self, in_channels: int, widths: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.widths = tuple(widths)
        convs = [ConvBnRelu(in_channels, widths[0])]
        for prev, wdt in zip(widths[:-1], widths[1:]):
            convs += [ConvBnRelu(prev, wdt, stride=2), ConvBnRelu(wdt, wdt)]
        deconvs = []
        for prev, wdt in zip(reversed(widths[1:]), reversed(widths[:-1])):
            deconvs.append(DeconvBnRelu(prev, wdt))
            convs.append(ConvBnRelu(2 * wdt, wdt))
        for i, m in enumerate(convs):
            self.add_module(f"ConvBnRelu_{i}", m)
        for i, m in enumerate(deconvs):
            self.add_module(f"DeconvBnRelu_{i}", m)
        self.Conv_0 = nn.Conv2d(widths[0], 2, 3, padding=1)

    def forward(self, x):
        n = len(self.widths) - 1
        conv = [getattr(self, f"ConvBnRelu_{i}") for i in range(1 + 3 * n)]
        skips = []
        h = conv[0](x)
        for i in range(n):
            skips.append(h)
            h = conv[2 + 2 * i](conv[1 + 2 * i](h))
        for i, skip in enumerate(reversed(skips)):
            h = getattr(self, f"DeconvBnRelu_{i}")(h)
            h = conv[1 + 2 * n + i](torch.cat([h, skip], dim=1))
        out = self.Conv_0(h).float()
        return F.softplus(out[:, 0:1]), out[:, 1:2]


class ENet(nn.Module):
    """Two-branch depth completion with confidence fusion, in eval mode, on
    `device` (the card unless "cpu" is asked for)."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256), device="cuda"):
        super().__init__()
        self.color_branch = EncoderDecoder(7, widths)
        self.depth_branch = EncoderDecoder(5, widths)
        self.to(resolve_device(device)).eval()

    def forward(self, rgb, sparse_depth, cu, cv, fu, fv):
        """rgb (B, 3, H, W) in [0, 1]; sparse_depth (B, 1, H, W), 0 = missing;
        the intrinsics of the crop. Returns (fused, cd_depth, dd_depth), each
        (B, 1, H, W) fp32."""
        geo = geometry_feature(sparse_depth, cu, cv, fu, fv)
        cd_depth, cd_conf = self.color_branch(torch.cat([rgb, sparse_depth, geo], dim=1))
        dd_depth, dd_conf = self.depth_branch(torch.cat([sparse_depth, cd_depth, geo], dim=1))
        w = torch.softmax(torch.cat([cd_conf, dd_conf], dim=1), dim=1)
        return w[:, 0:1] * cd_depth + w[:, 1:2] * dd_depth, cd_depth, dd_depth
