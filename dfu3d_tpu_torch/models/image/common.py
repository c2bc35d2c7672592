"""What the image modules share: NHWC convs on PyTorch's NCHW ops, flax's
BatchNorm at keep 0.9, and the two resizes of jax.image.resize."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbone_2d import BatchNorm


def nhwc(fn, x):
    """fn, an NCHW module or function, on an NHWC tensor; the NCHW view of
    NHWC memory is PyTorch's channels_last format, so no copy is made."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def image_bn(channels: int) -> BatchNorm:
    """flax BatchNorm(momentum=0.9, epsilon=1e-5), the image modules' BN."""
    return BatchNorm(channels, eps=1e-5, keep=0.9)


class StridedConv1x1(nn.Conv2d):
    """A 1×1 conv at stride s without bias as the stride-1 conv of every
    s-th pixel, which it equals (a 1×1 kernel needs no padding): PyTorch
    2.13's CPU backward of a strided 1×1 conv crashes on a channels-last
    input of 4 channels."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(cin, cout, 1, bias=False)
        self.step = stride

    def forward(self, x):
        return super().forward(x[:, :, ::self.step, ::self.step])


def add_conv_bn(module: nn.Module, prefix: str, cin: int, cout: int, k: int, stride: int = 1):
    """Registers `{prefix}_conv` (k × k, padding k // 2, no bias) and
    `{prefix}_bn` on `module`, the flax names of depth_lss's
    `_conv_bn_relu`."""
    module.add_module(f"{prefix}_conv", nn.Conv2d(cin, cout, k, stride, k // 2, bias=False))
    module.add_module(f"{prefix}_bn", image_bn(cout))


def conv_bn_relu(module: nn.Module, prefix: str, x):
    """`add_conv_bn`'s conv → BN → ReLU on an NCHW tensor."""
    return F.relu(getattr(module, f"{prefix}_bn")(getattr(module, f"{prefix}_conv")(x)))


def resize_bilinear(x, size):
    """jax.image.resize(x, (B, *size, C), "bilinear" / "linear") of an NHWC
    map: half-pixel centres (F.interpolate's align_corners=False bilinear),
    antialiased where it shrinks (antialias=True, as depth_completion's
    resize; on an upsampling torch's antialiased weights differ from JAX's
    by ~1e-5, its plain ones agree)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    shrinks = size[0] < x.shape[1] or size[1] < x.shape[2]
    return nhwc(lambda y: F.interpolate(y, size=tuple(size), mode="bilinear",
                                        align_corners=False, antialias=shrinks), x)


def nearest_indices(n_in: int, n_out: int, device=None):
    """jax.image.resize's "nearest" source rows: floor((i + 0.5) · in / out)
    in fp32, the product first. F.interpolate's "nearest-exact" multiplies by
    the rounded ratio in / out instead, and on CaDDN's 1242 → 311 columns the
    two differ at i = 155, where the exact value is the integer 621."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def resize_nearest(x, size):
    """jax.image.resize(x, (B, *size), "nearest") of a (B, H, W) map."""
    rows = nearest_indices(x.shape[1], size[0], x.device)
    cols = nearest_indices(x.shape[2], size[1], x.device)
    return x[:, rows][:, :, cols]
