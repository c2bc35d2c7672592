"""Depth completion, ENet-style, and its DA-CSPN++ refinement (port of
dfu3d_tpu/models/depth_completion.py; reference: tools/PENet/model.py).

* `geometry_feature` — (u, v, depth) → camera-frame xyz channels
  (basic.py:270).
* Two encoder–decoder branches with skips: color-dominant (rgb + sparse
  depth + geometry) and depth-dominant (sparse depth + the color branch's
  depth + geometry); each outputs (depth, confidence).
* Confidence-softmax fusion of the two branch depths (`ENet`).
* `masked_l2_loss` / `masked_l1_loss` — supervised only where the target is
  positive (criteria.py:6-30).
* `CSPNGuide`, `cspn_iterate` and `PENetC2` / `PENetC1` / `PENetC4` — ENet
  plus multi-kernel (3/5/7) convolutional spatial propagation with the
  sparse input pinned every iteration (model.py:382-742).

Every module trains: `model.train()` switches its BNs to flax's batch
statistics (the one-pass biased variance, running statistics kept at 0.9 per
step, `backbone_2d.BatchNorm`), `model.eval()` back to the running ones.

Tensors are NCHW. Submodules carry the flax module names (color_branch,
ConvBnRelu_3, Conv_0, BatchNorm_0, guide5_s2.gen, ...), so
`convert.params_from_jax` maps the JAX package's variables mechanically. flax
convolutions pad SAME: XLA pads a stride-2 3×3 conv (0, 1) on an even size
and (1, 1) on an odd one, where torch's padding=1 would pad (1, 1) and shift
the output by a pixel, so the pads here are computed from the input size as
XLA computes them. `jax.image.resize` antialiases a bilinear downsample and
picks source pixel ⌊(i + ½)·s⌋ for a nearest one: torch's `antialias=True` and
`"nearest-exact"` do the same.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .backbone_2d import BatchNorm

DEPTH_BN_KEEP = 0.9   # flax BatchNorm(momentum=0.9) of the depth nets
CSPN_KERNELS = (3, 5, 7)


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


class BatchNorm2d(BatchNorm):
    """flax BatchNorm(momentum=0.9, epsilon=1e-5) over dim 1 in fp32, the
    result cast back to the input's dtype: running statistics in eval, batch
    statistics (and their running update) in train mode. Built in eval mode,
    as every depth net is, so a block used on its own serves until
    `train()` is asked for."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps, keep=DEPTH_BN_KEEP)
        self.eval()


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
    """Two-branch depth completion with confidence fusion, built on `device`
    (the card unless "cpu" is asked for) in eval mode; `train()` gives the
    batch-statistics BN of flax's train=True."""

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


def masked_l2_loss(pred, target):
    """MaskedMSELoss (criteria.py:6-17): the mean over target > 0 pixels."""
    mask = (target > 0).float()
    diff = (pred - target) * mask
    return torch.sum(diff ** 2) / torch.clamp(torch.sum(mask), min=1.0)


def masked_l1_loss(pred, target):
    """MaskedL1Loss (criteria.py:19-30)."""
    mask = (target > 0).float()
    return torch.sum(torch.abs(pred - target) * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# CSPN / DA-CSPN++ refinement (reference tools/PENet/basic.py:155-279 +
# model.py:382-742 PENet_C1/C2/C4)
# ---------------------------------------------------------------------------

def patches(x, k: int, dilation: int):
    """(B, 1, H, W) → (B, k², H, W): the zero-padded, dilated k × k
    neighbourhood of every pixel, row-major over the window
    (lax.conv_general_dilated_patches' order)."""
    b, _, h, w = x.shape
    return F.unfold(x, k, dilation=dilation, padding=dilation * (k // 2)).view(b, k * k, h, w)


def resize_bilinear(x, size):
    """jax.image.resize(x, ..., "bilinear") of an NCHW map: half-pixel
    centres, antialiased when it shrinks."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def resize_nearest(x, size):
    """jax.image.resize(x, ..., "nearest"): output i reads ⌊(i + ½)·s⌋."""
    return F.interpolate(x, size=size, mode="nearest-exact")


class CSPNGuide(nn.Module):
    """Affinity generator (reference CSPNGenerate/Accelerate): k² − 1 neighbour
    weights normalised by their |·|-sum, the centre weight 1 − Σ neighbours
    inserted at index (k² − 1) / 2 (a partition of unity). fp32 out."""

    def __init__(self, in_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.gen = ConvBnRelu(in_channels, kernel_size * kernel_size - 1)

    def forward(self, feats):
        k = self.kernel_size
        g = self.gen(feats).float()
        g = g / torch.clamp(torch.sum(torch.abs(g), dim=1, keepdim=True), min=1e-6)
        center = 1.0 - torch.sum(g, dim=1, keepdim=True)
        half = (k * k - 1) // 2
        return torch.cat([g[:, :half], center, g[:, half:]], dim=1)


def cspn_iterate(depth, guide, sparse_depth, valid_mask, k: int, dilation: int, iters: int):
    """`iters` steps of convolutional spatial propagation, the sparse input
    re-pinned after each (reference CSPNAccelerate loop + mask re-injection,
    model.py:653-741). depth, sparse_depth, valid_mask (B, 1, H, W); guide
    (B, k², H, W)."""
    h = depth
    for _ in range(iters):
        h2 = torch.sum(patches(h, k, dilation) * guide, dim=1, keepdim=True)
        h = valid_mask * sparse_depth + (1.0 - valid_mask) * h2
    return h


class PENetC2(nn.Module):
    """ENet + two-scale DA-CSPN++ refinement (reference PENet_C2,
    model.py:382-525): guides of kernels 3/5/7 mixed by a per-pixel kernel
    confidence; propagation at half resolution with dilation 2 (`S2_DILATION`),
    the result resized up and re-pinned, then at full resolution with
    dilation `S1_DILATION`; the sparse input is pinned every iteration. As in
    the JAX package, the guidance features come from a small conv stack over
    [rgb, sparse, coarse depth]. Built on `device` in eval mode.

    forward → (refined, coarse, (cd_depth, dd_depth)), each (B, 1, H, W) fp32."""

    S2_DILATION = 2
    S1_DILATION = 1

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256), iters: int = 6,
                 device="cuda"):
        super().__init__()
        self.iters = iters
        self.backbone = ENet(widths, device="cpu")
        self.guide_feat_s1 = ConvBnRelu(5, 64)
        if self.S2_DILATION:
            self.guide_feat_s2 = ConvBnRelu(64, 128, stride=2)
            self.kconf_s2 = ConvBnRelu(128, 3)
            for k in CSPN_KERNELS:
                self.add_module(f"guide{k}_s2", CSPNGuide(128, k))
        self.kconf_s1 = ConvBnRelu(64, 3)
        for k in CSPN_KERNELS:
            self.add_module(f"guide{k}_s1", CSPNGuide(64, k))
        self.to(resolve_device(device)).eval()

    def propagate(self, feats, scale, depth, sparse_depth, valid, dilation):
        """The three kernels' propagations from `depth`, mixed by the softmax
        of kconf_<scale> over the features."""
        conf = torch.softmax(getattr(self, f"kconf_{scale}")(feats).float(), dim=1)
        outs = [cspn_iterate(depth, getattr(self, f"guide{k}_{scale}")(feats), sparse_depth,
                             valid, k, dilation, self.iters) for k in CSPN_KERNELS]
        return sum(conf[:, i:i + 1] * o for i, o in enumerate(outs))

    def forward(self, rgb, sparse_depth, cu, cv, fu, fv):
        coarse, cd, dd = self.backbone(rgb, sparse_depth, cu, cv, fu, fv)
        f1 = self.guide_feat_s1(torch.cat([rgb, sparse_depth, coarse], dim=1))
        valid = (sparse_depth > 1e-3).float()
        depth = coarse
        if self.S2_DILATION:
            f2 = self.guide_feat_s2(f1)
            h, w = coarse.shape[-2:]
            d_s2 = resize_bilinear(depth, (h // 2, w // 2))
            s_s2 = resize_nearest(sparse_depth, (h // 2, w // 2))
            v_s2 = (s_s2 > 1e-3).float()
            d_s2 = self.propagate(f2, "s2", d_s2, s_s2, v_s2, self.S2_DILATION)
            depth = resize_bilinear(d_s2, (h, w))
            depth = valid * sparse_depth + (1 - valid) * depth
        refined = self.propagate(f1, "s1", depth, sparse_depth, valid, self.S1_DILATION)
        return refined, coarse, (cd, dd)


class PENetC1(PENetC2):
    """Single-scale DA-CSPN++ (reference PENet_C1): full resolution only."""

    S2_DILATION = 0


class PENetC4(PENetC2):
    """Single-scale DA-CSPN++ at dilation 4 (reference PENet_C4, as the JAX
    package builds it: the full-resolution stage only)."""

    S2_DILATION = 0
    S1_DILATION = 4


DEPTH_MODELS = {"enet": ENet, "penet_c1": PENetC1, "penet_c2": PENetC2, "penet_c4": PENetC4}
