"""2D BEV backbones (port of dfu3d_tpu/models/backbone_2d.py BaseBEVBackbone,
BaseBEVResBackbone and BaseBEVBackboneV1).

Public layout is the JAX one, (B, H, W, C). Inside, the NHWC tensor is viewed
as NCHW without a copy, which is PyTorch's channels_last memory format, so
cuDNN runs its NHWC kernels and the output view is contiguous NHWC again.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (flax BatchNorm(dtype=float32) followed by the
    module's compute-dtype cast): fp32 math (fp64 for an fp64 input), the
    result cast back to the input's dtype. Eval uses the running statistics. Training uses the batch
    statistics of flax: mean and the biased variance E[x²] - mean², clamped
    at 0, and updates the running statistics as running · keep + batch ·
    (1 - keep) (flax `momentum` = keep; torch's momentum would be 1 - keep).
    Over several ranks the statistics are those of the global batch: Σx,
    Σx² and the count summed over ranks in one all-reduce."""

    GLOBAL_BATCH = True

    def __init__(self, num_features: int, eps: float, keep: float = 0.99):
        super().__init__()
        self.eps = eps
        self.keep = keep
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        # fp32 math for bf16 / fp16 / fp32 inputs, fp64 for fp64 ones
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                             self.bias, training=False, eps=self.eps)
            return y.to(x.dtype)
        dims = [d for d in range(xf.dim()) if d != 1]
        if mesh.world() == 1:
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        else:
            c = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // c)
            sums = mesh.global_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        update_running_stats_(self, mean, var)
        shape = (1, -1) + (1,) * (xf.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


@torch.no_grad()
def update_running_stats_(bn, mean, var):
    """running = keep · running + (1 - keep) · batch, for a module with
    `keep`, `running_mean` and `running_var`."""
    bn.running_mean.copy_(bn.keep * bn.running_mean + (1 - bn.keep) * mean)
    bn.running_var.copy_(bn.keep * bn.running_var + (1 - bn.keep) * var)


class ConvBNReLU(nn.Module):
    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 transpose: bool = False, padding: int = 1):
        super().__init__()
        # submodule names follow the flax tree, so params_from_jax is mechanical
        if transpose:
            # flax ConvTranspose(k = s, padding SAME): no overlap, output = s · input
            self._conv_name = "ConvTranspose_0"
            conv = nn.ConvTranspose2d(in_channels, features, kernel, stride, bias=False)
        else:
            self._conv_name = "Conv_0"
            conv = nn.Conv2d(in_channels, features, kernel, stride, padding, bias=False)
        self.add_module(self._conv_name, conv)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(getattr(self, self._conv_name)(x)))


class BaseBEVBackbone(nn.Module):
    """config keys: LAYER_NUMS, LAYER_STRIDES, NUM_FILTERS, UPSAMPLE_STRIDES,
    NUM_UPSAMPLE_FILTERS."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, layer_nums: Sequence[int], layer_strides: Sequence[int],
                 num_filters: Sequence[int], upsample_strides: Sequence[float],
                 num_upsample_filters: Sequence[int]):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        cin = in_channels
        for i, num_layers in enumerate(self.layer_nums):
            self.add_module(f"block{i}_down",
                            ConvBNReLU(cin, num_filters[i], stride=layer_strides[i]))
            for j in range(num_layers):
                self.add_module(f"block{i}_conv{j}", ConvBNReLU(num_filters[i], num_filters[i]))
            cin = num_filters[i]
            if i < len(self.upsample_strides):
                stride = self.upsample_strides[i]
                if stride >= 1:
                    up = ConvBNReLU(cin, num_upsample_filters[i], kernel=int(stride),
                                    stride=int(stride), transpose=True)
                else:
                    # fractional "upsample" = VALID conv with kernel = stride = 1/s
                    k = int(round(1 / stride))
                    up = ConvBNReLU(cin, num_upsample_filters[i], kernel=k, stride=k, padding=0)
                self.add_module(f"deblock{i}", up)
        self.out_channels = sum(num_upsample_filters[:len(self.upsample_strides)]) or cin

    def forward(self, x):
        """x: (B, H, W, C) → (B, H/out_stride, W/out_stride, sum(upsample filters))."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, num_layers in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_down")(x)
            for j in range(num_layers):
                x = getattr(self, f"block{i}_conv{j}")(x)
            if i < len(self.upsample_strides):
                ups.append(getattr(self, f"deblock{i}")(x))
        if len(ups) > 1:
            x = torch.cat(ups, dim=1)
        elif ups:
            x = ups[0]
        return x.permute(0, 2, 3, 1)


def _deblock(cin: int, features: int, stride: float) -> ConvBNReLU:
    """An upsample stride ≥ 1 is a transposed conv with kernel = stride; a
    fractional one a VALID conv with kernel = stride = 1/s."""
    if stride >= 1:
        return ConvBNReLU(cin, features, kernel=int(stride), stride=int(stride), transpose=True)
    k = int(round(1 / stride))
    return ConvBNReLU(cin, features, kernel=k, stride=k, padding=0)


class ResConvBlock(nn.Module):
    """2D residual basic block (JAX ResConvBlock, backbone_2d.py:89-125;
    reference base_bev_backbone.py BasicBlock): 3×3 conv (stride) → BN →
    ReLU → 3×3 conv → BN, plus the identity or, with `downsample`, a stride
    or a width change, a 1×1 conv + BN shortcut; then ReLU. Bias-free
    convs, BN eps 1e-3. NCHW in and out."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3)
        self.Conv_1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features, eps=1e-3)
        self.has_shortcut = downsample or stride != 1 or in_channels != features
        if self.has_shortcut:
            self.shortcut = nn.Conv2d(in_channels, features, 1, stride, bias=False)
            self.shortcut_bn = BatchNorm(features, eps=1e-3)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        identity = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(y + identity.to(y.dtype))


class BaseBEVResBackbone(nn.Module):
    """Residual-block BEV backbone (JAX BaseBEVResBackbone,
    backbone_2d.py:128-160; reference base_bev_backbone.py:252-330), the
    config surface of BaseBEVBackbone: per level a leading ResConvBlock with
    the level's stride and a conv shortcut (block{i}_down), LAYER_NUMS[i]
    ResConvBlocks (block{i}_res{j}), and its deblock."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, layer_nums: Sequence[int], layer_strides: Sequence[int],
                 num_filters: Sequence[int], upsample_strides: Sequence[float],
                 num_upsample_filters: Sequence[int]):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        cin = in_channels
        for i, num_layers in enumerate(self.layer_nums):
            self.add_module(f"block{i}_down", ResConvBlock(cin, num_filters[i], layer_strides[i],
                                                           downsample=True))
            for j in range(num_layers):
                self.add_module(f"block{i}_res{j}", ResConvBlock(num_filters[i], num_filters[i]))
            cin = num_filters[i]
            if i < len(self.upsample_strides):
                self.add_module(f"deblock{i}", _deblock(cin, num_upsample_filters[i],
                                                        self.upsample_strides[i]))
        self.out_channels = sum(num_upsample_filters[:len(self.upsample_strides)]) or cin

    def forward(self, x):
        """x: (B, H, W, C) → (B, H/out_stride, W/out_stride, sum(upsample filters))."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, num_layers in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_down")(x)
            for j in range(num_layers):
                x = getattr(self, f"block{i}_res{j}")(x)
            if i < len(self.upsample_strides):
                ups.append(getattr(self, f"deblock{i}")(x))
        if len(ups) > 1:
            x = torch.cat(ups, dim=1)
        elif ups:
            x = ups[0]
        return x.permute(0, 2, 3, 1)


BEV_BACKBONES = {"BaseBEVBackbone": BaseBEVBackbone, "BaseBEVResBackbone": BaseBEVResBackbone}


class BaseBEVBackboneV1(nn.Module):
    """The PillarNet neck (port of dfu3d_tpu/models/backbone_2d.py
    BaseBEVBackboneV1, reference base_bev_backbone.py:182-204): the stride-8
    map x4 is deblocked as it comes (deblock0), the stride-16 map x5 runs
    block1 and then deblock1, and block0 refines their concatenation. A
    block is a stride-1 conv (block{i}_in) and LAYER_NUMS[i] more
    (block{i}_conv{j}), each conv-BN-ReLU. Maps are (B, H, W, C) in and
    out."""

    def __init__(self, in_channels: Sequence[int], layer_nums: Sequence[int],
                 num_filters: Sequence[int], upsample_strides: Sequence[float],
                 num_upsample_filters: Sequence[int]):
        super().__init__()
        if not len(in_channels) == len(layer_nums) == 2:
            raise ValueError("BaseBEVBackboneV1 takes two maps and two LAYER_NUMS")
        self.layer_nums = tuple(layer_nums)
        block_in = (sum(num_upsample_filters[:2]), in_channels[1])
        deblock_in = (in_channels[0], num_filters[1])
        for i in range(2):
            self.add_module(f"block{i}_in", ConvBNReLU(block_in[i], num_filters[i]))
            for j in range(self.layer_nums[i]):
                self.add_module(f"block{i}_conv{j}", ConvBNReLU(num_filters[i], num_filters[i]))
            stride = upsample_strides[i]
            if stride >= 1:
                up = ConvBNReLU(deblock_in[i], num_upsample_filters[i], kernel=int(stride),
                                stride=int(stride), transpose=True)
            else:
                k = int(round(1 / stride))
                up = ConvBNReLU(deblock_in[i], num_upsample_filters[i], kernel=k, stride=k,
                                padding=0)
            self.add_module(f"deblock{i}", up)
        self.out_channels = num_filters[0]

    def _block(self, i, x):
        x = getattr(self, f"block{i}_in")(x)
        for j in range(self.layer_nums[i]):
            x = getattr(self, f"block{i}_conv{j}")(x)
        return x

    def forward(self, feature_maps):
        x4, x5 = (m.permute(0, 3, 1, 2) for m in feature_maps)
        x = torch.cat([self.deblock0(x4), self.deblock1(self._block(1, x5))], dim=1)
        return self._block(0, x).permute(0, 2, 3, 1)
