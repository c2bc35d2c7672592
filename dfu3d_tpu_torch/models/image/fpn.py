"""GeneralizedLSSFPN, BEVFusion's image neck (port of dfu3d_tpu/models/image/
fpn.py; reference pcdet/models/backbones_image/img_neck/generalized_lss.py).

With n input levels, fine to coarse, n - 1 are processed, top down: the
topmost processed level concatenates the raw coarsest input upsampled
bilinearly to its size, each level below the processed level above it;
each processed level is a 1×1 conv → BN → ReLU (lateral{i}, lateral_bn{i})
then a 3×3 conv → BN → ReLU (fpn{i}, fpn_bn{i}). NHWC in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import image_bn, nhwc, resize_bilinear


class GeneralizedLSSFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 2):
        super().__init__()
        self.num_outs = num_outs
        n = len(in_channels)
        prev = in_channels[-1]
        for i in range(n - 2, -1, -1):
            self.add_module(f"lateral{i}", nn.Conv2d(in_channels[i] + prev, out_channels, 1,
                                                     bias=False))
            self.add_module(f"lateral_bn{i}", image_bn(out_channels))
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1,
                                                 bias=False))
            self.add_module(f"fpn_bn{i}", image_bn(out_channels))
            prev = out_channels

    def forward(self, feats):
        """feats: [(B, H_i, W_i, C_i)] fine → coarse → the processed levels
        0 .. num_outs - 1, (B, H_i, W_i, out_channels)."""
        n = len(feats)
        outs = [None] * (n - 1)
        prev = feats[-1]
        for i in range(n - 2, -1, -1):
            x = feats[i]
            up = resize_bilinear(prev, x.shape[1:3]).to(x.dtype)
            x = torch.cat([x, up], dim=-1)

            def level(y, i=i):
                y = F.relu(getattr(self, f"lateral_bn{i}")(getattr(self, f"lateral{i}")(y)))
                return F.relu(getattr(self, f"fpn_bn{i}")(getattr(self, f"fpn{i}")(y)))

            outs[i] = prev = nhwc(level, x)
        return outs[:self.num_outs]
