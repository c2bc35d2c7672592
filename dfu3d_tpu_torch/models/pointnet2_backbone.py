"""PointNet++ MSG backbone (port of dfu3d_tpu/models/pointnet2_backbone.py:
SharedMLP, SetAbstractionMSG, FeaturePropagation, PointNet2MSG; the
reference's pcdet/models/backbones_3d/pointnet2_backbone.py PointNet2MSG).

FPS, ball query and 3-NN run batched over the frames (`core.pointnet2`);
the MLPs see the whole batch, so a masked BN counts every valid row of it.
Submodules carry the flax names (sa_{i}.mlp_{s}.dense_{j} / bn_{j},
fp_{i}.SharedMLP_0...). Flax infers input widths; here they come from the
config: a SA scale takes 3 + C_in (the grouped xyz offsets first), an FP
level the coarser level's features followed by the finer level's skip.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core import pointnet2 as P
from .vfe import MaskedBatchNorm


class SharedMLP(nn.Module):
    """Dense (no bias) + masked BN + ReLU over the last axis. BN at torch's
    defaults, eps 1e-5 and running-statistics keep 0.9, as every reference
    stack this mirrors builds it (not the VFE's 1e-3 / 0.99)."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        for i, c in enumerate(self.channels):
            self.add_module(f"dense_{i}", nn.Linear(in_channels, c, bias=False))
            self.add_module(f"bn_{i}", MaskedBatchNorm(c, eps=1e-5, keep=0.9))
            in_channels = c

    @property
    def out_channels(self) -> int:
        return self.channels[-1]

    def forward(self, x, mask):
        """x (..., C); mask broadcastable to x.shape[:-1] (used in training)."""
        mask = mask.expand(x.shape[:-1])
        for i in range(len(self.channels)):
            x = getattr(self, f"dense_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, mask))
        return x


def masked_max(g, mask, dim: int):
    """max over `dim` of g where `mask` (broadcast to g) holds; a group with
    no valid entry gives 0 (a max over -inf, then where(isfinite, ·, 0))."""
    g = torch.where(mask, g, float("-inf")).amax(dim=dim)
    return torch.where(torch.isfinite(g), g, 0.0)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping SA layer (pointnet2_modules.PointnetSAModuleMSG)."""

    GLOBAL_BATCH = True

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], in_channels: int):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        for s, mlp in enumerate(mlps):
            self.add_module(f"mlp_{s}", SharedMLP(in_channels + 3, mlp))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, feats, valid):
        """xyz (B, N, 3), feats (B, N, C) or None, valid (B, N) → new_xyz
        (B, S, 3), new_feats (B, S, ΣC'), new_valid (B, S)."""
        fps_idx = P.farthest_point_sample(xyz, valid, self.npoint)
        new_valid = torch.gather(valid, 1, fps_idx)
        new_xyz = P.group_points(xyz, fps_idx)
        outs = []
        for s, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx, has = P.ball_query(radius, nsample, xyz, valid, new_xyz, new_valid)
            grouped = P.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if feats is not None:
                grouped = torch.cat([grouped, P.group_points(feats, idx).to(grouped.dtype)], -1)
            m = (has & new_valid)[..., None]  # (B, S, 1)
            g = getattr(self, f"mlp_{s}")(grouped, m)
            outs.append(masked_max(g, m[..., None], dim=2))
        return new_xyz, torch.cat(outs, dim=-1), new_valid


class FeaturePropagation(nn.Module):
    """FP layer: 3-NN interpolation of the coarse features, the fine skip
    features after them, then a shared MLP (pointnet2_modules.PointnetFPModule)."""

    GLOBAL_BATCH = True

    def __init__(self, mlp: Sequence[int], in_channels: int):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_channels, mlp)

    def forward(self, xyz_fine, valid_fine, feats_fine, xyz_coarse, valid_coarse, feats_coarse):
        dist, idx = P.three_nn(xyz_fine, valid_fine, xyz_coarse, valid_coarse)
        x = P.three_interpolate(feats_coarse, idx, dist)
        if feats_fine is not None:
            x = torch.cat([x, feats_fine.to(x.dtype)], dim=-1)
        return self.SharedMLP_0(x, valid_fine)


class PointNet2MSG(nn.Module):
    """4 × SA-MSG + 4 × FP → per-point features (reference PointNet2MSG)."""

    GLOBAL_BATCH = True

    def __init__(self, npoints, radii, nsamples, mlps, fp_mlps, num_point_features: int = 4):
        super().__init__()
        self.num_levels = len(npoints)
        widths = [num_point_features - 3]
        for i in range(self.num_levels):
            sa = SetAbstractionMSG(npoints[i], radii[i], nsamples[i], mlps[i], widths[-1])
            self.add_module(f"sa_{i}", sa)
            widths.append(sa.out_channels)
        self.num_fp = len(fp_mlps)
        coarse = widths[self.num_fp]
        for i in range(self.num_fp - 1, -1, -1):
            self.add_module(f"fp_{i}", FeaturePropagation(fp_mlps[i], coarse + widths[i]))
            coarse = int(fp_mlps[i][-1])
        self.out_channels = coarse

    def forward(self, points, valid):
        """points (B, N, 3 + C), valid (B, N) → (B, N, fp_mlps[0][-1])."""
        xyz = points[..., :3].float()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        xyzs, feats_list, valids = [xyz], [feats], [valid]
        for i in range(self.num_levels):
            nx, nf, nv = getattr(self, f"sa_{i}")(xyzs[-1], feats_list[-1], valids[-1])
            xyzs.append(nx)
            feats_list.append(nf)
            valids.append(nv)
        for i in range(self.num_fp - 1, -1, -1):
            feats_list[i] = getattr(self, f"fp_{i}")(
                xyzs[i], valids[i], feats_list[i], xyzs[i + 1], valids[i + 1], feats_list[i + 1])
        return feats_list[0]
