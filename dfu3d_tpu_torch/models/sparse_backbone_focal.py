"""Focal sparse convolutions and VoxelBackBone8xFocal (port of
dfu3d_tpu/models/sparse_backbone_focal.py; reference pcdet
backbones_3d/spconv_backbone_focal.py and focal_sparse_conv/).

A focal layer predicts per active voxel K³ importance scores with a
submanifold conv (`conv_imp`, kernel B2, Cout K³: K³ - 1 kernel-offset
scores and the centre score last), splits the voxels into foreground and
background by the centre score (the top THRESHOLD share per sample, ranked
by a stable sort, or the score above THRESHOLD), dilates each foreground
voxel to the in-grid offsets whose score clears THRESHOLD and whose cell is
not active, keeps one candidate per cell, keeps the `dilate_cap` best of
those, and runs the main submanifold conv (B2), BN and ReLU over the set
grown by them (new voxels enter with zero features). Training adds the
binary focal loss of the centre score against "the voxel centre lies in a
gt box".

Where the JAX package writes a cell's candidates into a dense map with one
scatter, which keeps whichever duplicate writer the backend applies last,
the port picks the winner by rule, the one XLA:CPU shows: of the
candidates of a cell, the last in the descending stable order of their
scores, that is the lowest score and, among equal lowest scores, the
highest flat index. The winners' scores then decide which cells
`top_k(dilate_cap)` keeps when the cap binds, and their slot order. The
port looks the occupied cells up in the sorted keys of the active set
(`sparse_ops.build_lookup`), which gives what the JAX package's dense cell
map gives.

Like the JAX package, a focal layer's gt test places the voxel centres at
voxel_size · stride · stride (the stride enters twice); the reference's
is voxel_size · stride.

Every set after a focal layer is a new coordinate set: the tables of each
stage are built as the forward reaches it (`forward`), not planned ahead.
Module names follow the flax tree (conv_input, conv1, focal1.conv_imp,
focal1.conv, focal1.bn, down2, down2_bn, conv2a, ..., conv_out,
conv_out_bn).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry.boxes import points_in_boxes
from ..core.voxel.sparse_ops import (
    SparseGrid,
    _search,
    build_lookup,
    find_neighbors,
    kernel_offsets,
)
from .sparse_backbone import (
    SparseBatchNorm,
    SparseConv3dDown,
    SparseConvBlock,
    SparseTensor,
    SubMConv3d,
)

OFFSETS_3 = kernel_offsets(3, 3, 3)


def binary_focal_loss(p, target, valid, gamma: float = 2.0, eps: float = 1e-7):
    """The reference FocalLoss on the two-class stack [1 - p, p]: -y ·
    log(q) · (1 - q)^γ summed over both classes, averaged over the valid
    voxels and the two class slots."""
    p = torch.clamp(p, eps, 1.0 - eps)
    t = target.float()
    per_voxel = -t * torch.log(p) * (1.0 - p) ** gamma - (1.0 - t) * torch.log(1.0 - p) * p ** gamma
    m = valid.float()
    return (per_voxel * m).sum() / torch.clamp(m.sum() * 2.0, min=1.0)


def dilation_winners(flat_lin, flat_score, num_cells: int):
    """(B, NK) bool: per sample and cell of `flat_lin` (num_cells: no cell),
    the one candidate that wins it. The candidates of a cell are ordered by
    descending score, ties by ascending index (the JAX package's stable
    argsort), and the last of them wins, as XLA:CPU's scatter keeps the last
    of duplicate writers: the lowest score, and of equal lowest scores the
    highest index. Three stable sorts over the flattened batch."""
    b, nk = flat_lin.shape
    e = torch.arange(b * nk - 1, -1, -1, device=flat_lin.device)      # index descending
    e = e[torch.argsort(flat_score.reshape(-1)[e], stable=True)]      # score ascending
    key = (e // nk) * (num_cells + 1) + flat_lin.reshape(-1)[e]
    order = torch.argsort(key, stable=True)                           # by sample and cell
    e, key = e[order], key[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    won = torch.zeros(b * nk, dtype=torch.bool, device=flat_lin.device)
    won[e[first]] = True
    return won.view(b, nk)


class FocalSparseConv(nn.Module):
    """One focal layer on a sparse tensor of `in_channels` (plus
    `extra_channels` of image features for the importance conv)."""

    def __init__(self, in_channels: int, channels: int, voxel_stride: int,
                 point_cloud_range: Sequence[float], voxel_size: Sequence[float], dilate_cap: int,
                 kernel_size: int = 3, topk: bool = True, threshold: float = 0.5,
                 mask_multi: bool = False, extra_channels: int = 0):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.dilate_cap = k, dilate_cap
        self.voxel_stride, self.topk, self.threshold = voxel_stride, topk, threshold
        self.mask_multi = mask_multi
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.conv_imp = SubMConv3d(in_channels + extra_channels, k ** 3, (k, k, k))
        self.conv = SubMConv3d(in_channels, channels, (k, k, k))
        self.bn = SparseBatchNorm(channels)
        off = kernel_offsets(k, k, k)
        self.offsets = off
        self.register_buffer("noncenter", torch.from_numpy(
            np.array([o for o in off if not np.all(o == 0)], np.int64)), persistent=False)

    def table(self, st: SparseTensor, lookup, nbr3=None):
        """The K³ table of `st`'s set (the 3³ one passed in, if K is 3)."""
        if self.kernel_size == 3 and nbr3 is not None:
            return nbr3
        return find_neighbors(st.grid, st.coords, st.valid, *lookup, self.offsets)

    def importance(self, st: SparseTensor, nbr, extra_feats=None):
        """(mask_voxel (B, V), mask_kernel (B, V, K³ - 1)) fp32 sigmoids."""
        imp_in = st
        if extra_feats is not None:
            imp_in = st._replace(features=torch.cat(
                [st.features, extra_feats.to(st.features.dtype)], dim=-1))
        imps = self.conv_imp(imp_in, nbr).features.float()
        return torch.sigmoid(imps[..., -1]), torch.sigmoid(imps[..., :-1])

    def focal_loss(self, st: SparseTensor, mask_voxel, gt_boxes, gt_valid):
        dev = st.coords.device
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev) * self.voxel_stride
        lo = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=dev)
        centers = (st.coords.float() + 0.5) * vs + lo
        target = (points_in_boxes(centers, gt_boxes[..., :7].float())
                  & gt_valid[:, None, :]).any(dim=-1)
        return binary_focal_loss(mask_voxel, target, st.valid)

    def foreground(self, st: SparseTensor, mask_voxel):
        if not self.topk:
            return st.valid & (mask_voxel > self.threshold)
        b, v = st.valid.shape
        neg = torch.where(st.valid, -mask_voxel, torch.inf)
        order = torch.argsort(neg, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(v, device=order.device).expand(b, v).contiguous())
        n_fore = (st.valid.sum(1, keepdim=True).float() * self.threshold).long()
        return st.valid & (rank < n_fore)

    def dilate(self, st: SparseTensor, lookup, fore, mask_kernel):
        """(coords (B, dilate_cap, 3) int32, valid (B, dilate_cap)) of the
        voxels the layer adds."""
        g = st.grid
        b, v = st.valid.shape
        cand = st.coords.long()[:, :, None, :] + self.noncenter           # (B, V, K³-1, 3)
        in_grid = ((cand[..., 0] >= 0) & (cand[..., 0] < g.nx) & (cand[..., 1] >= 0)
                   & (cand[..., 1] < g.ny) & (cand[..., 2] >= 0) & (cand[..., 2] < g.nz))
        cand_ok = fore[:, :, None] & (mask_kernel >= self.threshold) & in_grid
        occupied = _search(g, cand, cand_ok, *lookup) < v
        cand_ok = cand_ok & ~occupied
        lin = (cand[..., 2] * g.ny + cand[..., 1]) * g.nx + cand[..., 0]
        nk = v * cand.shape[2]
        flat_lin = torch.where(cand_ok, lin, g.num_cells).reshape(b, nk)
        flat_score = torch.where(cand_ok, mask_kernel, -1.0).reshape(b, nk)
        won = dilation_winners(flat_lin, flat_score, g.num_cells) & (flat_score > 0.0)
        sel = torch.where(won, flat_score, -1.0)
        top_score, top_idx = torch.sort(sel, dim=1, descending=True, stable=True)
        top_score, top_idx = top_score[:, :self.dilate_cap], top_idx[:, :self.dilate_cap]
        new_valid = top_score > 0.0
        coords = torch.gather(cand.reshape(b, nk, 3), 1, top_idx[..., None].expand(-1, -1, 3))
        return torch.where(new_valid[..., None], coords, 0).to(torch.int32), new_valid

    def forward(self, st: SparseTensor, lookup, nbr3=None, gt_boxes=None, gt_valid=None,
                extra_feats=None):
        """(the sparse tensor over the grown set, its lookup and 3³ table,
        the focal loss: 0 unless training with gt). `lookup` is
        `build_lookup` of st's set, `nbr3` its 3³ table."""
        nbr = self.table(st, lookup, nbr3)
        mask_voxel, mask_kernel = self.importance(st, nbr, extra_feats)
        loss = torch.zeros((), device=st.features.device)
        if self.training and gt_boxes is not None:
            loss = self.focal_loss(st, mask_voxel, gt_boxes, gt_valid)
        with torch.no_grad():
            fore = self.foreground(st, mask_voxel)
            new_coords, new_valid = self.dilate(st, lookup, fore, mask_kernel)
        feats = st.features
        if self.mask_multi:
            feats = feats * mask_voxel[..., None].to(feats.dtype)
        b, _, cin = feats.shape
        out = SparseTensor(torch.cat([feats, feats.new_zeros(b, self.dilate_cap, cin)], dim=1),
                           torch.cat([st.coords, new_coords], dim=1),
                           torch.cat([st.valid, new_valid], dim=1), st.grid)
        out_lookup = build_lookup(out.grid, out.coords, out.valid)
        out_nbr3 = find_neighbors(out.grid, out.coords, out.valid, *out_lookup, OFFSETS_3)
        out = self.conv(out, self.table(out, out_lookup, out_nbr3))
        x = F.relu(self.bn(out.features, out.valid))
        return (out._replace(features=torch.where(out.valid[..., None], x, 0)), out_lookup,
                out_nbr3, loss)


class VoxelBackBone8xFocal(nn.Module):
    """VoxelBackBone8x (16 → 16 → 32 → 64 → 64, conv_out to 128) with a focal
    layer closing strides 1, 2 and 4 (focal1-3; focal1's importance conv also
    reads `image_channels` of per-voxel image features with USE_IMG). Each
    focal layer adds `dilate_frac` of its input capacity (at least 16)
    slots. `forward` returns the conv_out tensor, the stages [s1, s2, s4,
    s8] at strides 1, 2, 4, 8 (the RoI head's sources) and the summed focal
    loss."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 point_cloud_range: Sequence[float], voxel_size: Sequence[float],
                 channels: Sequence[int] = (16, 16, 32, 64, 64), out_channels: int = 128,
                 topk: bool = True, threshold: float = 0.5, kernel_size: int = 3,
                 mask_multi: bool = False, dilate_frac: float = 0.25, image_channels: int = 0):
        super().__init__()
        self.grid, self.voxel_cap = grid, voxel_cap
        ch = tuple(channels)
        caps = [max(voxel_cap // d, 16) for d in (2, 4, 8)]
        self.conv_input = SparseConvBlock(in_channels, ch[0])
        self.conv1 = SparseConvBlock(ch[0], ch[1])
        v = voxel_cap
        self.set_caps = []
        for s, stride in ((1, 1), (2, 2), (3, 4)):
            if s > 1:
                self.add_module(f"down{s}", SparseConv3dDown(ch[s - 1], ch[s], caps[s - 2]))
                self.add_module(f"down{s}_bn", SparseBatchNorm(ch[s]))
                self.add_module(f"conv{s}a", SparseConvBlock(ch[s], ch[s]))
                self.add_module(f"conv{s}b", SparseConvBlock(ch[s], ch[s]))
                v = caps[s - 2]
            cap = max(int(v * dilate_frac), 16)
            self.add_module(f"focal{s}", FocalSparseConv(
                ch[s], ch[s], stride, point_cloud_range,
                tuple(np.asarray(voxel_size) * stride), cap, kernel_size, topk, threshold,
                mask_multi, image_channels if s == 1 else 0))
            self.set_caps.append(v + cap)
        self.down4 = SparseConv3dDown(ch[3], ch[4], caps[2])
        self.down4_bn = SparseBatchNorm(ch[4])
        self.conv4a = SparseConvBlock(ch[4], ch[4])
        self.conv4b = SparseConvBlock(ch[4], ch[4])
        self.conv_out = SparseConv3dDown(ch[4], out_channels, caps[2], z_only=True)
        self.conv_out_bn = SparseBatchNorm(out_channels)

    @property
    def out_grid(self) -> SparseGrid:
        return self.grid.down().down().down().down_z()

    def down(self, name: str, st: SparseTensor, lookup):
        """The strided conv `name` (planned on the current set; its transpose
        table in training), BN, ReLU: (tensor, its lookup, its 3³ table or
        None for conv_out)."""
        conv = getattr(self, name)
        level = conv.plan(st.grid, st.coords, st.valid, lookup)
        out_lookup = build_lookup(level.grid, level.coords, level.valid)
        if self.training:
            level = level._replace(down_tnbr=conv.transpose_table(st.coords, st.valid, level,
                                                                  out_lookup))
        out = conv(st, level)
        x = F.relu(getattr(self, f"{name}_bn")(out.features, out.valid))
        out = out._replace(features=torch.where(out.valid[..., None], x, 0))
        nbr = None if conv.z_only else find_neighbors(level.grid, level.coords, level.valid,
                                                     *out_lookup, OFFSETS_3)
        return out, out_lookup, nbr

    def forward(self, features, coords, valid, gt_boxes=None, gt_valid=None, image_feats=None):
        st = SparseTensor(features, coords, valid, self.grid)
        lookup = build_lookup(self.grid, coords, valid)
        nbr = find_neighbors(self.grid, coords, valid, *lookup, OFFSETS_3)
        st = self.conv1(self.conv_input(st, nbr), nbr)
        stages, loss = [], torch.zeros((), device=features.device)
        for s in (1, 2, 3):
            if s > 1:
                st, lookup, nbr = self.down(f"down{s}", st, lookup)
                st = getattr(self, f"conv{s}b")(getattr(self, f"conv{s}a")(st, nbr), nbr)
            st, lookup, nbr, ls = getattr(self, f"focal{s}")(
                st, lookup, nbr, gt_boxes, gt_valid, image_feats if s == 1 else None)
            loss = loss + ls
            stages.append(st)
        st, lookup, nbr = self.down("down4", st, lookup)
        st = self.conv4b(self.conv4a(st, nbr), nbr)
        stages.append(st)
        out, _, _ = self.down("conv_out", st, lookup)
        return out, stages, loss
