"""VFEs: DynPillarVFE and DynVoxelVFE (port of dfu3d_tpu/models/vfe.py) and
MeanVFE (the voxel branch of dfu3d_tpu/models/detectors.py:265-280, no
parameters).

DynPillarVFE: points are sorted by their batch-offset BEV cell id; segment
ids are the ranks of the distinct cells, so the pillar reductions land in a
compact table, and only the final per-pillar feature is scattered into the
dense (B, ny, nx, C) grid. The pillar cap is global over the batch:
b·max_pillars slots in batch-major cell order, so on overflow the last
samples lose their pillars, as in the JAX package (vfe.py:154-163).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.voxel import (
    VoxelGrid,
    dynamic_voxelize,
    segment_broadcast,
    segment_max_fast,
    segment_sum_sorted,
)
from ..parallel import mesh
from .backbone_2d import update_running_stats_


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, counting only the rows that
    `mask` (x.shape[:-1]) marks. The math is fp32 and the result is cast back
    to the input's dtype. Eval uses the running statistics; training uses the
    JAX package's one-pass batch statistics (mean and E[x²] - mean², clamped
    at 0) and moves the running ones with keep 0.99. Over several ranks the
    statistics are those of the global batch: Σx·m, Σx²·m and the count
    summed over ranks in one all-reduce."""

    GLOBAL_BATCH = True

    def __init__(self, num_features: int, eps: float = 1e-3, keep: float = 0.99):
        super().__init__()
        self.eps = eps
        self.keep = keep
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def batch_stats(self, x, mask):
        m = mask.float()[..., None]
        dims = tuple(range(x.dim() - 1))
        xm = x.float() * m
        c = x.shape[-1]
        sums = mesh.global_sum(torch.cat([xm.sum(dims), (xm * x.float()).sum(dims),
                                          m.sum().reshape(1)]))
        count = torch.clamp(sums[-1], min=1.0)
        mean = sums[:c] / count
        return mean, torch.clamp(sums[c:2 * c] / count - mean * mean, min=0.0)

    def forward(self, x, mask):
        if self.training:
            mean, var = self.batch_stats(x, mask)
            update_running_stats_(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def global_row(table, last_slot, grad: bool = True):
    """Row `last_slot` = (held, index) of `table` from the rank that holds
    it (held), the same row on every rank: what a point past the global
    batch's pillar cap reads, the global batch's last slot. With `grad`
    False it passes no gradient (as segment_broadcast's sentinel reads)."""
    held, index = last_slot
    row = table[index] if grad else table[index].detach()
    return mesh.global_sum(torch.where(held, row.float(), 0.0)).to(table.dtype)


class PFNLayer(nn.Module):
    """Linear + BN + ReLU + segment-max (reference PFNLayerV2). Points of the
    sentinel segment (past the pillar cap) read the last slot's max, as JAX's
    clipped gather reads it; over several ranks `last_slot` names where the
    global batch's last slot lies (`global_row`)."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, out_channels: int, use_norm: bool = True,
                 last_layer: bool = False):
        super().__init__()
        self.use_norm = use_norm
        self.last_layer = last_layer
        out_ch = out_channels if last_layer else out_channels // 2
        self.Dense_0 = nn.Linear(in_channels, out_ch, bias=not use_norm)
        if use_norm:
            self.MaskedBatchNorm_0 = MaskedBatchNorm(out_ch)

    def forward(self, feats, point_mask, seg_ids, num_segments: int, last_slot=None):
        x = self.Dense_0(feats)
        if self.use_norm:
            x = self.MaskedBatchNorm_0(x, point_mask)
        x = F.relu(x)
        x = torch.where(point_mask[:, None], x, 0.0)
        x_max = segment_max_fast(x, seg_ids, num_segments)
        if self.last_layer:
            return x, x_max
        # the segment ids are sorted (the sentinel last)
        gathered = segment_broadcast(x_max, seg_ids, num_segments, True)
        if last_slot is not None:
            gathered = torch.where((seg_ids < num_segments)[:, None], gathered,
                                   global_row(x_max, last_slot, grad=False))
        gathered = torch.where(point_mask[:, None], gathered, 0.0)
        return torch.cat([x, gathered], dim=-1), None


class DynPillarVFE(nn.Module):
    """config keys: NUM_FILTERS, USE_NORM, USE_ABSLOTE_XYZ, WITH_DISTANCE."""

    GLOBAL_BATCH = True

    def __init__(self, num_filters: Sequence[int], grid: VoxelGrid, num_point_features: int = 4,
                 use_norm: bool = True, use_absolute_xyz: bool = True,
                 with_distance: bool = False, max_pillars: int = 32768):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.grid = grid
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        self.max_pillars = max_pillars
        cin = (num_point_features if use_absolute_xyz else num_point_features - 3) + 6
        cin += int(with_distance)
        for i, nf in enumerate(self.num_filters):
            last = i >= len(self.num_filters) - 1
            self.add_module(f"pfn_{i}", PFNLayer(cin, nf, use_norm, last))
            cin = nf

    def forward(self, points, points_valid):
        """points (B, N, C) xyz + extra features, points_valid (B, N) bool →
        (B, ny, nx, NUM_FILTERS[-1]) dense pillar grid."""
        b, n, c = points.shape
        g = self.grid
        nx, ny, _ = g.grid_size
        dev = points.device
        flat = points.reshape(b * n, c)
        flat_valid = points_valid.reshape(b * n)

        pcr = torch.tensor(g.point_cloud_range, dtype=torch.float32, device=dev)
        vs = torch.tensor(g.voxel_size, dtype=torch.float32, device=dev)
        coords = torch.floor((flat[:, 0:2].float() - pcr[0:2]) / vs[0:2]).long()
        limits = torch.tensor([nx, ny], device=dev)
        in_range = ((coords >= 0) & (coords < limits)).all(dim=-1)
        ok = flat_valid & in_range
        coords = torch.minimum(torch.clamp(coords, min=0), limits - 1)

        cells = ny * nx
        sentinel = b * cells
        batch_idx = torch.arange(b, device=dev).repeat_interleave(n)
        cell_id = torch.where(ok, batch_idx * cells + coords[:, 1] * nx + coords[:, 0], sentinel)

        order = torch.argsort(cell_id, stable=True)
        sorted_ids = cell_id[order]
        flat = flat[order]
        # coords and validity are functions of the sorted cell id
        ok = sorted_ids < sentinel
        cell_in_elem = torch.where(ok, sorted_ids % cells, 0)
        coords = torch.stack([cell_in_elem % nx, cell_in_elem // nx], dim=-1)
        is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              sorted_ids[1:] != sorted_ids[:-1]]) & ok
        seg = torch.cumsum(is_start.long(), dim=0) - 1
        # in training JAX caps the global batch; its eval runs each host's
        # batch on its own, so the cap is then this rank's batch's
        global_cap = self.training and mesh.world() > 1
        if not global_cap:
            pillar_cap = b * self.max_pillars
            seg = torch.where(ok & (seg < pillar_cap), seg, pillar_cap)
        else:
            # the cap is the global batch's, over its pillars in rank order
            total_cap = b * mesh.world() * self.max_pillars
            offset = mesh.rows_before(is_start.sum())
            pillar_cap = min(total_cap, b * n)
            seg = torch.where(ok & (seg < total_cap - offset), seg, pillar_cap)
        num_segments = pillar_cap
        # each pillar's dense cell (sentinel for overflow / unused slots);
        # all points of a pillar write the same value
        pillar_cell = torch.full((pillar_cap + 1,), sentinel, dtype=torch.long, device=dev)
        pillar_cell[seg] = torch.where(ok, sorted_ids, sentinel)
        pillar_cell = pillar_cell[:pillar_cap]

        xyz = flat[:, 0:3].float()
        ones = torch.where(ok, 1.0, 0.0)
        sums = segment_sum_sorted(torch.cat([xyz * ones[:, None], ones[:, None]], dim=-1),
                                  seg, num_segments)
        counts = torch.clamp(sums[:, 3:4], min=1.0)
        means = sums[:, 0:3] / counts
        last_slot = None
        if not global_cap:
            f_cluster = xyz - means[torch.clamp(seg, max=num_segments - 1)]
        else:
            # a point past the cap reads the global batch's last slot
            last = total_cap - 1 - offset
            last_slot = ((last >= 0) & (last < num_segments), torch.clamp(last, 0, num_segments - 1))
            f_cluster = xyz - torch.where((seg < num_segments)[:, None],
                                          means[torch.clamp(seg, max=num_segments - 1)],
                                          global_row(means, last_slot))

        # offset from the pillar centre
        cx = coords[:, 0].float() * vs[0] + (vs[0] / 2 + pcr[0])
        cy = coords[:, 1].float() * vs[1] + (vs[1] / 2 + pcr[1])
        cz = vs[2] / 2 + pcr[2]
        f_center = torch.stack([xyz[:, 0] - cx, xyz[:, 1] - cy, xyz[:, 2] - cz], dim=-1)

        if self.use_absolute_xyz:
            feats = [flat.float(), f_cluster, f_center]
        else:
            feats = [flat[:, 3:].float(), f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        feats = torch.where(ok[:, None], torch.cat(feats, dim=-1), 0.0)

        x_max = None
        for i in range(len(self.num_filters)):
            feats, x_max = getattr(self, f"pfn_{i}")(feats, ok, seg, num_segments, last_slot)

        # scatter pillar features into the dense BEV grid; the sentinel row
        # (overflow pillars and unused slots) is cut off
        cout = self.num_filters[-1]
        dense = x_max.new_zeros((sentinel + 1, cout))
        dense[pillar_cell] = x_max
        return dense[:sentinel].reshape(b, ny, nx, cout)


class DynVoxelVFE(nn.Module):
    """DynamicVoxelVFE (dynamic_voxel_vfe.py:15-106, the DSVT configs' VFE;
    JAX vfe.py:210-298): per point [its channels (or those after xyz),
    f_cluster (xyz minus its voxel's point mean), f_center (xyz minus its
    voxel's centre, z included)] (, its range), through the PFNLayer stack
    over batch-global voxel ids, so that BN sees every point of the batch,
    then the max over each voxel's points. Returns ((B, V, C) features,
    (B, V, 3) int32 coords (ix, iy, iz), (B, V) valid) in the voxelizer's
    slot order. config keys: NUM_FILTERS, USE_NORM, USE_ABSLOTE_XYZ,
    WITH_DISTANCE."""

    def __init__(self, num_filters: Sequence[int], grid: VoxelGrid, num_point_features: int = 4,
                 use_norm: bool = True, use_absolute_xyz: bool = True,
                 with_distance: bool = False, max_voxels: int = 60000):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.grid = grid
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        self.max_voxels = max_voxels
        cin = (num_point_features if use_absolute_xyz else num_point_features - 3) + 6
        cin += int(with_distance)
        for i, nf in enumerate(self.num_filters):
            self.add_module(f"pfn_{i}", PFNLayer(cin, nf, use_norm,
                                                 i >= len(self.num_filters) - 1))
            cin = nf

    def forward(self, points, points_valid):
        b, n, c = points.shape
        cap = self.max_voxels
        dev = points.device
        vox = dynamic_voxelize(self.grid, points, points_valid, cap)
        base = torch.arange(b, device=dev)[:, None] * cap
        seg = torch.where(vox.point_to_voxel < cap, vox.point_to_voxel + base,
                          b * cap).reshape(b * n)
        # points sorted by voxel (the PFN's segment ops take ascending ids,
        # the sentinel last); invalid points carry the sentinel
        order = torch.argsort(seg, stable=True)
        flat, seg = points.reshape(b * n, c)[order], seg[order]
        num_segments = b * cap
        ok = seg < num_segments

        pcr = torch.tensor(self.grid.point_cloud_range[:3], dtype=torch.float32, device=dev)
        vs = torch.tensor(self.grid.voxel_size, dtype=torch.float32, device=dev)
        xyz = flat[:, 0:3].float()
        ones = torch.where(ok, 1.0, 0.0)
        sums = segment_sum_sorted(torch.cat([xyz * ones[:, None], ones[:, None]], dim=-1),
                                  seg, num_segments)
        means = sums[:, 0:3] / torch.clamp(sums[:, 3:4], min=1.0)
        f_cluster = xyz - means[torch.clamp(seg, max=num_segments - 1)]
        coords = torch.floor((xyz - pcr) / vs)
        f_center = xyz - (coords * vs + (vs / 2 + pcr))
        feats = [flat.float() if self.use_absolute_xyz else flat[:, 3:].float(), f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.where(ok[:, None], torch.cat(feats, dim=-1), 0.0)
        x_max = None
        for i in range(len(self.num_filters)):
            x, x_max = getattr(self, f"pfn_{i}")(x, ok, seg, num_segments)
        voxel_feats = x_max.view(b, cap, -1)
        voxel_feats = torch.where(vox.voxel_valid[..., None], voxel_feats, 0.0)
        return voxel_feats, vox.voxel_coords, vox.voxel_valid


class MeanVFE(nn.Module):
    """Dynamic voxelization plus the per-voxel mean of its points' channels
    (B, N, C) → ((B, V, C) fp32 features, Voxelized). The points are summed
    in voxel order as sorted segments, with no atomics, so a run on the card
    repeats bit for bit."""

    GLOBAL_BATCH = True

    def __init__(self, grid: VoxelGrid, max_voxels: int):
        super().__init__()
        self.grid = grid
        self.max_voxels = max_voxels

    def forward(self, points, points_valid):
        b, n, c = points.shape
        v = self.max_voxels
        vox = dynamic_voxelize(self.grid, points, points_valid, v)
        base = torch.arange(b, device=points.device)[:, None] * v
        ids = torch.where(vox.point_to_voxel < v, vox.point_to_voxel + base, b * v).reshape(-1)
        order = torch.argsort(ids, stable=True)
        live = points_valid.reshape(-1, 1).float()
        values = torch.cat([points.reshape(b * n, c).float() * live, live], dim=-1)
        sums = segment_sum_sorted(values[order], ids[order], b * v)
        feats = sums[:, :c] / torch.clamp(sums[:, c:], min=1.0)
        return feats.view(b, v, c), vox
