"""Voxel grid, segment reductions (two with the JAX package's custom
backwards) and dynamic voxelization, the scatter substrate of the VFEs.
Port of dfu3d_tpu/core/voxel/voxelize.py.

Segment ids outside [0, num_segments) are dropped, as `jax.ops.segment_*`
drops them: every reduction writes into num_segments + 1 rows and the last
(sentinel) row is cut off.

Voxelization is batched: one stable sort over the batch-offset cell ids of
all samples at once (`compact_cells`), where the JAX package vmaps a
per-sample sort. Ids are int64 inside: B · num_cells is 168M for B=4 on the
nuScenes 0.1 m grid.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class VoxelGrid(NamedTuple):
    """Static voxel grid: grid_size = round((range[3:6] - range[0:3]) / voxel_size)
    as (nx, ny, nz)."""

    point_cloud_range: Tuple[float, float, float, float, float, float]
    voxel_size: Tuple[float, float, float]
    grid_size: Tuple[int, int, int]

    @classmethod
    def create(cls, point_cloud_range: Sequence[float], voxel_size: Sequence[float]):
        pcr = tuple(float(v) for v in point_cloud_range)
        vs = tuple(float(v) for v in voxel_size)
        gs = tuple(int(round((pcr[3 + i] - pcr[i]) / vs[i])) for i in range(3))
        return cls(pcr, vs, gs)

    @property
    def num_cells(self) -> int:
        return self.grid_size[0] * self.grid_size[1] * self.grid_size[2]


def _safe_ids(segment_ids, num_segments: int):
    """Ids outside [0, num_segments) → the sentinel row num_segments."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(ok, segment_ids, num_segments)


def _row_index(ids, values):
    return ids.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)


def segment_sum(values, segment_ids, num_segments: int):
    """(N, ...) values summed into (num_segments, ...)."""
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    out.index_add_(0, _safe_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def segment_sum_sorted(values, segment_ids, num_segments: int):
    """segment_sum for ascending ids, the sentinel num_segments last (as
    `jax.ops.segment_sum(..., indices_are_sorted=True)`). Each segment is
    summed in order over its offsets by `torch.segment_reduce`, with no
    atomics, so a run on the card repeats bit for bit; `index_add_` does not,
    and neither does a device-wide prefix scan."""
    offsets = torch.searchsorted(
        segment_ids.contiguous(),
        torch.arange(num_segments + 1, device=values.device, dtype=segment_ids.dtype))
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0)


def segment_mean(values, segment_ids, num_segments: int):
    """Segment mean; empty segments → 0. Returns (means, counts)."""
    totals = segment_sum(values, segment_ids, num_segments)
    counts = segment_sum(values.new_ones(values.shape[:1]), segment_ids, num_segments)
    return totals / torch.clamp(counts, min=1.0)[(...,) + (None,) * (values.dim() - 1)], counts


def segment_max(values, segment_ids, num_segments: int, empty_value: float = 0.0):
    """Segment max; empty segments → empty_value (for any sign of the values)."""
    ids = _safe_ids(segment_ids, num_segments)
    out = values.new_full((num_segments + 1,) + values.shape[1:], float("-inf"))
    out.scatter_reduce_(0, _row_index(ids, values), values, "amax", include_self=True)
    out = out[:num_segments]
    return torch.where(torch.isfinite(out), out, empty_value)


class _SegmentMaxFast(torch.autograd.Function):
    """The JAX custom VJP of segment_max_fast (voxelize.py:129-162): a
    gather-only backward, dx[i] = (x[i] == y[seg[i]]) · dy[seg[i]], so every
    tied winner gets the full gradient (scatter_reduce's own backward would
    split it among them) and out-of-range ids get 0."""

    @staticmethod
    def forward(ctx, values, segment_ids, num_segments):
        out = segment_max(values, segment_ids, num_segments, 0.0)
        ctx.save_for_backward(values, segment_ids, out)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        values, segment_ids, out = ctx.saved_tensors
        n = ctx.num_segments
        safe = torch.clamp(segment_ids, 0, n - 1)
        in_range = ((segment_ids >= 0) & (segment_ids < n))[:, None]
        winners = (values == out.index_select(0, safe)) & in_range
        dx = torch.where(winners, g.index_select(0, safe), 0).to(values.dtype)
        return dx, None, None


class _SegmentBroadcast(torch.autograd.Function):
    """Row gather with the JAX custom VJP (voxelize.py:165-189): the backward
    is a segment sum over the same ids, out-of-range ids dropped; in order
    over sorted segments (`segment_sum_sorted`, no atomics) when the ids are
    ascending with the sentinel last."""

    @staticmethod
    def forward(ctx, table, segment_ids, num_segments, indices_are_sorted):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        ctx.indices_are_sorted = indices_are_sorted
        return table.index_select(0, torch.clamp(segment_ids, max=num_segments - 1))

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        reduce = segment_sum_sorted if ctx.indices_are_sorted else segment_sum
        return reduce(g, segment_ids, ctx.num_segments), None, None, None


def segment_max_fast(values, segment_ids, num_segments: int):
    """segment_max with empty segments → 0 and a gather-only backward in
    which every tied winner gets the full gradient (the JAX package's
    documented choice)."""
    return _SegmentMaxFast.apply(values, segment_ids, num_segments)


def segment_broadcast(table, segment_ids, num_segments: int, indices_are_sorted: bool = False):
    """Row gather table[seg[i]]; out-of-range ids read row num_segments - 1
    (callers mask those rows) and get no gradient. The backward is a segment
    sum; pass indices_are_sorted when the ids ascend with the sentinel last."""
    return _SegmentBroadcast.apply(table, segment_ids, num_segments, indices_are_sorted)


# ---------------------------------------------------------------------------
# Dynamic voxelization (dfu3d_tpu/core/voxel/voxelize.py:59-104, :212-262)
# ---------------------------------------------------------------------------

def voxel_coords_of_points(grid: VoxelGrid, points, valid=None):
    """(..., N, 3+) xyz-first points → (coords (..., N, 3) int32 (ix, iy, iz)
    clipped into the grid, ok (..., N) bool: live and inside the grid)."""
    pcr = torch.tensor(grid.point_cloud_range[:3], dtype=points.dtype, device=points.device)
    vs = torch.tensor(grid.voxel_size, dtype=points.dtype, device=points.device)
    coords = torch.floor((points[..., 0:3] - pcr) / vs).to(torch.int32)
    gs = torch.tensor(grid.grid_size, dtype=torch.int32, device=points.device)
    ok = ((coords >= 0) & (coords < gs)).all(dim=-1)
    if valid is not None:
        ok = ok & valid
    return torch.minimum(torch.clamp(coords, min=0), gs - 1), ok


def linear_index_3d(grid: VoxelGrid, coords, ok):
    """Column-major cell id ((iy · nx + ix) · nz + iz, z fastest) as int64;
    entries that are not ok → num_cells. The voxel slot sort key."""
    nx, _, nz = grid.grid_size
    c = coords.long()
    idx = (c[..., 1] * nx + c[..., 0]) * nz + c[..., 2]
    return torch.where(ok, idx, grid.num_cells)


def compact_cells(keys, num_cells: int, cap: int):
    """The distinct valid keys of each sample ((B, N) int64, invalid =
    num_cells) take slots 0, 1, ... in ascending key order; keys past the
    first `cap` are dropped. One stable argsort over the whole batch.

    Returns (slot (B, N) int64 in [0, cap], cap for dropped or invalid
    entries; source (B, cap) int64, the flat index b·N + i of the first
    entry of each kept slot, -1 for empty slots; num_unique (B,) the distinct
    valid keys before the cap)."""
    b, n = keys.shape
    dev = keys.device
    total = b * num_cells
    batch = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
    flat = torch.where(keys < num_cells, keys + batch * num_cells, total).reshape(-1)
    order = torch.argsort(flat, stable=True)
    skey = flat[order]
    ok = skey < total
    first = torch.ones_like(ok)
    first[1:] = skey[1:] != skey[:-1]
    first &= ok
    # starts before each sample's first entry, from the sorted keys (no atomics)
    bounds = torch.searchsorted(skey, torch.arange(b + 1, device=dev, dtype=torch.int64)
                                * num_cells)
    starts = torch.cat([first.new_zeros(1, dtype=torch.int64), torch.cumsum(first.long(), 0)])
    before = starts[bounds]
    sample = torch.clamp(skey // num_cells, max=b - 1)
    seg = starts[1:] - 1 - before[sample]
    seg = torch.where(ok & (seg < cap), seg, cap)
    slot = torch.empty_like(seg)
    slot[order] = seg
    source = torch.full((b * cap + 1,), -1, dtype=torch.int64, device=dev)
    source[torch.where(first & (seg < cap), sample * cap + seg, b * cap)] = order
    return slot.view(b, n), source[:b * cap].view(b, cap), before[1:] - before[:-1]


def gather_slots(values, source, fill: int):
    """(B, N, C) per-entry values → (B, cap, C) at `source` (of
    `compact_cells`); empty slots get `fill`."""
    rows = values.reshape(-1, values.shape[-1])[torch.clamp(source, min=0)]
    return torch.where(source[..., None] >= 0, rows, fill)


class Voxelized(NamedTuple):
    """Compacted voxelization, batched and fixed-size."""

    voxel_coords: torch.Tensor    # (B, V, 3) int32 (ix, iy, iz); invalid slots = -1
    voxel_valid: torch.Tensor     # (B, V) bool
    point_to_voxel: torch.Tensor  # (B, N) int64 slot in [0, V); invalid points → V
    num_voxels: torch.Tensor      # (B,) int64, capped at max_voxels
    num_unique: torch.Tensor      # (B,) int64 distinct occupied cells before the cap


def dynamic_voxelize(grid: VoxelGrid, points, valid, max_voxels: int) -> Voxelized:
    """Sort-based voxel compaction of (B, N, 3+) points. Slots are in
    column-major, z-fastest cell order per sample; past `max_voxels` the
    cells last in that order are dropped (their points map to V)."""
    coords, ok = voxel_coords_of_points(grid, points, valid)
    slot, source, num_unique = compact_cells(linear_index_3d(grid, coords, ok),
                                             grid.num_cells, max_voxels)
    num_voxels = torch.clamp(num_unique, max=max_voxels)
    voxel_valid = torch.arange(max_voxels, device=points.device) < num_voxels[:, None]
    return Voxelized(gather_slots(coords, source, -1), voxel_valid, slot, num_voxels,
                     num_unique)
