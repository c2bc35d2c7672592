"""Sparse-voxel coordinate ops: neighbour tables and strided downsampling.

Port of dfu3d_tpu/core/voxel/sparse_ops.py (`SparseGrid`, `linearize`,
`column_major_index`, `kernel_offsets`, `build_lookup`, `find_neighbors`,
`transpose_down_neighbors`, `downsample_coords`, `ingroup_inds`), batched
over a leading B.
Active voxels live in fixed-capacity buffers, coords (B, V, 3) + valid (B, V). A neighbour table
(B, Q, K) int32 holds, for each query and kernel tap, the slot of the voxel
at query + offset in its own sample, or the sentinel V.

Neighbour search is one sort of the batch-offset linear ids plus one
`torch.searchsorted` over the whole batch. The JAX package's production path
looks neighbours up in columnar maps instead; its tests hold those tables
equal to this element lookup, exactly (tests/test_sparse_vjp.py
TestColumnarMap), because slots are in column-major order at every stage.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .voxelize import compact_cells, gather_slots


class SparseGrid(NamedTuple):
    """Spatial extent of a sparse tensor (nx, ny, nz)."""

    nx: int
    ny: int
    nz: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def down(self) -> "SparseGrid":
        return SparseGrid(-(-self.nx // 2), -(-self.ny // 2), -(-self.nz // 2))

    def down_z(self) -> "SparseGrid":
        return SparseGrid(self.nx, self.ny, -(-self.nz // 2))


def _in_grid(grid: SparseGrid, c):
    return ((c[..., 0] >= 0) & (c[..., 0] < grid.nx) & (c[..., 1] >= 0) & (c[..., 1] < grid.ny)
            & (c[..., 2] >= 0) & (c[..., 2] < grid.nz))


def linearize(grid: SparseGrid, coords, valid):
    """(..., 3) coords → int64 ids (iz · ny + iy) · nx + ix; invalid or
    outside the grid → num_cells."""
    c = coords.long()
    lin = (c[..., 2] * grid.ny + c[..., 1]) * grid.nx + c[..., 0]
    return torch.where(valid & _in_grid(grid, c), lin, grid.num_cells)


def column_major_index(grid: SparseGrid, coords, valid):
    """(..., 3) coords → int64 column-major ids (iy · nx + ix) · nz + iz;
    invalid or outside the grid → num_cells."""
    c = coords.long()
    lin = (c[..., 1] * grid.nx + c[..., 0]) * grid.nz + c[..., 2]
    return torch.where(valid & _in_grid(grid, c), lin, grid.num_cells)


def kernel_offsets(kx: int, ky: int, kz: int) -> np.ndarray:
    """Centred kernel offsets (K, 3) int32, x slowest and z fastest."""
    ox = np.arange(kx) - kx // 2
    oy = np.arange(ky) - ky // 2
    oz = np.arange(kz) - kz // 2
    grid = np.stack(np.meshgrid(ox, oy, oz, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def build_lookup(grid: SparseGrid, coords, valid):
    """Sorted batch-offset ids of a coordinate set (B, V, 3): returns
    (sorted_keys (B·V,) int64, order (B·V,) int64 flat slot b·V + s). Sample
    b's ids lie in [b·(num_cells + 1), (b + 1)·(num_cells + 1))."""
    b = coords.shape[0]
    base = torch.arange(b, device=coords.device, dtype=torch.int64)[:, None] * (grid.num_cells + 1)
    keys = (linearize(grid, coords, valid) + base).reshape(-1)
    order = torch.argsort(keys, stable=True)
    return keys[order], order


def _search(grid: SparseGrid, cells, ok, sorted_keys, order):
    """Slots of cells (B, P, K, 3) int64 where `ok`, in the searched set of
    `build_lookup`; absent, not ok or outside the grid → V. (B, P, K) int32."""
    b = cells.shape[0]
    v = order.numel() // b
    ok = ok & _in_grid(grid, cells)
    qlin = torch.where(ok, (cells[..., 2] * grid.ny + cells[..., 1]) * grid.nx + cells[..., 0],
                       grid.num_cells)
    base = torch.arange(b, device=cells.device, dtype=torch.int64)[:, None, None]
    qkey = qlin + base * (grid.num_cells + 1)
    pos = torch.clamp(torch.searchsorted(sorted_keys, qkey.reshape(-1)), max=b * v - 1)
    pos = pos.view(qkey.shape)
    found = (sorted_keys[pos] == qkey) & (qlin < grid.num_cells)
    return torch.where(found, order[pos] - base * v, v).to(torch.int32)


def _offsets(offsets, device):
    return torch.as_tensor(np.asarray(offsets), dtype=torch.int64, device=device)


def find_neighbors(grid: SparseGrid, query_coords, query_valid, sorted_keys, order, offsets):
    """For each query (B, Q, 3) and each offset (K, 3), the slot of the voxel
    at query + offset in the searched set of `build_lookup`, else V:
    (B, Q, K) int32."""
    c = query_coords.long()[:, :, None, :] + _offsets(offsets, query_coords.device)
    return _search(grid, c, query_valid[:, :, None], sorted_keys, order)


def transpose_down_neighbors(down_grid: SparseGrid, in_coords, in_valid, out_sorted_keys,
                             out_order, offsets, z_only: bool = False):
    """Transpose table of a stride-2 sparse conv (dfu3d_tpu
    sparse_ops.transpose_down_neighbors): tnbr[b, p, k] is the output slot q
    whose tap k reads input p, i.e. center(q) + offsets[k] == in_coords[p],
    with center(q) = 2 · out_coord (or (x, y, 2 · z) when z_only); sentinel
    Q where the implied centre has odd parity, lies outside the grid or is
    not an active output. The output set is searched through its
    `build_lookup` (out_sorted_keys, out_order). (B, V, K) int32."""
    t = in_coords.long()[:, :, None, :] - _offsets(offsets, in_coords.device)  # implied centres
    if z_only:
        parity_ok = t[..., 2] % 2 == 0
        cells = torch.stack([t[..., 0], t[..., 1], torch.div(t[..., 2], 2, rounding_mode="floor")],
                            dim=-1)
    else:
        parity_ok = (t % 2 == 0).all(dim=-1)
        cells = torch.div(t, 2, rounding_mode="floor")
    return _search(down_grid, cells, in_valid[:, :, None] & parity_ok, out_sorted_keys, out_order)


def downsample_coords(down_grid: SparseGrid, coords, valid, out_cap: int, z_only: bool = False):
    """Active output set of a stride-2 sparse conv: the distinct parent cells
    (coords // 2, or z // 2 only) of the active inputs, per sample, in
    column-major slot order, capped at `out_cap`.

    Returns (out_coords (B, out_cap, 3) int32 with 0 in empty slots,
    out_valid (B, out_cap), slot_of_input (B, V) int64 with sentinel out_cap,
    num_unique (B,) the distinct parents before the cap)."""
    c = coords.long()
    if z_only:
        parent = torch.stack([c[..., 0], c[..., 1], torch.div(c[..., 2], 2, rounding_mode="floor")],
                             dim=-1)
    else:
        parent = torch.div(c, 2, rounding_mode="floor")
    slot, source, num_unique = compact_cells(column_major_index(down_grid, parent, valid),
                                             down_grid.num_cells, out_cap)
    num_out = torch.clamp(num_unique, max=out_cap)
    out_valid = torch.arange(out_cap, device=coords.device) < num_out[:, None]
    return gather_slots(parent.to(torch.int32), source, 0), out_valid, slot, num_unique


def ranks_in_sorted_groups(sorted_keys):
    """(N,) ascending group keys → (N,) int64 position of each element within
    its run of equal keys (0, 1, ... from the run's first element): the
    positions minus a running max of the run starts."""
    n = sorted_keys.shape[0]
    pos = torch.arange(n, device=sorted_keys.device)
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return pos - torch.cummax(torch.where(is_start, pos, 0), dim=0).values


def ingroup_inds(group_ids, valid=None):
    """Index of each element within its group, stable by original order
    (the ingroup_inds op of DSVT's set partition; JAX sparse_ops.py:706-734):
    one stable sort, the invalid elements last, then
    `ranks_in_sorted_groups`. group_ids (N,) int, valid (N,) bool or None →
    (N,) int64, -1 at the invalid elements."""
    keys = group_ids.long()
    if valid is not None:
        keys = torch.where(valid, keys, torch.iinfo(torch.int64).max)
    order = torch.argsort(keys, stable=True)
    out = torch.empty_like(keys)
    out[order] = ranks_in_sorted_groups(keys[order])
    if valid is not None:
        out = torch.where(valid, out, -1)
    return out
