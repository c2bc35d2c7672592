"""bev_pool: LSS frustum-to-BEV pooling (port of dfu3d_tpu/core/voxel/
bev_pool.py; reference pcdet/ops/bev_pool).

The sum of each frustum point's features into its BEV cell, in either of the
JAX package's two forms: the dense segment sum over every cell (`max_cells`
0 or not below the cell count), or the compacted one, which sorts the points
by cell, sums them into a table of `max_cells` rows (the pooled cells in
ascending cell order; points of later cells are dropped, the truncation the
JAX tests document) and scatters that table into the grid. Both are an
`index_add_` of fp32 rows; on the card the atomic adds sum in no set order.
"""
from __future__ import annotations

import torch


def cell_index(coords, valid, b: int, nz: int, ny: int, nx: int):
    """(P,) int64 linear cell ((b · nz + z) · ny + y) · nx + x of each point's
    [b, z, y, x] coords (P, 4), or b · nz · ny · nx (the drop row) where the
    point is not valid or lies outside the grid."""
    c = coords.long()
    lin = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    ok = (valid & (c[:, 0] >= 0) & (c[:, 0] < b) & (c[:, 1] >= 0) & (c[:, 1] < nz)
          & (c[:, 2] >= 0) & (c[:, 2] < ny) & (c[:, 3] >= 0) & (c[:, 3] < nx))
    return torch.where(ok, lin, b * nz * ny * nx)


def bev_pool(feats, coords, valid, b: int, nz: int, ny: int, nx: int, max_cells: int = 0):
    """Sum frustum-point features (P, C) into a dense grid (B, nz, ny, nx, C)
    (fp32 sums, in feats' dtype out). coords (P, 4) int [b, z, y, x], valid
    (P,) bool; `max_cells`: the compacted table's rows, 0 for the dense
    form."""
    c = feats.shape[1]
    cells = b * nz * ny * nx
    lin = cell_index(coords, valid, b, nz, ny, nx)
    rows = feats.float()
    if max_cells and max_cells < cells:
        order = torch.argsort(lin, stable=True)
        lin_s = lin[order]
        inside = lin_s < cells
        is_start = torch.ones_like(inside)
        is_start[1:] = lin_s[1:] != lin_s[:-1]
        seg = torch.cumsum((is_start & inside).long(), 0) - 1
        seg = torch.where(inside & (seg < max_cells), seg, max_cells)
        pooled = rows.new_zeros((max_cells + 1, c)).index_add_(0, seg, rows[order])
        cell_of = torch.full((max_cells + 1,), cells, dtype=torch.int64, device=lin.device)
        cell_of[seg[is_start & inside]] = lin_s[is_start & inside]
        dense = rows.new_zeros((cells + 1, c))
        dense[cell_of[:max_cells]] = pooled[:max_cells]
    else:
        dense = rows.new_zeros((cells + 1, c)).index_add_(0, lin, rows)
    return dense[:cells].view(b, nz, ny, nx, c).to(feats.dtype)
