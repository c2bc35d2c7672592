"""Column-sparse (dense-z) execution of VoxelBackBone8x (port of
dfu3d_tpu/models/column_sparse.py).

Active voxels are grouped by BEV cell into (B, P, Z, C) column buffers with
the z extent dense. A 3×3×3 submanifold conv is then 9 BEV-neighbour column
gathers, each feeding 3 z-shifted slices of the zero-padded column to a
matmul; a strided conv reads its 9 neighbour columns at the parent's
stride-2 z taps; the z-only conv_out needs no gather. Inactive z slots of an
active column hold zeros, so summing over them is the submanifold semantics
as long as each layer's output is re-masked to the active set (`zmask`).

The parameter tree is the gather form's (`sparse_backbone.VoxelBackBone8x`):
the same submodule names (conv_input, conv1, down2, down2_bn, conv2a, ...,
conv_out, conv_out_bn; SubMConv3d_0, SparseBatchNorm_0) and kernels (27, Cin,
Cout) in kernel_offsets(3, 3, 3) order (x slowest, z fastest, so a reshape to
(9, 3, Cin, Cout) splits the BEV tap from dz), so `convert.params_from_jax`
and the reference checkpoint mappings load either form. It is the same
model with another execution, and it makes no call of the gather-GEMM
kernel: the products are torch matmuls over fp32 operands (bf16 values
upcast, as the JAX package's dot_general with an fp32 preferred type), their
sums in fp32 and the result cast to the compute dtype.

Like the gather form, `plan` builds every coordinate-dependent table first
(the columns, each stage's parent columns, neighbour tables and z masks, and
the final compaction) and `forward` runs the convs.

Caps count COLUMNS here and VOXELS in the gather form, so the two agree only
where no stage cap binds (the JAX module's documented deviation). Where one
binds, the drop orders are the JAX package's: columns beyond a cap drop by
ascending BEV index y·nx + x (largest first), and the final compaction keeps
the first max(voxel_cap // 8, 16) active slots of the (P·Z) flattening,
which is ascending column-major order, the slot order the port's sparse
tensors assume.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.voxel.sparse_ops import SparseGrid, build_lookup, find_neighbors, kernel_offsets
from ..core.voxel.voxelize import compact_cells, gather_slots
from .sparse_backbone import (
    SparseBatchNorm,
    SparseTensor,
    _Backbone8x,
    _compute_dtype,
    init_kernel,
)

OFFSETS_2D = kernel_offsets(3, 3, 1)  # tap2d k = 3 (ox + 1) + (oy + 1)
CHILD_TAPS = (4, 5, 7, 8)             # the taps (ox, oy) ∈ {0, 1}²: a parent's children


def _bev_grid(grid: SparseGrid) -> SparseGrid:
    return SparseGrid(grid.nx, grid.ny, 1)


def _xy0(xy):
    """(B, P, 2) BEV coords → (B, P, 3) with z 0 (cells of the BEV grid)."""
    return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def _first_columns(lin, num_cells: int, cap: int):
    """Columns of distinct keys (B, N) in ascending key order, the first
    `cap` kept: (column of each entry (B, N) in [0, cap], source (B, cap),
    num_unique (B,), valid (B, cap))."""
    col, source, num = compact_cells(lin, num_cells, cap)
    valid = torch.arange(cap, device=lin.device) < torch.clamp(num, max=cap)[:, None]
    return col, source, num, valid


def column_slots(grid: SparseGrid, coords, valid, col_cap: int):
    """The coordinate half of `columns_from_voxels`: (src (B, P·Z) int64,
    the voxel slot each column slot reads, V where none; col_xy (B, P, 2)
    int32; col_valid (B, P); zmask (B, P, Z); num_cols (B,) the distinct
    columns before the cap)."""
    b, v, _ = coords.shape
    z = grid.nz
    c = coords.long()
    inside = (valid & (c[..., 0] >= 0) & (c[..., 0] < grid.nx)
              & (c[..., 1] >= 0) & (c[..., 1] < grid.ny))
    cells = grid.nx * grid.ny
    lin = torch.where(inside, c[..., 1] * grid.nx + c[..., 0], cells)
    col, source, num_cols, col_valid = _first_columns(lin, cells, col_cap)
    col_xy = gather_slots(coords[..., :2].to(torch.int32), source, 0)
    ok = valid & (col < col_cap) & (c[..., 2] >= 0) & (c[..., 2] < z)
    dest = torch.where(ok, col * z + c[..., 2].clamp(0, z - 1), col_cap * z)
    src = torch.full((b, col_cap * z + 1), v, dtype=torch.int64, device=coords.device)
    src.scatter_(1, dest, torch.arange(v, device=coords.device).expand(b, v).contiguous())
    src = src[:, :col_cap * z]
    return src, col_xy, col_valid, (src < v).view(b, col_cap, z), num_cols


def gather_columns_of(feats, src, col_cap: int, z: int):
    """(B, V, C) voxel features → (B, P, Z, C) columns at `src` of
    `column_slots` (zeros where it reads V)."""
    b, v, c = feats.shape
    table = torch.cat([feats, feats.new_zeros(b, 1, c)], dim=1)
    return torch.gather(table, 1, src[..., None].expand(-1, -1, c)).view(b, col_cap, z, c)


def columns_from_voxels(grid: SparseGrid, feats, coords, valid, col_cap: int):
    """(B, V, C) voxel list → dense-z columns: (col_feats (B, P, Z, C),
    col_xy (B, P, 2), col_valid (B, P), zmask (B, P, Z)). Columns beyond
    col_cap drop by ascending BEV index y·nx + x (the largest first)."""
    src, col_xy, col_valid, zmask, _ = column_slots(grid, coords, valid, col_cap)
    return gather_columns_of(feats, src, col_cap, grid.nz), col_xy, col_valid, zmask


def _col_neighbors(grid: SparseGrid, q_xy, q_valid, col_xy, col_valid):
    """(B, Q, 9) BEV-neighbour column slots (sentinel P) of the queries q_xy
    (in the input grid's cell units) among the columns col_xy: the port's
    element lookup over the nx · ny BEV grid."""
    g2 = _bev_grid(grid)
    lookup = build_lookup(g2, _xy0(col_xy), col_valid)
    return find_neighbors(g2, _xy0(q_xy), q_valid, *lookup, OFFSETS_2D)


def _padded_column_table(colf, valid):
    """(B, P, Z, C) → (B·(P + 1), Z, C): invalid columns zeroed and one zero
    column appended per sample, which the sentinel P reads."""
    b, p, z, c = colf.shape
    masked = torch.where(valid[..., None, None], colf, 0)
    return torch.cat([masked, masked.new_zeros(b, 1, z, c)], dim=1).reshape(b * (p + 1), z, c)


def _gather_one_column_tap(colf_padded, nbr, tap: int, b: int, p: int):
    """One tap's neighbour columns (B, Q, Z, C) from `_padded_column_table`."""
    base = torch.arange(b, device=nbr.device, dtype=torch.int64)[:, None] * (p + 1)
    idx = (nbr[:, :, tap].long() + base).reshape(-1)
    q = nbr.shape[1]
    return colf_padded.index_select(0, idx).view(b, q, *colf_padded.shape[1:])


def _gather_columns(colf, valid, nbr):
    """(B, P, Z, C), (B, Q, 9) → (B, Q, 9, Z, C); sentinel taps read zeros."""
    b, p = colf.shape[:2]
    padded = _padded_column_table(colf, valid)
    return torch.stack([_gather_one_column_tap(padded, nbr, t, b, p)
                        for t in range(nbr.shape[2])], dim=2)


def _z_taps(kernel):
    """(3·k, Cin, Cout) → (k, Cin · 3, Cout) fp32, rows in the (Cin, dz)
    order of a z-unfolded column."""
    k3, cin, cout = kernel.shape
    return kernel.float().view(k3 // 3, 3, cin, cout).transpose(1, 2).reshape(k3 // 3, cin * 3,
                                                                               cout)


def _z_unfold(g, z: int, stride: int):
    """(B, Q, Z, C) → (B·Q·Zo, C · 3) fp32: the column zero-padded by 1 at
    the front (and 1 + z % 2 at the back at stride 2) and its windows of 3
    z slots, `stride` apart, Zo = ceil(Z / stride)."""
    gp = F.pad(g, (0, 0, 1, 1 + (z % 2 if stride == 2 else 0)))
    return gp.unfold(2, 3, stride).reshape(-1, g.shape[-1] * 3).float()


def _maybe_checkpoint(fn, *args):
    """fn(*args), recomputed in the backward instead of keeping its gathered
    taps (the JAX package's jax.checkpoint) when a gradient is recorded."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _neighbour_conv(colf, col_valid, nbr, kernel27, stride: int):
    """Σ over the 9 BEV taps and 3 z taps, fp32 sums: (B, Q, Zo, Cout) in
    colf's dtype."""
    b, p, z, _ = colf.shape
    q = nbr.shape[1]
    zo = -(-z // stride)
    with torch.autocast(colf.device.type, enabled=False):
        w = _z_taps(kernel27)
        padded = _padded_column_table(colf, col_valid)
        out = torch.zeros((b * q * zo, w.shape[-1]), dtype=torch.float32, device=colf.device)
        for t in range(9):
            g = _gather_one_column_tap(padded, nbr, t, b, p)
            out = torch.addmm(out, _z_unfold(g, z, stride), w[t])
    return out.view(b, q, zo, -1).to(colf.dtype)


def _masked_conv(colf, col_valid, nbr, out_zmask, kernel27, stride: int):
    """`_neighbour_conv` recomputed in the backward, masked to out_zmask."""
    out = _maybe_checkpoint(lambda f, k: _neighbour_conv(f, col_valid, nbr, k, stride),
                            colf, kernel27)
    return torch.where(out_zmask[..., None], out, 0)


def column_subm_conv(colf, col_valid, zmask, nbr, kernel27):
    """3×3×3 submanifold conv over dense-z columns, masked to zmask. colf
    (B, P, Z, Cin); nbr (B, P, 9); kernel27 (27, Cin, Cout) in
    kernel_offsets(3, 3, 3) order. Recomputed in the backward."""
    return _masked_conv(colf, col_valid, nbr, zmask, kernel27, 1)


def downsample_columns(grid: SparseGrid, col_xy, col_valid, out_cap: int):
    """The distinct BEV parent columns (xy // 2) in ascending y·nx + x order
    on the halved grid, the first out_cap kept: (out_xy (B, out_cap, 2)
    int32, out_valid (B, out_cap), num_parents (B,) before the cap)."""
    g2x, g2y = -(-grid.nx // 2), -(-grid.ny // 2)
    par = torch.div(col_xy.long(), 2, rounding_mode="floor")
    lin = torch.where(col_valid, par[..., 1] * g2x + par[..., 0], g2x * g2y)
    _, source, num, out_valid = _first_columns(lin, g2x * g2y, out_cap)
    return gather_slots(par.to(torch.int32), source, 0), out_valid, num


def down_zmask(zmask, col_valid, nbr, out_valid):
    """The strided conv's output z mask: (q, zo) is active iff any voxel of
    its 2 × 2 × 2 children is (the child columns at CHILD_TAPS)."""
    b, q = nbr.shape[:2]
    z = zmask.shape[-1]
    zo = -(-z // 2)
    zm = _gather_columns(zmask[..., None].float(), col_valid, nbr[..., list(CHILD_TAPS)])
    zm = F.pad(zm[..., 0] > 0.5, (0, z % 2))                      # (B, Q, 4, Z + z % 2)
    return zm.view(b, q, 4, zo, 2).any(dim=4).any(dim=2) & out_valid[..., None]


def zdown_zmask(zmask, col_valid):
    """conv_out's output z mask: either of the two child z slots active."""
    b, p, z = zmask.shape
    zm = F.pad(zmask, (0, z % 2)).view(b, p, -(-z // 2), 2).any(dim=-1)
    return zm & col_valid[..., None]


def column_down_conv(colf, col_valid, zmask, col_xy, grid: SparseGrid, out_cap: int, kernel27):
    """Strided-2 (xyz) 3×3×3 conv over columns: the output columns are the
    distinct BEV parents, the z extent ceil(Z / 2), an output voxel active
    iff a child is. Returns (out_feats, out_xy, out_valid, out_zmask)."""
    out_xy, out_valid, _ = downsample_columns(grid, col_xy, col_valid, out_cap)
    nbr = _col_neighbors(grid, out_xy * 2, out_valid, col_xy, col_valid)
    out_zmask = down_zmask(zmask, col_valid, nbr, out_valid)
    return (_masked_conv(colf, col_valid, nbr, out_zmask, kernel27, 2), out_xy, out_valid,
            out_zmask)


def column_zdown_conv(colf, col_valid, zmask, kernel3):
    """conv_out: kernel (1, 1, 3), stride (1, 1, 2), per column, no gathers.
    kernel3 (3, Cin, Cout). Returns (out_feats, out_zmask)."""
    b, p, z, _ = colf.shape
    x = torch.where(zmask[..., None] & col_valid[..., None, None], colf, 0)
    with torch.autocast(colf.device.type, enabled=False):
        out = torch.mm(_z_unfold(x, z, 2), _z_taps(kernel3)[0])
    out = out.view(b, p, -(-z // 2), -1).to(colf.dtype)
    out_zmask = zdown_zmask(zmask, col_valid)
    return torch.where(out_zmask[..., None], out, 0), out_zmask


class ColumnLevel(NamedTuple):
    """One column set of the backbone and the tables that read it."""

    grid: SparseGrid
    col_xy: torch.Tensor                 # (B, P, 2) int32, ascending y·nx + x
    col_valid: torch.Tensor              # (B, P) bool
    zmask: torch.Tensor                  # (B, P, Z) bool, the active voxels
    num_cols: torch.Tensor               # (B,) distinct columns before the cap of P
    down_nbr: Optional[torch.Tensor]     # (B, P, 9) the strided conv's table into the previous set
    subm_nbr: Optional[torch.Tensor]     # (B, P, 9) the submanifold convs' table on this set


class ColumnPlan(NamedTuple):
    """`ColumnVoxelBackBone8x.plan`: the five column sets (input, strides 2,
    4, 8, conv_out), the input's voxel slot per column slot, and the final
    compaction: the (P·Z) slot of each output slot, and its coords and
    valid."""

    levels: tuple
    src: torch.Tensor         # (B, P0·Z0) int64
    keep: torch.Tensor        # (B, V8) int64
    out_coords: torch.Tensor  # (B, V8, 3) int32, 0 where invalid
    out_valid: torch.Tensor   # (B, V8) bool


class ColumnSubMConv3d(nn.Module):
    """Parameter twin of sparse_backbone.SubMConv3d (kernel (27, Cin, Cout))."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(init_kernel(27, in_channels, out_channels))

    def forward(self, colf, col_valid, zmask, nbr):
        dtype = _compute_dtype(colf)
        return column_subm_conv(colf.to(dtype), col_valid, zmask, nbr, self.kernel.to(dtype))


def _bn_relu(bn, colf, zmask):
    """BN over the active slots of the flattened (P·Z) columns, ReLU,
    re-masked."""
    b, p, z, c = colf.shape
    x = F.relu(bn(colf.reshape(b, p * z, c), zmask.reshape(b, p * z)))
    return torch.where(zmask[..., None], x.view(b, p, z, c), 0)


class ColumnConvBlock(nn.Module):
    """Parameter twin of sparse_backbone.SparseConvBlock (SubMConv3d_0 +
    SparseBatchNorm_0 + ReLU) over columns."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.SubMConv3d_0 = ColumnSubMConv3d(in_channels, out_channels)
        self.SparseBatchNorm_0 = SparseBatchNorm(out_channels)

    def forward(self, colf, col_valid, zmask, nbr):
        return _bn_relu(self.SparseBatchNorm_0,
                        self.SubMConv3d_0(colf, col_valid, zmask, nbr), zmask)


class ColumnDownConv(nn.Module):
    """Parameter twin of sparse_backbone.SparseConv3dDown (kernel (27, Cin,
    Cout), or (3, Cin, Cout) with z_only: conv_out)."""

    def __init__(self, in_channels: int, out_channels: int, out_cap: int, z_only: bool = False):
        super().__init__()
        self.out_cap = out_cap
        self.z_only = z_only
        self.kernel = nn.Parameter(init_kernel(3 if z_only else 27, in_channels, out_channels))

    def plan(self, level: ColumnLevel) -> ColumnLevel:
        """The output column set of this conv on `level`, with its table
        into `level` (none for conv_out) and its z mask."""
        if self.z_only:
            return ColumnLevel(level.grid.down_z(), level.col_xy, level.col_valid,
                               zdown_zmask(level.zmask, level.col_valid), level.num_cols,
                               None, None)
        out_xy, out_valid, num = downsample_columns(level.grid, level.col_xy, level.col_valid,
                                                    self.out_cap)
        nbr = _col_neighbors(level.grid, out_xy * 2, out_valid, level.col_xy, level.col_valid)
        return ColumnLevel(level.grid.down(), out_xy, out_valid,
                           down_zmask(level.zmask, level.col_valid, nbr, out_valid), num,
                           nbr, None)

    def forward(self, colf, level: ColumnLevel, out: ColumnLevel):
        """colf on `level` → the output features on `out` (its plan)."""
        dtype = _compute_dtype(colf)
        colf, w = colf.to(dtype), self.kernel.to(dtype)
        if self.z_only:
            return column_zdown_conv(colf, level.col_valid, level.zmask, w)[0]
        return _masked_conv(colf, level.col_valid, out.down_nbr, out.zmask, w, 2)


class ColumnVoxelBackBone8x(_Backbone8x):
    """VoxelBackBone8x executed column-sparse, with the gather form's
    constructor, parameter names and output contract: a SparseTensor of
    max(voxel_cap // 8, 16) slots on `out_grid`, valid first in ascending
    column-major order. The input columns are capped at voxel_cap, the
    strided convs' output columns at the stage caps voxel_cap / 2, / 4, / 8
    (at least 16)."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 16, 32, 64, 64), out_channels: int = 128):
        super().__init__(grid, voxel_cap)
        ch = tuple(channels)
        self.conv_input = ColumnConvBlock(in_channels, ch[0])
        self.conv1 = ColumnConvBlock(ch[0], ch[1])
        for s in range(2, 5):
            self.add_module(f"down{s}", ColumnDownConv(ch[s - 1], ch[s], self.caps[s - 2]))
            self.add_module(f"down{s}_bn", SparseBatchNorm(ch[s]))
            self.add_module(f"conv{s}a", ColumnConvBlock(ch[s], ch[s]))
            self.add_module(f"conv{s}b", ColumnConvBlock(ch[s], ch[s]))
        self.conv_out = ColumnDownConv(ch[4], out_channels, self.caps[2], z_only=True)
        self.conv_out_bn = SparseBatchNorm(out_channels)

    @property
    def out_cap(self) -> int:
        return max(self.voxel_cap // 8, 16)

    def plan(self, coords, valid, num_unique=None, transpose: bool = False) -> ColumnPlan:
        """Every column set and table from the voxelizer's coords (B, V, 3);
        `num_unique` and `transpose` are the gather form's and unused (the
        backward needs no table of its own)."""
        src, col_xy, col_valid, zmask, num_cols = column_slots(self.grid, coords, valid,
                                                                self.voxel_cap)
        lv = ColumnLevel(self.grid, col_xy, col_valid, zmask, num_cols, None,
                         _col_neighbors(self.grid, col_xy, col_valid, col_xy, col_valid))
        levels = [lv]
        for name in ("down2", "down3", "down4", "conv_out"):
            lv = getattr(self, name).plan(lv)
            if name != "conv_out":
                lv = lv._replace(subm_nbr=_col_neighbors(lv.grid, lv.col_xy, lv.col_valid,
                                                         lv.col_xy, lv.col_valid))
            levels.append(lv)
        # the final compaction: valid (P·Z) slots first, stably
        b, p, z = lv.zmask.shape
        flat_valid = (lv.zmask & lv.col_valid[..., None]).reshape(b, p * z)
        keep = torch.argsort((~flat_valid).to(torch.int32), dim=1, stable=True)[:, :self.out_cap]
        out_valid = flat_valid.gather(1, keep)
        xy = lv.col_xy.gather(1, (keep // z)[..., None].expand(-1, -1, 2))
        coords = torch.cat([xy, (keep % z).to(torch.int32)[..., None]], dim=-1)
        coords = torch.where(out_valid[..., None], coords, 0)
        return ColumnPlan(tuple(levels), src, keep, coords, out_valid)

    def forward(self, features, plan: ColumnPlan) -> SparseTensor:
        lv = plan.levels
        l0 = lv[0]
        colf = gather_columns_of(features, plan.src, self.voxel_cap, self.grid.nz)
        colf = self.conv_input(colf, l0.col_valid, l0.zmask, l0.subm_nbr)
        colf = self.conv1(colf, l0.col_valid, l0.zmask, l0.subm_nbr)
        for s in range(2, 5):
            prev, cur = lv[s - 2], lv[s - 1]
            colf = _bn_relu(getattr(self, f"down{s}_bn"),
                            getattr(self, f"down{s}")(colf, prev, cur), cur.zmask)
            for blk in ("a", "b"):
                colf = getattr(self, f"conv{s}{blk}")(colf, cur.col_valid, cur.zmask,
                                                      cur.subm_nbr)
        colf = _bn_relu(self.conv_out_bn, self.conv_out(colf, lv[3], lv[4]), lv[4].zmask)
        b, p, z, c = colf.shape
        feats = colf.reshape(b, p * z, c).gather(1, plan.keep[..., None].expand(-1, -1, c))
        feats = torch.where(plan.out_valid[..., None], feats, 0)
        return SparseTensor(feats, plan.out_coords, plan.out_valid, lv[4].grid)
