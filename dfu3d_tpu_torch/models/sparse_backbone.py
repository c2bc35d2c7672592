"""Sparse 3D backbone: VoxelResBackBone8x and height_compression (port of
dfu3d_tpu/models/sparse_backbone.py:58-93, :244-328, :446-473, :530-685,
:749-765, :890-972).

Every sparse conv is one call of the gather-GEMM kernel B2
(`core/voxel/gather_gemm_kernel.gather_gemm`) over an element neighbour table
(B, Q, K). The coordinate sets and tables depend on the voxel coordinates
only, so `VoxelResBackBone8x.plan` builds them all first, one sort per
coordinate set, shared by every conv that reads that set (the spconv
indice_key reuse of JAX's `stage_tables`); `forward` then runs the convs.

The backward of a conv is the JAX package's gather-only custom VJP with dX
as a second B2 launch: a submanifold conv's table is its own transpose with
the taps reversed (the offsets are centrosymmetric: nbr_k(q) = p ⟺
nbr_{K-1-k}(p) = q), so dX = B2(g, nbr, W reversed on K and transposed); a
strided conv's dX reads the transpose table that `plan` builds when the
model trains (`transpose_down_neighbors`), dX = B2(g, tnbr, Wᵀ). dW stays a
plain row gather and matmul per tap in fp32, as the JAX package keeps it on
the XLA path (pallas_sparse.py:18-19).

The JAX package runs its 3×3×3 convs in the grouped packed-row form and its
z-only conv_out in the element form; its tests hold the two forms equal
(tests/test_sparse_vjp.py TestGroupedSubm), and the element form is what B2
computes. Module and parameter names follow the flax tree
(backbone_3d.res1a.conv1.kernel, down2_bn, conv_input.SubMConv3d_0, ...).
Like the flax modules, which cast to their compute dtype, a conv casts its
features and weight to the autocast dtype itself, outside the autograd
Function, so autograd carries the gradient back through the casts: autocast
does not reach a ctypes kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.voxel import gather_gemm_kernel
from ..core.voxel.sparse_ops import (
    SparseGrid,
    build_lookup,
    downsample_coords,
    find_neighbors,
    kernel_offsets,
    transpose_down_neighbors,
)
from .vfe import MaskedBatchNorm


class SparseBatchNorm(MaskedBatchNorm):
    """BN over the active voxels of the whole batch (eps 1e-3, keep 0.99),
    with the JAX package's two-pass training statistics: the mean, then the
    mean of squared deviations from it."""

    def batch_stats(self, x, mask):
        m = mask.float()[..., None]
        dims = tuple(range(x.dim() - 1))
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x.float() * m).sum(dims) / count
        var = (torch.square(x.float() - mean) * m).sum(dims) / count
        return mean, var


class SparseTensor(NamedTuple):
    features: torch.Tensor  # (B, V, C)
    coords: torch.Tensor    # (B, V, 3) int32 (ix, iy, iz)
    valid: torch.Tensor     # (B, V) bool
    grid: SparseGrid


class Level(NamedTuple):
    """One coordinate set of the backbone and the tables that read it."""

    grid: SparseGrid
    coords: torch.Tensor      # (B, V, 3) int32, column-major slot order
    valid: torch.Tensor       # (B, V) bool
    num_unique: torch.Tensor  # (B,) active cells before the cap of V slots
    down_nbr: Optional[torch.Tensor]  # (B, V, K) table of the strided conv that makes this set
    subm_nbr: Optional[torch.Tensor]  # (B, V, 27) table of the submanifold convs on this set
    # (B, V_in, K) transpose of down_nbr, built for training only
    down_tnbr: Optional[torch.Tensor] = None


def weight_grad(feats, valid, nbr, g):
    """dW[k] = Σ_q T[nbr[q, k]]ᵀ g[q] in fp32, one row gather and one matmul
    per tap (T: feats masked by valid, the sentinel reads zero). Equal to the
    JAX package's Σ_p T[p]ᵀ g[t_k(p)] over the transpose relation; reading
    the forward table gathers Q rows per tap instead of V."""
    table = gather_gemm_kernel.padded_table(feats, valid)
    g2 = g.float().reshape(-1, g.shape[-1])
    dw = torch.empty((nbr.shape[2], feats.shape[2], g.shape[-1]), dtype=torch.float32,
                     device=feats.device)
    for j, rows in enumerate(gather_gemm_kernel.table_rows(nbr, feats.shape[1])):
        torch.mm(table.index_select(0, rows).t(), g2, out=dw[j])
    return dw


class _GatherGemmConv(torch.autograd.Function):
    """B2 forward; backward per dfu3d_tpu sparse_backbone.py:244-328
    (submanifold: out_valid None) or :446-473 (strided): dX is a B2 launch,
    masked by the input's valid and skipped when feats needs no gradient;
    dW is `weight_grad`, returned in the weight's (compute) dtype."""

    @staticmethod
    def forward(ctx, feats, valid, nbr, kernel, tnbr, out_valid):
        ctx.save_for_backward(feats, valid, nbr, kernel, tnbr, out_valid)
        return gather_gemm_kernel.gather_gemm(feats, valid, nbr, kernel)

    @staticmethod
    def backward(ctx, g):
        feats, valid, nbr, kernel, tnbr, out_valid = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if out_valid is None:   # submanifold: the reversed table, W reversed on K
                args = (valid, nbr, kernel.flip(0).transpose(1, 2).contiguous())
            elif tnbr is None:
                raise RuntimeError("a strided sparse conv's dX needs its transpose table: "
                                   "build the levels with plan(..., transpose=True)")
            else:
                args = (out_valid, tnbr, kernel.transpose(1, 2).contiguous())
            dx = gather_gemm_kernel.gather_gemm(g, *args)
            dx = torch.where(valid[..., None], dx, 0)
        if ctx.needs_input_grad[3]:
            with torch.autocast(g.device.type, enabled=False):
                dw = weight_grad(feats, valid, nbr, g).to(kernel.dtype)
        return dx, None, None, dw, None, None


def subm_gather_gemm(feats, valid, nbr, kernel):
    """Submanifold gather-GEMM (B2) with the gather-only backward."""
    return _GatherGemmConv.apply(feats, valid, nbr, kernel, None, None)


def down_gather_gemm(feats, valid, nbr, tnbr, kernel, out_valid):
    """Strided gather-GEMM (B2); the backward's dX reads the transpose table
    `tnbr` (B, V, K) with the output set's `out_valid` (without the table,
    None, only dW can be computed)."""
    return _GatherGemmConv.apply(feats, valid, nbr, kernel, tnbr, out_valid)


def _compute_dtype(x):
    """The autocast dtype on x's device, else x's own."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class SubMConv3d(nn.Module):
    """Submanifold sparse conv: output set == input set."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        k = kernel_size[0] * kernel_size[1] * kernel_size[2]
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        dtype = _compute_dtype(st.features)
        out = subm_gather_gemm(st.features.to(dtype).contiguous(), st.valid, nbr,
                               self.kernel.to(dtype).contiguous())
        return st._replace(features=torch.where(st.valid[..., None], out, 0))


class SparseConv3dDown(nn.Module):
    """Strided (2×) sparse conv; the output set is the parent cells of the
    active inputs, capped at `out_cap` per sample. z_only: stride (1, 1, 2)
    with a (1, 1, kz) kernel, the z-compressing conv_out."""

    def __init__(self, in_channels: int, out_channels: int, out_cap: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), z_only: bool = False):
        super().__init__()
        self.out_cap = out_cap
        self.z_only = z_only
        self.kernel_size = (1, 1, kernel_size[2]) if z_only else tuple(kernel_size)
        k = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))

    def plan(self, grid: SparseGrid, coords, valid, lookup) -> Level:
        """Output set and table of this conv; `lookup` is `build_lookup` of
        the input set."""
        down = grid.down_z() if self.z_only else grid.down()
        out_coords, out_valid, _, num_unique = downsample_coords(
            down, coords, valid, self.out_cap, z_only=self.z_only)
        if self.z_only:
            centers = out_coords * torch.tensor([1, 1, 2], dtype=torch.int32,
                                                device=coords.device)
        else:
            centers = out_coords * 2
        nbr = find_neighbors(grid, centers, out_valid, *lookup, kernel_offsets(*self.kernel_size))
        return Level(down, out_coords, out_valid, num_unique, nbr, None)

    def transpose_table(self, coords, valid, out: Level, out_lookup):
        """The transpose of out.down_nbr over the input set (coords, valid);
        `out_lookup` is `build_lookup` of the output set."""
        return transpose_down_neighbors(out.grid, coords, valid, *out_lookup,
                                        kernel_offsets(*self.kernel_size), z_only=self.z_only)

    def forward(self, st: SparseTensor, out: Level) -> SparseTensor:
        dtype = _compute_dtype(st.features)
        feats = down_gather_gemm(st.features.to(dtype).contiguous(), st.valid, out.down_nbr,
                                 out.down_tnbr, self.kernel.to(dtype).contiguous(), out.valid)
        feats = torch.where(out.valid[..., None], feats, 0)
        return SparseTensor(feats, out.coords, out.valid, out.grid)


class SparseConvBlock(nn.Module):
    """SubM → BN → ReLU, re-masked."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.SubMConv3d_0 = SubMConv3d(in_channels, out_channels)
        self.SparseBatchNorm_0 = SparseBatchNorm(out_channels)

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        st = self.SubMConv3d_0(st, nbr)
        x = F.relu(self.SparseBatchNorm_0(st.features, st.valid))
        return st._replace(features=torch.where(st.valid[..., None], x, 0))


class SparseResBlock(nn.Module):
    """Residual submanifold block: SubM → BN → ReLU → SubM → BN, + skip,
    ReLU (reference SparseBasicBlock), at one width."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SubMConv3d(channels, channels)
        self.bn1 = SparseBatchNorm(channels)
        self.conv2 = SubMConv3d(channels, channels)
        self.bn2 = SparseBatchNorm(channels)

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        identity = st.features
        st1 = self.conv1(st, nbr)
        x = F.relu(self.bn1(st1.features, st1.valid))
        st2 = self.conv2(st._replace(features=x), nbr)
        x = self.bn2(st2.features, st2.valid)
        x = F.relu(x + identity.to(x.dtype))
        return st._replace(features=torch.where(st.valid[..., None], x, 0))


class VoxelResBackBone8x(nn.Module):
    """Channels 16 → 32 → 64 → 128 at strides 1/2/4/8, two residual blocks
    per stage, strided convs between, then the z-compressing conv_out
    (reference spconv_backbone.VoxelResBackBone8x). Stage caps are
    voxel_cap / 2, / 4, / 8 (at least 16), conv_out's / 8."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128), out_channels: int = 128):
        super().__init__()
        self.grid = grid
        self.voxel_cap = voxel_cap
        ch = tuple(channels)
        caps = [max(voxel_cap // d, 16) for d in (2, 4, 8)]
        self.conv_input = SparseConvBlock(in_channels, ch[0])
        self.res1a = SparseResBlock(ch[0])
        self.res1b = SparseResBlock(ch[0])
        for i in range(1, 4):
            self.add_module(f"down{i + 1}", SparseConv3dDown(ch[i - 1], ch[i], caps[i - 1]))
            self.add_module(f"down{i + 1}_bn", SparseBatchNorm(ch[i]))
            self.add_module(f"res{i + 1}a", SparseResBlock(ch[i]))
            self.add_module(f"res{i + 1}b", SparseResBlock(ch[i]))
        self.conv_out = SparseConv3dDown(ch[3], out_channels, caps[2], z_only=True)
        self.conv_out_bn = SparseBatchNorm(out_channels)

    @property
    def out_grid(self) -> SparseGrid:
        return self.grid.down().down().down().down_z()

    def plan(self, coords, valid, num_unique, transpose: bool = False) -> Tuple[Level, ...]:
        """The five coordinate sets (input, strides 2, 4, 8, conv_out) and
        their neighbour tables, from the voxelizer's coords (B, V, 3); with
        `transpose` (training) also each strided conv's transpose table."""
        offsets = kernel_offsets(3, 3, 3)
        grid = self.grid
        lookup = build_lookup(grid, coords, valid)
        levels = [Level(grid, coords, valid, num_unique, None,
                        find_neighbors(grid, coords, valid, *lookup, offsets))]
        for i in range(4):
            conv = getattr(self, f"down{i + 2}") if i < 3 else self.conv_out
            nxt = conv.plan(grid, coords, valid, lookup)
            out_lookup = build_lookup(nxt.grid, nxt.coords, nxt.valid) if i < 3 or transpose \
                else None
            if i < 3:
                nxt = nxt._replace(subm_nbr=find_neighbors(nxt.grid, nxt.coords, nxt.valid,
                                                           *out_lookup, offsets))
            if transpose:
                nxt = nxt._replace(down_tnbr=conv.transpose_table(coords, valid, nxt, out_lookup))
            levels.append(nxt)
            grid, coords, valid, lookup = nxt.grid, nxt.coords, nxt.valid, out_lookup
        return tuple(levels)

    def forward(self, features, levels) -> SparseTensor:
        lv = levels[0]
        st = SparseTensor(features, lv.coords, lv.valid, lv.grid)
        st = self.conv_input(st, lv.subm_nbr)
        st = self.res1b(self.res1a(st, lv.subm_nbr), lv.subm_nbr)
        for i in range(1, 5):
            name = f"down{i + 1}" if i < 4 else "conv_out"
            st = getattr(self, name)(st, levels[i])
            x = F.relu(getattr(self, f"{name}_bn")(st.features, st.valid))
            st = st._replace(features=torch.where(st.valid[..., None], x, 0))
            if i < 4:
                nbr = levels[i].subm_nbr
                st = getattr(self, f"res{i + 1}b")(getattr(self, f"res{i + 1}a")(st, nbr), nbr)
        return st


def height_compression(st: SparseTensor):
    """Sparse → dense BEV (B, ny, nx, nz · C) in fp32, channels z-major
    (index z · C + c; reference HeightCompression). Slots hold distinct
    cells, so the scatter has no collisions."""
    g = st.grid
    b, v, c = st.features.shape
    cells = g.num_cells
    lin = ((st.coords[..., 2].long() * g.ny + st.coords[..., 1]) * g.nx + st.coords[..., 0])
    base = torch.arange(b, device=lin.device)[:, None] * cells
    lin = torch.where(st.valid, lin + base, b * cells).reshape(-1)
    dense = st.features.new_zeros((b * cells + 1, c), dtype=torch.float32)
    dense[lin] = st.features.float().reshape(b * v, c)
    dense = dense[:b * cells].view(b, g.nz, g.ny, g.nx, c)
    return dense.permute(0, 2, 3, 1, 4).reshape(b, g.ny, g.nx, g.nz * c)
