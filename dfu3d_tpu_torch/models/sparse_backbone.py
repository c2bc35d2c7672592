"""Sparse 3D backbones: VoxelResBackBone8x, VoxelBackBone8x, SparseEncoder,
VoxelResBackBone8xVoxelNeXt, height_compression and voxel_centers_of (port
of dfu3d_tpu/models/sparse_backbone.py:58-93, :244-328, :446-473,
:530-972).

Every sparse conv is one call of the gather-GEMM kernel B2
(`core/voxel/gather_gemm_kernel.gather_gemm`) over an element neighbour table
(B, Q, K). The coordinate sets and tables depend on the voxel coordinates
only, so `plan` builds them all first, one sort per
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

import math
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
from ..parallel import mesh
from .vfe import MaskedBatchNorm


class SparseBatchNorm(MaskedBatchNorm):
    """BN over the active voxels of the whole batch (eps 1e-3, keep 0.99),
    with the JAX package's two-pass training statistics: the mean, then the
    mean of squared deviations from it. Over several ranks both passes are
    over the global batch: (Σx·m, count) summed over ranks, then
    Σ(x - mean)²·m."""

    GLOBAL_BATCH = True

    def batch_stats(self, x, mask):
        m = mask.float()[..., None]
        dims = tuple(range(x.dim() - 1))
        sums = mesh.global_sum(torch.cat([(x.float() * m).sum(dims), m.sum().reshape(1)]))
        count = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / count
        var = mesh.global_sum((torch.square(x.float() - mean) * m).sum(dims)) / count
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


def init_kernel(k: int, in_channels: int, out_channels: int):
    """A (K, Cin, Cout) sparse conv kernel drawn as the JAX package draws it
    (flax variance_scaling(1, "fan_in", "truncated_normal"): fan-in K · Cin,
    normal truncated at two standard deviations and rescaled to unit
    variance), from torch's global generator."""
    std = math.sqrt(1.0 / (k * in_channels)) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(k, in_channels, out_channels), 0.0, std,
                                 -2 * std, 2 * std)


class SubMConv3d(nn.Module):
    """Submanifold sparse conv: output set == input set."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        k = kernel_size[0] * kernel_size[1] * kernel_size[2]
        self.kernel = nn.Parameter(init_kernel(k, in_channels, out_channels))

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        dtype = _compute_dtype(st.features)
        out = subm_gather_gemm(st.features.to(dtype).contiguous(), st.valid, nbr,
                               self.kernel.to(dtype).contiguous())
        return st._replace(features=torch.where(st.valid[..., None], out, 0))


class SparseConv3dDown(nn.Module):
    """Strided (2×) sparse conv; the output set is the parent cells of the
    active inputs, capped at `out_cap` per sample. z_only: stride (1, 1, 2)
    with a (1, 1, kz) kernel, the z-compressing conv_out."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, out_channels: int, out_cap: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), z_only: bool = False):
        super().__init__()
        self.out_cap = out_cap
        self.z_only = z_only
        self.kernel_size = (1, 1, kernel_size[2]) if z_only else tuple(kernel_size)
        k = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        self.kernel = nn.Parameter(init_kernel(k, in_channels, out_channels))

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
    """SubM → BN → ReLU, re-masked; the table passed to `forward` holds the
    taps of `kernel_size` (kernel_offsets order)."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.SubMConv3d_0 = SubMConv3d(in_channels, out_channels, kernel_size)
        self.SparseBatchNorm_0 = SparseBatchNorm(out_channels)

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        st = self.SubMConv3d_0(st, nbr)
        x = F.relu(self.SparseBatchNorm_0(st.features, st.valid))
        return st._replace(features=torch.where(st.valid[..., None], x, 0))


class SparseResBlock(nn.Module):
    """Residual submanifold block: SubM → BN → ReLU → SubM → BN, + skip,
    ReLU (reference SparseBasicBlock), at one width."""

    GLOBAL_BATCH = True

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


class _Backbone8x(nn.Module):
    """What both 8x voxel backbones share: an input grid, the stage caps
    voxel_cap / 2, / 4, / 8 (at least 16), the strided convs down2, down3,
    down4 and the z-compressing conv_out, and `plan`, which builds every
    stage's coordinate set and tables once."""

    def __init__(self, grid: SparseGrid, voxel_cap: int):
        super().__init__()
        self.grid = grid
        self.voxel_cap = voxel_cap
        self.caps = [max(voxel_cap // d, 16) for d in (2, 4, 8)]

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

    def down_bn_relu(self, name: str, st: SparseTensor, level: Level) -> SparseTensor:
        """The strided conv `name`, its BN and a ReLU, re-masked."""
        st = getattr(self, name)(st, level)
        x = F.relu(getattr(self, f"{name}_bn")(st.features, st.valid))
        return st._replace(features=torch.where(st.valid[..., None], x, 0))


class VoxelResBackBone8x(_Backbone8x):
    """Channels 16 → 32 → 64 → 128 at strides 1/2/4/8, two residual blocks
    per stage, strided convs between, then the z-compressing conv_out
    (reference spconv_backbone.VoxelResBackBone8x). Stage caps are
    voxel_cap / 2, / 4, / 8 (at least 16), conv_out's / 8."""

    GLOBAL_BATCH = True

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128), out_channels: int = 128):
        super().__init__(grid, voxel_cap)
        ch = tuple(channels)
        self.conv_input = SparseConvBlock(in_channels, ch[0])
        self.res1a = SparseResBlock(ch[0])
        self.res1b = SparseResBlock(ch[0])
        for i in range(1, 4):
            self.add_module(f"down{i + 1}", SparseConv3dDown(ch[i - 1], ch[i], self.caps[i - 1]))
            self.add_module(f"down{i + 1}_bn", SparseBatchNorm(ch[i]))
            self.add_module(f"res{i + 1}a", SparseResBlock(ch[i]))
            self.add_module(f"res{i + 1}b", SparseResBlock(ch[i]))
        self.conv_out = SparseConv3dDown(ch[3], out_channels, self.caps[2], z_only=True)
        self.conv_out_bn = SparseBatchNorm(out_channels)

    def forward(self, features, levels) -> SparseTensor:
        lv = levels[0]
        st = SparseTensor(features, lv.coords, lv.valid, lv.grid)
        st = self.conv_input(st, lv.subm_nbr)
        st = self.res1b(self.res1a(st, lv.subm_nbr), lv.subm_nbr)
        for i in range(1, 5):
            name = f"down{i + 1}" if i < 4 else "conv_out"
            st = self.down_bn_relu(name, st, levels[i])
            if i < 4:
                nbr = levels[i].subm_nbr
                st = getattr(self, f"res{i + 1}b")(getattr(self, f"res{i + 1}a")(st, nbr), nbr)
        return st


class VoxelBackBone8x(_Backbone8x):
    """Channels 16 → 16 → 32 → 64 → 64 at strides 1/1/2/4/8: two submanifold
    blocks per stride (conv_input and conv1 at stride 1; conv{s}a, conv{s}b
    after each strided conv), then the z-compressing conv_out to 128 (port of
    dfu3d_tpu/models/sparse_backbone.py VoxelBackBone8x, the reference's
    spconv_backbone.VoxelBackBone8x). 12 sparse convs; stage caps as
    VoxelResBackBone8x's."""

    GLOBAL_BATCH = True

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 16, 32, 64, 64), out_channels: int = 128):
        super().__init__(grid, voxel_cap)
        ch = tuple(channels)
        self.conv_input = SparseConvBlock(in_channels, ch[0])
        self.conv1 = SparseConvBlock(ch[0], ch[1])
        for s in range(2, 5):
            self.add_module(f"down{s}", SparseConv3dDown(ch[s - 1], ch[s], self.caps[s - 2]))
            self.add_module(f"down{s}_bn", SparseBatchNorm(ch[s]))
            self.add_module(f"conv{s}a", SparseConvBlock(ch[s], ch[s]))
            self.add_module(f"conv{s}b", SparseConvBlock(ch[s], ch[s]))
        self.conv_out = SparseConv3dDown(ch[4], out_channels, self.caps[2], z_only=True)
        self.conv_out_bn = SparseBatchNorm(out_channels)

    def forward(self, features, levels) -> SparseTensor:
        lv = levels[0]
        st = SparseTensor(features, lv.coords, lv.valid, lv.grid)
        st = self.conv1(self.conv_input(st, lv.subm_nbr), lv.subm_nbr)
        for s in range(2, 5):
            st = self.down_bn_relu(f"down{s}", st, levels[s - 1])
            nbr = levels[s - 1].subm_nbr
            st = getattr(self, f"conv{s}b")(getattr(self, f"conv{s}a")(st, nbr), nbr)
        return self.down_bn_relu("conv_out", st, levels[4])


class SparseEncoder(_Backbone8x):
    """VoxelBackBone8x's stage layout with one submanifold block per stride
    (port of dfu3d_tpu/models/sparse_backbone.py SparseEncoder, the trunk of
    the JAX package's VoxelRCNN and PVRCNN): conv_in and conv1 at stride 1,
    then per stride 2, 4, 8 a strided conv with no BN after it (down{s})
    and one refine block (down{s}_refine), then conv_out, z-compressing,
    with no BN either. 9 sparse convs. `forward` returns the conv_out tensor
    and the four stages [s1, s2, s4, s8]."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 16, 32, 64, 64), out_channels: int = 128):
        super().__init__(grid, voxel_cap)
        ch = tuple(channels)
        self.conv_in = SparseConvBlock(in_channels, ch[0])
        self.conv1 = SparseConvBlock(ch[0], ch[1])
        for s in range(2, 5):
            self.add_module(f"down{s}", SparseConv3dDown(ch[s - 1], ch[s], self.caps[s - 2]))
            self.add_module(f"down{s}_refine", SparseConvBlock(ch[s], ch[s]))
        self.conv_out = SparseConv3dDown(ch[4], out_channels, self.caps[2], z_only=True)

    def forward(self, features, levels):
        lv = levels[0]
        st = SparseTensor(features, lv.coords, lv.valid, lv.grid)
        st = self.conv1(self.conv_in(st, lv.subm_nbr), lv.subm_nbr)
        stages = [st]
        for s in range(2, 5):
            st = getattr(self, f"down{s}")(st, levels[s - 1])
            st = getattr(self, f"down{s}_refine")(st, levels[s - 1].subm_nbr)
            stages.append(st)
        return self.conv_out(st, levels[4]), stages


class VoxelResBackBone8xVoxelNeXt(nn.Module):
    """The VoxelNeXt residual encoder (port of dfu3d_tpu/models/
    sparse_backbone.py VoxelResBackBone8xVoxelNeXt, reference
    spconv_backbone_voxelnext.py:69-200): conv_input and two residual
    blocks at stride 1, then five stages at strides 2, 4, 8, 16, 32, each a
    strided (k, k, k) conv (k from SPCONV_KERNEL_SIZES, the last size
    repeated), its BN and ReLU (down{s}, down{s}_bn) and two residual
    blocks (res{s}a, res{s}b). Stage i takes channels[min(i + 1, 4)] and caps
    its set at voxel_cap / 2 ... / 32 (at least 16). 31 sparse convs;
    `forward` returns the stride-8, 16 and 32 tensors."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128, 128),
                 kernel_sizes: Sequence[int] = (3, 3, 3, 3)):
        super().__init__()
        self.grid = grid
        self.voxel_cap = voxel_cap
        self.caps = [max(voxel_cap // d, 16) for d in (2, 4, 8, 16, 32)]
        ch, ks = tuple(channels), tuple(kernel_sizes)
        self.conv_input = SparseConvBlock(in_channels, ch[0])
        self.res1a = SparseResBlock(ch[0])
        self.res1b = SparseResBlock(ch[0])
        cin = ch[0]
        for i in range(5):
            c, k = ch[min(i + 1, len(ch) - 1)], ks[min(i, len(ks) - 1)]
            self.add_module(f"down{i + 2}", SparseConv3dDown(cin, c, self.caps[i], (k, k, k)))
            self.add_module(f"down{i + 2}_bn", SparseBatchNorm(c))
            self.add_module(f"res{i + 2}a", SparseResBlock(c))
            self.add_module(f"res{i + 2}b", SparseResBlock(c))
            cin = c
        self.out_channels = cin

    @property
    def out_grid(self) -> SparseGrid:
        """The stride-8 grid, onto which the detector maps all three outputs."""
        return self.grid.down().down().down()

    def plan(self, coords, valid, num_unique, transpose: bool = False) -> Tuple[Level, ...]:
        """The six coordinate sets (input, strides 2 ... 32), each with its
        3 × 3 × 3 submanifold table and, but the input, the table of the
        strided conv that makes it; with `transpose` (training) also that
        conv's transpose table."""
        offsets = kernel_offsets(3, 3, 3)
        grid = self.grid
        lookup = build_lookup(grid, coords, valid)
        levels = [Level(grid, coords, valid, num_unique, None,
                        find_neighbors(grid, coords, valid, *lookup, offsets))]
        for i in range(5):
            conv = getattr(self, f"down{i + 2}")
            nxt = conv.plan(grid, coords, valid, lookup)
            out_lookup = build_lookup(nxt.grid, nxt.coords, nxt.valid)
            nxt = nxt._replace(subm_nbr=find_neighbors(nxt.grid, nxt.coords, nxt.valid,
                                                       *out_lookup, offsets))
            if transpose:
                nxt = nxt._replace(down_tnbr=conv.transpose_table(coords, valid, nxt, out_lookup))
            levels.append(nxt)
            grid, coords, valid, lookup = nxt.grid, nxt.coords, nxt.valid, out_lookup
        return tuple(levels)

    def forward(self, features, levels):
        lv = levels[0]
        st = SparseTensor(features, lv.coords, lv.valid, lv.grid)
        st = self.conv_input(st, lv.subm_nbr)
        st = self.res1b(self.res1a(st, lv.subm_nbr), lv.subm_nbr)
        outs = []
        for i in range(5):
            name, level = f"down{i + 2}", levels[i + 1]
            st = getattr(self, name)(st, level)
            x = F.relu(getattr(self, f"{name}_bn")(st.features, st.valid))
            st = st._replace(features=torch.where(st.valid[..., None], x, 0))
            nbr = level.subm_nbr
            st = getattr(self, f"res{i + 2}b")(getattr(self, f"res{i + 2}a")(st, nbr), nbr)
            if i >= 2:
                outs.append(st)
        return tuple(outs)


def voxel_centers_of(st: SparseTensor, point_cloud_range, base_voxel_size, stride: int):
    """World-frame centres (B, V, 3) fp32 of a sparse tensor's voxels at
    `stride` times the base voxel size: (coords + 0.5) · size + range
    minimum, in JAX's order of operations."""
    dev = st.coords.device
    vs = torch.tensor(base_voxel_size, dtype=torch.float32, device=dev) * stride
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    return (st.coords.float() + 0.5) * vs + lo


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
