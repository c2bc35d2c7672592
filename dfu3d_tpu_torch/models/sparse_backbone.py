"""Sparse 3D backbone, eval forward: VoxelResBackBone8x and
height_compression (port of dfu3d_tpu/models/sparse_backbone.py:58-93,
:530-685, :749-765, :890-972).

Every sparse conv is one call of the gather-GEMM kernel B2
(`core/voxel/gather_gemm_kernel.gather_gemm`) over an element neighbour table
(B, Q, K). The coordinate sets and tables depend on the voxel coordinates
only, so `VoxelResBackBone8x.plan` builds them all first, one sort per
coordinate set, shared by every conv that reads that set (the spconv
indice_key reuse of JAX's `stage_tables`); `forward` then runs the convs.

The JAX package runs its 3×3×3 convs in the grouped packed-row form and its
z-only conv_out in the element form; its tests hold the two forms equal
(tests/test_sparse_vjp.py TestGroupedSubm), and the element form is what B2
computes. Module and parameter names follow the flax tree
(backbone_3d.res1a.conv1.kernel, down2_bn, conv_input.SubMConv3d_0, ...).
Like the flax modules, which cast to their compute dtype, a conv casts its
features and weight to the autocast dtype itself: autocast does not reach a
ctypes kernel.
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
)
from .vfe import MaskedBatchNorm

# BN over active voxels; in eval it is the running-statistics affine map in
# fp32 with eps 1e-3 and a cast back, which MaskedBatchNorm already is
SparseBatchNorm = MaskedBatchNorm


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


def _sparse_conv(features, valid, nbr, kernel, out_valid):
    """B2 over `nbr` in the autocast dtype (else the features' own), the
    output re-masked by the output set's valid."""
    dev = features.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else features.dtype
    out = gather_gemm_kernel.gather_gemm(features.to(dtype).contiguous(), valid, nbr,
                                         kernel.to(dtype).contiguous())
    return torch.where(out_valid[..., None], out, 0)


class SubMConv3d(nn.Module):
    """Submanifold sparse conv: output set == input set."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        k = kernel_size[0] * kernel_size[1] * kernel_size[2]
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))

    def forward(self, st: SparseTensor, nbr) -> SparseTensor:
        return st._replace(
            features=_sparse_conv(st.features, st.valid, nbr, self.kernel, st.valid))


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

    def forward(self, st: SparseTensor, out: Level) -> SparseTensor:
        feats = _sparse_conv(st.features, st.valid, out.down_nbr, self.kernel, out.valid)
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

    def plan(self, coords, valid, num_unique) -> Tuple[Level, ...]:
        """The five coordinate sets (input, strides 2, 4, 8, conv_out) and
        their neighbour tables, from the voxelizer's coords (B, V, 3)."""
        offsets = kernel_offsets(3, 3, 3)
        levels = []
        grid = self.grid
        down_nbr = None
        for i in range(4):
            lookup = build_lookup(grid, coords, valid)
            subm = find_neighbors(grid, coords, valid, *lookup, offsets)
            levels.append(Level(grid, coords, valid, num_unique, down_nbr, subm))
            conv = getattr(self, f"down{i + 2}") if i < 3 else self.conv_out
            nxt = conv.plan(grid, coords, valid, lookup)
            grid, coords, valid = nxt.grid, nxt.coords, nxt.valid
            num_unique, down_nbr = nxt.num_unique, nxt.down_nbr
        levels.append(nxt)
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
