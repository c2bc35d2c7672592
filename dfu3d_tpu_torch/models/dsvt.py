"""DSVT, the Dynamic Sparse Voxel Transformer trunk (port of
dfu3d_tpu/models/dsvt.py; reference pcdet backbones_3d/dsvt.py), and its
assembly into CenterPoint (`build_dsvt`, `dsvt_bev`):

    DynVoxelVFE → DSVTBackbone (pillars, dsvt_pillar.yaml) or
    DSVTVoxelBackbone (voxels, dsvt_voxel.yaml) → the BEV scatter →
    BaseBEVBackbone → CenterHead at stride 1

Each block runs two encoder layers, the voxels ordered y-major in the first
and x-major in the second (the rotated sets). A layer partitions the
batch's voxels into windows (batch-offset window ids, so one sort covers
the batch), ranks each voxel within its window in the chosen major order,
and cuts each window into sets of SET_SIZE slots; the sets get ids
first-come over the sorted sequence and past B · MAX_SETS they are not
made: the cap is pooled over the batch, so the first frames take the sets
and a later frame may get none (as in the JAX package, dsvt.py:143-147,
:303-306). A voxel outside every set keeps its features through the layer.
Odd blocks use the hybrid-factor-scaled window shifted by half the base
window. The position embedding of a layer follows the layer's index in its
block, not the block's geometry (JAX dsvt.py:183-187, replicated).

Everything is of fixed size: the sets live in a (S · L + 1, C) buffer,
S = B · MAX_SETS, its last row the sentinel that absorbs the voxels outside
any set; every voxel in a set has its own slot, so the scatters are copies
(no atomics) and their backwards gathers. No step of the partition reads a
count back to the host.

The partitions and the voxel model's pools depend only on the coordinates,
so `plan` computes them once per forward (the pillar model's eight layers
share four partitions); `forward` runs the features through them. The
attention is `F.scaled_dot_product_attention` with the query scaled by
head_dim^-1/2 first and an additive mask of -1e9 on the empty slots, as
the JAX package adds it: an empty set then softmaxes uniformly (finite, and
its outputs are zeroed) where a boolean mask would give NaN.

Module names follow the flax tree (backbone_3d.block0_0.q,
block0_0_pos_fc1, res_norm0; stage0_block0_1.ffn2, stage0_reduction.
pos_embedding, ...).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.voxel import VoxelGrid, dynamic_voxelize
from ..core.voxel.sparse_ops import ranks_in_sorted_groups
from ..train import torch_convert
from .transfusion_head import LayerNorm
from .vfe import DynVoxelVFE, MaskedBatchNorm

_BIG = torch.iinfo(torch.int64).max
SET_KEY_CLIP_2D = 64    # sets per window the pillar partition tells apart
SET_KEY_CLIP_3D = 128   # the voxel partition's (12·12·32 / 48 = 96 on the shipped config)


# --------------------------------------------------------------------------
# the set partition
# --------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def assign_sets(win_id, inner, vol: int, valid, set_size: int, cap_sets: int, key_clip: int):
    """The part both partitions share: the valid voxels sorted by (window,
    inner key), each one's rank in its window, its set in the window (rank //
    set_size, clipped at key_clip - 1) and slot (rank % set_size), and set
    ids handed out first-come over the sorted sequence up to `cap_sets`.
    Returns (set_ids (N,) int64, cap_sets outside any set; slot (N,))."""
    order = torch.argsort(torch.where(valid, win_id * vol + inner, _BIG), stable=True)
    valid_sorted = valid[order]
    win_sorted = win_id[order]
    # the valid voxels come first, sorted by window: the JAX package's
    # ingroup_inds of the sorted windows (its stable sort is the identity here)
    rank_sorted = torch.where(valid_sorted,
                              ranks_in_sorted_groups(torch.where(valid_sorted, win_sorted, _BIG)),
                              -1)
    set_in_win = torch.div(rank_sorted, set_size, rounding_mode="floor")
    set_key = win_sorted * key_clip + torch.clamp(set_in_win, 0, key_clip - 1)
    is_start = torch.ones_like(valid_sorted)
    is_start[1:] = set_key[1:] != set_key[:-1]
    is_start &= valid_sorted
    seg = torch.cumsum(is_start.long(), 0) - 1
    # an invalid voxel is in no set (the JAX package's rank >= 0 test)
    seg = torch.where(valid_sorted & (seg < cap_sets), seg, cap_sets)
    set_ids = torch.empty_like(seg)
    set_ids[order] = seg
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted % set_size
    return set_ids, slot


def partition_2d(coords, batch_idx, valid, x_major: bool, window_shape, shift, grid_size,
                 set_size: int, cap_sets: int):
    """The pillar model's window + rotated-set partition (JAX
    DSVTBackbone._partition, dsvt.py:104-148) of a batch-flattened pillar
    list: coords (N, 2) (ix, iy), batch_idx (N,), valid (N,) → (set_ids,
    slot). Windows are numbered y-major per frame, batch-offset; the
    in-window key is x · wy + y (x-major) or y · wx + x."""
    wx, wy = window_shape
    nx, ny = grid_size
    sx = coords[:, 0].long() + shift[0]
    sy = coords[:, 1].long() + shift[1]
    n_win_x, n_win_y = _ceil_div(nx + wx, wx), _ceil_div(ny + wy, wy)
    win_id = batch_idx.long() * (n_win_x * n_win_y) + (sy // wy) * n_win_x + sx // wx
    inx, iny = sx % wx, sy % wy
    inner = inx * wy + iny if x_major else iny * wx + inx
    return assign_sets(win_id, inner, wx * wy, valid, set_size, cap_sets, SET_KEY_CLIP_2D)


def partition_3d(coords, batch_idx, valid, x_major: bool, window_shape, shift, grid_shape,
                 set_size: int, cap_sets: int):
    """The voxel model's (JAX set_partition3d, dsvt.py:258-307): coords (N,
    3) (ix, iy, iz); windows numbered (x · n_win_y + y) · n_win_z + z per
    frame, batch-offset; in-window keys (x · wy + y) · wz + z (x-major) or
    (y · wx + x) · wz + z."""
    wx, wy, wz = window_shape
    nx, ny, nz = grid_shape
    s = [coords[:, i].long() + shift[i] for i in range(3)]
    n_win_x, n_win_y, n_win_z = (_ceil_div(nx + wx, wx), _ceil_div(ny + wy, wy),
                                 _ceil_div(nz + wz, wz))
    win_id = (batch_idx.long() * (n_win_x * n_win_y * n_win_z)
              + ((s[0] // wx) * n_win_y + s[1] // wy) * n_win_z + s[2] // wz)
    inx, iny, inz = s[0] % wx, s[1] % wy, s[2] % wz
    inner = ((inx * wy + iny) if x_major else (iny * wx + inx)) * wz + inz
    return assign_sets(win_id, inner, wx * wy * wz, valid, set_size, cap_sets,
                       SET_KEY_CLIP_3D)


class LayerPlan(NamedTuple):
    """What one encoder layer needs of the coordinates: each voxel's row
    in the (S · L + 1)-row set buffer (S · L where it is in no set), which
    slots hold a voxel, and the position embedding's input (centred
    in-window coordinates of the layer-indexed window)."""

    flat_slot: torch.Tensor   # (N,) int64
    set_mask: torch.Tensor    # (S, L) bool
    pe_in: torch.Tensor       # (N, 2 or 3) float32


def layer_plan(set_ids, slot, pe_in, num_sets: int, set_size: int) -> LayerPlan:
    total = num_sets * set_size
    flat_slot = torch.where((set_ids < num_sets) & (slot < set_size), set_ids * set_size + slot,
                            total)
    mask = torch.zeros(total + 1, dtype=torch.bool, device=flat_slot.device)
    mask[flat_slot] = True
    return LayerPlan(flat_slot, mask[:total].view(num_sets, set_size), pe_in)


def window_coords(coords, window_shape, shift):
    """Centred in-window coordinates ((c + shift) % w - w / 2) of the
    first len(window_shape) axes, fp32."""
    return torch.stack([((coords[:, i].long() + shift[i]) % w).float() - 0.5 * w
                        for i, w in enumerate(window_shape)], dim=-1)


def set_shares(plans, batch_size: int):
    """Per layer, per frame: the share of the frame's valid voxels that sit
    in a set (one host read per layer). `plans`: (LayerPlan, batch ids,
    valid) per layer, as `dsvt_plan` gives them."""
    out = []
    for lp, batch_idx, valid in plans:
        total = lp.set_mask.numel()
        counts = torch.zeros(batch_size, dtype=torch.float64, device=valid.device)
        counts.index_add_(0, batch_idx.long(), valid.double())
        reached = torch.zeros_like(counts)
        reached.index_add_(0, batch_idx.long(), (valid & (lp.flat_slot < total)).double())
        out.append((reached / counts.clamp(min=1)).tolist())
    return out


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

def _split_heads(t, num_heads: int):
    n, length, c = t.shape
    return t.view(n, length, num_heads, c // num_heads).transpose(1, 2)


class SetAttention(nn.Module):
    """DSVT_EncoderLayer + SetAttention (JAX _SetAttention, dsvt.py:32-81):
    q = k = x + pos and v = x, masked MHA, + residual → ln1, FFN (exact
    GELU) + residual → ln2, the encoder layer's outer + identity → ln3;
    empty slots zeroed."""

    def __init__(self, dim: int, num_heads: int, dim_ff: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.ln1 = LayerNorm(dim)
        self.ffn1 = nn.Linear(dim, dim_ff or 2 * dim)
        self.ffn2 = nn.Linear(dim_ff or 2 * dim, dim)
        self.ln2 = LayerNorm(dim)
        self.ln3 = LayerNorm(dim)

    def forward(self, sets, set_mask, pos):
        """sets, pos (S, L, C); set_mask (S, L) → (S, L, C)."""
        return ffn_norms(self, sets, set_attention(self, sets, set_mask, pos), set_mask)


def set_attention(layer: SetAttention, sets, set_mask, pos):
    """The attention of a layer over its sets (q = k = sets + pos, v = sets;
    the query times head_dim^-1/2, an additive -1e9 on the empty slots), its
    output projected."""
    s, length, c = sets.shape
    h = layer.num_heads
    qk_in = sets + pos
    q = _split_heads(layer.q(qk_in), h) * (c // h) ** -0.5
    mask = torch.where(set_mask, 0.0, -1e9)[:, None, None, :].to(q.dtype)
    o = F.scaled_dot_product_attention(q, _split_heads(layer.k(qk_in), h),
                                       _split_heads(layer.v(sets), h), attn_mask=mask, scale=1.0)
    return layer.proj(o.transpose(1, 2).reshape(s, length, c))


def ffn_norms(layer: SetAttention, sets, attn, set_mask):
    y = layer.ln1(sets + attn)
    z = layer.ln2(y + layer.ffn2(F.gelu(layer.ffn1(y), approximate="none")))
    z = layer.ln3(sets + z)
    return torch.where(set_mask[..., None], z, 0.0)


def block_norm(norm: LayerNorm, x, residual, valid):
    """The block's residual + LayerNorm (dsvt.py:123-129 residual_norm)."""
    return torch.where(valid[:, None], norm(x + residual), 0.0)


def position_embedding(fc1, bn, fc2, pe_in, valid):
    """PositionEmbeddingLearned: Linear → MaskedBatchNorm (eps 1e-5, keep
    0.9, over the batch's valid voxels) → ReLU → Linear; the backbone holds
    its modules as <layer>_pos_fc1, _pos_bn and _pos_fc2."""
    return fc2(F.relu(bn(fc1(pe_in), valid)))


def to_sets(x, plan: LayerPlan):
    """(N, C) rows → (S, L, C) sets, zeros in the empty slots."""
    s, length = plan.set_mask.shape
    buf = x.new_zeros((s * length + 1, x.shape[-1])).index_copy(0, plan.flat_slot, x)
    return buf[:s * length].view(s, length, -1)


def from_sets(out_sets, x, plan: LayerPlan, valid):
    """Each voxel in a set takes its slot's output; the others keep x."""
    s, length, c = out_sets.shape
    flat = torch.cat([out_sets.reshape(s * length, c), out_sets.new_zeros((1, c))])
    gathered = flat.index_select(0, plan.flat_slot)
    x = torch.where((plan.flat_slot < s * length)[:, None], gathered, x)
    return torch.where(valid[:, None], x, 0.0)


class _EncoderStack(nn.Module):
    """The layers' modules and the encoder layer both backbones run."""

    def _add_layer(self, name: str, pe_width: int):
        dim = self.dim
        self.add_module(name, SetAttention(dim, self.num_heads, self.dim_ff))
        self.add_module(f"{name}_pos_fc1", nn.Linear(pe_width, dim))
        self.add_module(f"{name}_pos_bn", MaskedBatchNorm(dim, eps=1e-5, keep=0.9))
        self.add_module(f"{name}_pos_fc2", nn.Linear(dim, dim))

    def encoder_layer(self, name: str, x, plan: LayerPlan, valid):
        pe = position_embedding(getattr(self, f"{name}_pos_fc1"),
                                getattr(self, f"{name}_pos_bn"),
                                getattr(self, f"{name}_pos_fc2"), plan.pe_in, valid)
        out = getattr(self, name)(to_sets(x, plan), plan.set_mask, to_sets(pe.to(x.dtype), plan))
        return from_sets(out, x, plan, valid)


class DSVTBackbone(_EncoderStack):
    """The pillar DSVT (JAX DSVTBackbone, dsvt.py:84-255): feats (B, P, dim),
    coords (B, P, 2) BEV cells, valid (B, P) → (B, P, dim)."""

    def __init__(self, dim: int = 128, num_heads: int = 8,
                 num_blocks: int = 4, window_shape: Tuple[int, int] = (12, 12),
                 set_size: int = 36, max_sets: int = 1024,
                 grid_size: Tuple[int, int] = (512, 512),
                 hybrid_factor: Tuple[int, int] = (2, 2), dim_ff: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.dim_ff = dim, num_heads, dim_ff
        self.num_blocks, self.set_size, self.max_sets = num_blocks, set_size, max_sets
        self.grid_size = tuple(grid_size)
        wx, wy = window_shape
        hx, hy = hybrid_factor
        # (window, shift) of the base and the hybrid (shifted) geometry
        self.geoms = (((wx, wy), (0, 0)), ((wx * hx, wy * hy), (wx // 2, wy // 2)))
        for blk in range(num_blocks):
            for li in range(2):
                self._add_layer(f"block{blk}_{li}", 2)
            self.add_module(f"res_norm{blk}", LayerNorm(dim))

    def plan(self, coords, batch_idx, valid, batch_size: int):
        """coords (N, 2), batch ids and valid (N,) of the flattened batch →
        one LayerPlan per layer, blocks in order, y-major then x-major."""
        cap = batch_size * self.max_sets
        made = {}
        for geom in range(min(2, self.num_blocks)):
            wshape, shift = self.geoms[geom]
            for li, x_major in enumerate((False, True)):
                ids, slot = partition_2d(coords, batch_idx, valid, x_major, wshape, shift,
                                         self.grid_size, self.set_size, cap)
                made[geom, li] = layer_plan(ids, slot, window_coords(coords, *self.geoms[li]),
                                            cap, self.set_size)
        return [made[blk % 2, li] for blk in range(self.num_blocks) for li in range(2)]

    def forward(self, feats, coords, valid):
        b, p, _ = feats.shape
        x = feats.reshape(b * p, -1)
        coords, valid = coords.reshape(b * p, 2), valid.reshape(b * p)
        batch_idx = torch.arange(b, device=x.device).repeat_interleave(p)
        plans = iter(self.plan(coords, batch_idx, valid, b))
        for blk in range(self.num_blocks):
            residual = x
            for li in range(2):
                x = self.encoder_layer(f"block{blk}_{li}", x, next(plans), valid)
            x = block_norm(getattr(self, f"res_norm{blk}"), x, residual, valid)
        return x.view(b, p, self.dim)

    def reference_mapping(self):
        return torch_convert.dsvt_mapping(self.num_blocks)


class StageReductionAtt(nn.Module):
    """Stage_ReductionAtt_Block (JAX _StageReductionAtt, dsvt.py:310-345):
    the query is the channel max over a pool's slots (empty ones, zero,
    included), the keys its members plus a learned position, 8-head MHA
    with no mask, out = LN(attn + query). (V, pv, C) → (V, C)."""

    def __init__(self, dim: int, pool_volume: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.pos_embedding = nn.Parameter(torch.empty(pool_volume, dim).normal_(0.0, 0.01))
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm = LayerNorm(dim)

    def forward(self, pooled):
        n, pv, c = pooled.shape
        h = self.num_heads
        query = pooled.amax(dim=1, keepdim=True)
        q = _split_heads(self.q(query), h) * (c // h) ** -0.5
        k = _split_heads(self.k(pooled + self.pos_embedding), h)
        # one query over pv keys per pool, as batched products with the
        # softmax in fp32 (the JAX package's einsums): SDPA's cuDNN path
        # fails on the card at V · 8 = 1.9 M such problems
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), dim=-1)
        o = torch.matmul(w.to(q.dtype), _split_heads(self.v(pooled), h))
        return self.norm(self.proj(o.transpose(1, 2).reshape(n, 1, c)) + query)[:, 0]


class PoolPlan(NamedTuple):
    """A stage's pooling: each voxel's row in the (V · pv + 1)-row pool
    buffer (V · pv where it is invalid), and the pooled voxels' coords,
    batch ids and valid, in sorted first-seen order."""

    flat_index: torch.Tensor  # (N,) int64
    coords: torch.Tensor      # (N, 3) int64
    batch_idx: torch.Tensor   # (N,) int64
    valid: torch.Tensor       # (N,) bool


def pool_plan(coords, batch_idx, valid, stride, grid) -> PoolPlan:
    """Group the voxels by their strided coords (JAX DSVTVoxelBackbone._pool,
    dsvt.py:486-535): one sort of the batch-offset parent keys, the groups
    numbered in key order; each member's slot in its pool is its coords
    modulo the stride."""
    n = coords.shape[0]
    c = coords.long()
    parent = torch.stack([c[:, i] // stride[i] for i in range(3)], dim=-1)
    ng = [_ceil_div(grid[i], stride[i]) for i in range(3)]
    key = (batch_idx.long() * (ng[0] * ng[1] * ng[2])
           + (parent[:, 0] * ng[1] + parent[:, 1]) * ng[2] + parent[:, 2])
    order = torch.argsort(torch.where(valid, key, _BIG), stable=True)
    key_sorted, valid_sorted = key[order], valid[order]
    is_start = torch.ones_like(valid_sorted)
    is_start[1:] = key_sorted[1:] != key_sorted[:-1]
    is_start &= valid_sorted
    seg = torch.cumsum(is_start.long(), 0) - 1
    seg = torch.where(valid_sorted & (seg < n), seg, n)
    pooled_slot = torch.empty_like(seg)
    pooled_slot[order] = seg
    pooled_slot = torch.where(valid, pooled_slot, n)
    dsx, dsy, dsz = stride
    pv = dsx * dsy * dsz
    in_pool = (c[:, 0] % dsx) * (dsy * dsz) + (c[:, 1] % dsy) * dsz + c[:, 2] % dsz
    flat_index = torch.where(pooled_slot < n, pooled_slot * pv + in_pool, n * pv)
    dest = torch.where(is_start, seg, n)
    pooled_coords = c.new_zeros((n + 1, 3)).index_copy(0, dest, parent[order])[:n]
    pooled_batch = c.new_zeros(n + 1).index_copy(0, dest, batch_idx.long()[order])[:n]
    pooled_valid = torch.arange(n, device=c.device) < is_start.sum()
    return PoolPlan(flat_index, pooled_coords, pooled_batch, pooled_valid)


def pool(reduction: StageReductionAtt, x, plan: PoolPlan, pool_volume: int):
    """The voxels of each pool into a zero-filled (V, pv, C) buffer, reduced
    by the attention block; rows past the pooled count zeroed."""
    n, c = x.shape
    buf = x.new_zeros((n * pool_volume + 1, c)).index_copy(0, plan.flat_index, x)
    red = reduction(buf[:n * pool_volume].view(n, pool_volume, c))
    return torch.where(plan.valid[:, None], red, 0.0)


class DSVTVoxelBackbone(_EncoderStack):
    """The multi-stage 3D DSVT (JAX DSVTVoxelBackbone, dsvt.py:348-535):
    per stage its blocks of 3D rotated-set window attention, between stages
    the attention pooling along the downsample stride. The block counter
    runs across stages, so with one block per stage the stages alternate
    base and shifted windows. feats (B, V, dim), coords (B, V, 3), valid
    (B, V) → flat (features (B·V, dim), BEV coords (B·V, 2), batch ids,
    valid) of the last stage."""

    def __init__(self, dim: int = 192, num_heads: int = 8,
                 set_info: Sequence[Tuple[int, int]] = ((48, 1),) * 4,
                 window_shape: Sequence[Tuple[int, int, int]] = (
                     (12, 12, 32), (12, 12, 8), (12, 12, 2), (12, 12, 1)),
                 downsample_stride: Sequence[Tuple[int, int, int]] = (
                     (1, 1, 4), (1, 1, 4), (1, 1, 2)),
                 sparse_shape: Tuple[int, int, int] = (468, 468, 32),
                 hybrid_factor: Tuple[int, int, int] = (2, 2, 1), max_sets: int = 1024,
                 dim_ff: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.dim_ff = dim, num_heads, dim_ff
        self.set_info = tuple(tuple(int(v) for v in si) for si in set_info)
        self.downsample_stride = tuple(tuple(d) for d in downsample_stride)
        self.sparse_shape = tuple(sparse_shape)
        self.max_sets = max_sets
        hx, hy, hz = hybrid_factor
        # per stage, (window, shift) of the base and the hybrid geometry
        self.geoms = []
        for w in window_shape:
            w = tuple(w)
            self.geoms.append(((w, (0, 0, 0)),
                               ((w[0] * hx, w[1] * hy, w[2] * hz), (w[0] // 2, w[1] // 2, 0))))
        for s, (_, num_blocks) in enumerate(self.set_info):
            for blk in range(num_blocks):
                for li in range(2):
                    # the z channel only while the layer-indexed window has depth
                    self._add_layer(f"stage{s}_block{blk}_{li}",
                                    3 if self.geoms[s][li][0][2] > 1 else 2)
                self.add_module(f"stage{s}_res_norm{blk}", LayerNorm(dim))
            if s < len(self.set_info) - 1:
                d = self.downsample_stride[s]
                self.add_module(f"stage{s}_reduction", StageReductionAtt(dim, d[0] * d[1] * d[2]))

    def plan(self, coords, batch_idx, valid, batch_size: int):
        """Per stage, (the LayerPlans of its layers with the stage's
        batch ids and valid, the PoolPlan into the next stage or None)."""
        grid = self.sparse_shape
        cap = batch_size * self.max_sets
        stages, global_blk = [], 0
        for s, (set_size, num_blocks) in enumerate(self.set_info):
            geoms = self.geoms[s]
            layers = []
            for _ in range(num_blocks):
                wshape, shift = geoms[global_blk % 2]
                global_blk += 1
                for li, x_major in enumerate((False, True)):
                    pos_w, pos_shift = geoms[li]
                    pe_in = window_coords(coords, pos_w if pos_w[2] > 1 else pos_w[:2], pos_shift)
                    set_ids, slot = partition_3d(coords, batch_idx, valid, x_major, wshape,
                                                 shift, grid, set_size, cap)
                    layers.append((layer_plan(set_ids, slot, pe_in, cap, set_size), batch_idx,
                                   valid))
            pp = None
            if s < len(self.set_info) - 1:
                stride = self.downsample_stride[s]
                pp = pool_plan(coords, batch_idx, valid, stride, grid)
                coords, batch_idx, valid = pp.coords, pp.batch_idx, pp.valid
                grid = tuple(_ceil_div(grid[i], stride[i]) for i in range(3))
            stages.append((layers, pp))
        return stages

    def forward(self, feats, coords, valid):
        b, p, _ = feats.shape
        x = feats.reshape(b * p, -1)
        coords, valid = coords.reshape(b * p, 3), valid.reshape(b * p)
        batch_idx = torch.arange(b, device=x.device).repeat_interleave(p)
        x = torch.where(valid[:, None], x, 0.0)
        for s, (layers, pp) in enumerate(self.plan(coords, batch_idx, valid, b)):
            layers = iter(layers)
            for blk in range(self.set_info[s][1]):
                residual = x
                for li in range(2):
                    lp, _, valid = next(layers)
                    x = self.encoder_layer(f"stage{s}_block{blk}_{li}", x, lp, valid)
                x = block_norm(getattr(self, f"stage{s}_res_norm{blk}"), x, residual, valid)
            if pp is not None:
                d = self.downsample_stride[s]
                x = pool(getattr(self, f"stage{s}_reduction"), x, pp, d[0] * d[1] * d[2])
                coords, batch_idx, valid = pp.coords, pp.batch_idx, pp.valid
        return x, coords[:, :2], batch_idx, valid

    def reference_mapping(self):
        return torch_convert.dsvt_voxel_mapping(self.set_info)


# --------------------------------------------------------------------------
# the trunk in CenterPoint
# --------------------------------------------------------------------------

def build_dsvt(cfg, grid: VoxelGrid, num_point_features: int, max_voxels: int):
    """(VFE, backbone) of a CenterPoint config whose BACKBONE_3D is DSVT, read
    as the JAX package reads it (detectors.py:53-139): d_model[0],
    nhead[0], dim_feedforward[0], set_info, MAX_SETS and INPUT_LAYER's
    window_shape, hybrid_factor, sparse_shape and downsample_stride; the
    shift is half the base window (shifts_list and normalize_pos are not
    read). The voxel model when there is more than one stage or
    sparse_shape has depth. The VFE's last width must be d_model, as in
    every shipped config (the JAX package's input projection is not
    ported)."""
    vfe_cfg, bb3d = cfg.VFE, cfg.BACKBONE_3D
    if vfe_cfg.NAME not in ("DynamicVoxelVFE", "DynVoxelVFE"):
        raise NotImplementedError(f"VFE {vfe_cfg.NAME} with DSVT (the MeanVFE fallback) "
                                  "is not ported")
    if "set_info" not in bb3d:
        raise NotImplementedError("the DSVT schema of DIM / NUM_BLOCKS / WINDOW_SHAPE is not "
                                  "ported; the set_info schema is")
    vfe = DynVoxelVFE(num_filters=tuple(vfe_cfg.NUM_FILTERS), grid=grid,
                      num_point_features=num_point_features,
                      use_norm=vfe_cfg.get("USE_NORM", True),
                      use_absolute_xyz=vfe_cfg.get("USE_ABSLOTE_XYZ", True),
                      with_distance=vfe_cfg.get("WITH_DISTANCE", False), max_voxels=max_voxels)
    il = bb3d.get("INPUT_LAYER", {})
    stages = [tuple(si) for si in bb3d.set_info]
    windows = [tuple(w) for w in il.get("window_shape", [[12, 12, 1]])]
    hybrid = tuple(il.get("hybrid_factor", [2, 2, 1]))
    nx, ny, nz = grid.grid_size
    sparse = tuple(il.get("sparse_shape", [nx, ny, nz]))
    dim = int(bb3d.d_model[0])
    if vfe.num_filters[-1] != dim:
        raise NotImplementedError(f"DSVT's input projection (VFE width {vfe.num_filters[-1]} "
                                  f"to d_model {dim}) is not ported")
    common = dict(dim=dim, num_heads=int(bb3d.nhead[0]),
                  max_sets=int(bb3d.get("MAX_SETS", 1024)),
                  dim_ff=int(bb3d.get("dim_feedforward", [0])[0]))
    if len(stages) > 1 or sparse[2] > 1:
        backbone = DSVTVoxelBackbone(
            set_info=stages, window_shape=windows,
            downsample_stride=[tuple(d) for d in il.get("downsample_stride", [])],
            sparse_shape=sparse, hybrid_factor=hybrid, **common)
    else:
        backbone = DSVTBackbone(num_blocks=int(stages[0][1]), window_shape=windows[0][:2],
                                set_size=int(stages[0][0]), grid_size=(nx, ny),
                                hybrid_factor=hybrid[:2], **common)
    return vfe, backbone


def scatter_bev(out, bev_xy, batch_idx, valid, batch_size: int, nx: int, ny: int):
    """Voxel features (N, C) to the dense (B, ny, nx, C) BEV at their cells;
    each cell holds one voxel (the sentinel row takes the rest and is cut)."""
    cells = nx * ny
    lin = torch.where(valid, batch_idx.long() * cells + bev_xy[:, 1].long() * nx
                      + bev_xy[:, 0].long(), batch_size * cells)
    dense = out.new_zeros((batch_size * cells + 1, out.shape[-1])).index_copy(0, lin, out)
    return dense[:batch_size * cells].view(batch_size, ny, nx, -1)


def dsvt_bev(vfe, backbone, grid: VoxelGrid, points, points_valid):
    """Points → the DSVT trunk's dense (B, ny, nx, dim) BEV map (JAX
    CenterPoint._features, detectors.py:207-260)."""
    nx, ny, _ = grid.grid_size
    b = points.shape[0]
    feats, coords, valid = vfe(points, points_valid)
    if isinstance(backbone, DSVTVoxelBackbone):
        return scatter_bev(*backbone(feats, coords, valid), b, nx, ny)
    out = backbone(feats, coords[..., :2], valid)
    p = out.shape[1]
    batch_idx = torch.arange(b, device=out.device).repeat_interleave(p)
    return scatter_bev(out.reshape(b * p, -1), coords[..., :2].reshape(b * p, 2), batch_idx,
                       valid.reshape(b * p), b, nx, ny)


def dsvt_plan(vfe, backbone, points, points_valid):
    """The trunk's (LayerPlan, batch ids, valid) per layer, in layer order,
    for `set_shares`: the VFE's voxel coordinates through the backbone's
    plan (no features are computed)."""
    b = points.shape[0]
    vox = dynamic_voxelize(vfe.grid, points, points_valid, vfe.max_voxels)
    p = vox.voxel_coords.shape[1]
    batch_idx = torch.arange(b, device=points.device).repeat_interleave(p)
    coords, valid = vox.voxel_coords.reshape(b * p, 3), vox.voxel_valid.reshape(b * p)
    if isinstance(backbone, DSVTVoxelBackbone):
        return [lp for layers, _ in backbone.plan(coords, batch_idx, valid, b) for lp in layers]
    return [(lp, batch_idx, valid) for lp in backbone.plan(coords[:, :2], batch_idx, valid, b)]
