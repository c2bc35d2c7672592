"""Swin Transformer, BEVFusion's image backbone (port of dfu3d_tpu/models/
image/swin.py; reference pcdet/models/backbones_image/swin.py).

Patch embedding (a stride-p conv and LayerNorm), then per stage its blocks
of window attention with a relative-position bias, the odd blocks on the map
rolled by half a window with the shifted-window mask built on the padded
map, exact-GELU MLPs, PatchMerging between stages ([x00, x10, x01, x11]
concatenated, LayerNorm, a Linear without bias) and a LayerNorm on each
stage in `out_indices`. Maps are NHWC as in the JAX package; LayerNorm is
flax's one-pass formula (`transfusion_head.LayerNorm`). Module names follow
the flax tree (patch_embed, patch_norm, stage{i}_block{j}.attn.qkv,
merge{i}.reduction, out_norm{i}).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..transfusion_head import LayerNorm
from .common import nhwc


def window_partition(x, ws: int):
    """(B, H, W, C) → (B · nH · nW, ws², C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win, ws: int, h: int, w: int):
    """(B · nH · nW, ws², C) → (B, H, W, C)."""
    b = win.shape[0] // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def rel_pos_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws - 1)² bias table of each query-key
    pair of a window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask of the shifted windows on the padded
    (hp, wp) map: -100 between tokens of different regions."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws)[..., 0].numpy()
    return np.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window_size - 1) ** 2, num_heads), std=0.02))
        self.register_buffer("rel_index", torch.from_numpy(rel_pos_index(window_size).reshape(-1)),
                             persistent=False)

    def forward(self, x, mask=None):
        """x (B', n, C) windows, mask (nW, n, n) or None: the logits in fp32
        with the bias and the mask added, softmax, values in x's dtype."""
        bw, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # (B', h, n, d)
        attn = torch.matmul(q * (c // h) ** -0.5, k.transpose(-1, -2)).float()
        bias = self.relative_position_bias_table[self.rel_index].view(n, n, h)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, h, n, n) + mask[None, :, None]).view(bw, h, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks = {}

    def mask(self, hp: int, wp: int, device):
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_mask(hp, wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        ws, sh = self.window_size, self.shift
        y = self.norm1(x).reshape(b, h, w, c)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if sh > 0:
            y = torch.roll(y, (-sh, -sh), dims=(1, 2))
            mask = self.mask(hp, wp, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp, wp)
        if sh > 0:
            y = torch.roll(y, (sh, sh), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + z


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        y = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]],
                      dim=-1)
        h2, w2 = y.shape[1], y.shape[2]
        return self.reduction(self.norm(y.reshape(b, h2 * w2, 4 * c))), h2, w2


class SwinTransformer(nn.Module):
    """IMAGE_BACKBONE: EMBED_DIMS, DEPTHS, NUM_HEADS, WINDOW_SIZE, PATCH_SIZE,
    OUT_INDICES."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 patch_size: int = 4, out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        self.out_channels = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, num_heads[i], window_size, 0 if j % 2 == 0 else window_size // 2))
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", LayerNorm(dim))
                self.out_channels.append(dim)
            if i < len(self.depths) - 1:
                self.add_module(f"merge{i}", PatchMerging(dim))
                dim *= 2

    def run_stage(self, i: int, x, h: int, w: int):
        """Stage i's blocks on the tokens x (B, h · w, C): (its output map
        if i is in out_indices, else None; the tokens merged for the next
        stage and their h, w)."""
        for j in range(self.depths[i]):
            x = getattr(self, f"stage{i}_block{j}")(x, h, w)
        out = None
        if i in self.out_indices:
            y = getattr(self, f"out_norm{i}")(x)
            out = y.reshape(x.shape[0], h, w, y.shape[-1])
        if i < len(self.depths) - 1:
            x, h, w = getattr(self, f"merge{i}")(x, h, w)
        return out, x, h, w

    def forward(self, images):
        """images (B, H, W, 3) → the maps (B, H_i, W_i, C_i) of the stages in
        out_indices."""
        x = nhwc(self.patch_embed, images)
        b, h, w, c = x.shape
        x = self.patch_norm(x.reshape(b, h * w, c))
        outs = []
        for i in range(len(self.depths)):
            out, x, h, w = self.run_stage(i, x, h, w)
            if out is not None:
                outs.append(out)
        return outs
