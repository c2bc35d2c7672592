"""TransFusionHead, the query-based BEV detection head (port of
dfu3d_tpu/models/transfusion_head.py; reference pcdet
dense_heads/transfusion_head.py and model_utils/transfusion_utils.py).

    shared_conv (3x3) → heat-map conv + BN + ReLU → hm_out (3x3): the dense
    heat map; its detached sigmoid, masked to interior local maxima, gives
    the top-Q (class, cell) queries over the class-major flatten; the
    queries are the shared conv's features at their cells plus a class
    encoding; one post-norm decoder layer (self-attention over the queries,
    cross-attention to every BEV cell, FFN) with learned position
    embeddings added to q, k and v; per-branch Linear [→ BN → ReLU] stacks.

Cells are y-major everywhere (cell = y · W + x), query positions the cell
centres (x + 0.5, y + 0.5), as in the JAX package's aligned layout. The
attention is flax's MultiHeadDotProductAttention: separate q / k / v
projections, the query divided by sqrt(head dim) before the product, a
softmax over the keys, one output projection; it runs as
`F.scaled_dot_product_attention`, so no (B, heads, Q, H·W) score tensor is
stored. Module names follow the flax tree (dense_head.shared_conv, hm_bn,
self_posembed.dense_0, cross_attn.query, norm2, linear1, center_conv0,
heatmap_out, ...).

Training matches each frame's queries to its gt on a detached cost: the
Hungarian assignment (`hungarian_match`, numpy on the host, one copy to the
host per step) or the greedy one (`greedy_match`, on the device).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry.nms import top_k
from .backbone_2d import BatchNorm
from .center_head import gaussian_radius


# --------------------------------------------------------------------------
# assignment
# --------------------------------------------------------------------------

def _augmenting_path(cost, u, v, path, row4col, spc, i, sr, sc):
    """One shortest augmenting path from row `i` (Crouse 2016, as scipy's
    rectangular_lsap.cpp runs it: the remaining columns kept in its order,
    ties broken as it breaks them). Returns (sink column, its path cost)."""
    nc = cost.shape[1]
    remaining = np.arange(nc - 1, -1, -1)
    num_remaining = nc
    min_val = 0.0
    sr[:] = False
    sc[:] = False
    spc[:] = np.inf
    while True:
        sr[i] = True
        rem = remaining[:num_remaining]
        r = min_val + cost[i, rem] - u[i] - v[rem]
        better = r < spc[rem]
        path[rem[better]] = i
        spc[rem[better]] = r[better]
        vals = spc[rem]
        lowest = vals.min()
        if lowest == np.inf:
            raise ValueError("cost matrix is infeasible")
        at_min = np.flatnonzero(vals == lowest)
        free = at_min[row4col[rem[at_min]] == -1]
        # the C loop's pick: the last unassigned column at the minimum, else the first
        index = free[-1] if len(free) else at_min[0]
        min_val = lowest
        j = remaining[index]
        sc[j] = True
        num_remaining -= 1
        remaining[index] = remaining[num_remaining]
        if row4col[j] == -1:
            return j, min_val
        i = row4col[j]


def linear_sum_assignment(cost):
    """The minimum-cost assignment of a rectangular cost matrix (numpy),
    as scipy.optimize.linear_sum_assignment returns it: (row indices
    ascending, their columns)."""
    cost = np.asarray(cost, np.float64)
    if cost.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    transpose = cost.shape[1] < cost.shape[0]
    if transpose:
        cost = cost.T
    if np.isnan(cost).any() or (cost == -np.inf).any():
        raise ValueError("cost matrix holds NaN or -inf")
    nr, nc = cost.shape
    u, v = np.zeros(nr), np.zeros(nc)
    spc = np.empty(nc)
    path = np.full(nc, -1, np.int64)
    col4row = np.full(nr, -1, np.int64)
    row4col = np.full(nc, -1, np.int64)
    sr, sc = np.zeros(nr, bool), np.zeros(nc, bool)
    for cur in range(nr):
        sink, min_val = _augmenting_path(cost, u, v, path, row4col, spc, cur, sr, sc)
        u[cur] += min_val
        rows = np.flatnonzero(sr)
        rows = rows[rows != cur]
        u[rows] += min_val - spc[col4row[rows]]
        v[sc] -= min_val - spc[sc]
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur:
                break
    if transpose:
        order = np.argsort(col4row, kind="stable")
        return col4row[order], order
    return np.arange(nr), col4row


def hungarian_match(cost, gt_valid):
    """Per frame, the Hungarian assignment of queries to valid gt (JAX's
    `_solve`: the valid columns only). cost (B, Q, M), gt_valid (B, M) →
    (B, Q) int64 gt index per query, -1 where unmatched, on cost's device.
    Solved on the host in float64: one copy of the cost to the host."""
    cost_np = cost.detach().double().cpu().numpy()
    valid_np = gt_valid.detach().cpu().numpy().astype(bool)
    out = np.full(cost_np.shape[:2], -1, np.int64)
    for b in range(cost_np.shape[0]):
        cols = np.flatnonzero(valid_np[b])
        if len(cols):
            rows, cc = linear_sum_assignment(cost_np[b][:, cols])
            out[b, rows] = cols[cc]
    return torch.from_numpy(out).to(cost.device)


def greedy_match(cost, gt_valid):
    """Per frame, repeatedly the cheapest (query, gt) pair left, first index
    among ties, min(Q, M) rounds, on the device (JAX `greedy_match`).
    cost (B, Q, M), gt_valid (B, M) → (B, Q) int64 gt index or -1."""
    b, q, m = cost.shape
    big = 1e9
    c = torch.where(gt_valid[:, None, :], cost.detach(), big)
    assign = torch.full((b, q), -1, dtype=torch.int64, device=cost.device)
    rows = torch.arange(b, device=cost.device)
    for _ in range(min(q, m)):
        flat = c.reshape(b, q * m).argmin(dim=1)
        qi, mi = flat // m, flat % m
        take = c[rows, qi, mi] < big / 2
        assign[rows, qi] = torch.where(take, mi, assign[rows, qi])
        c[rows, qi, :] = torch.where(take[:, None], big, c[rows, qi, :])
        c[rows, :, mi] = torch.where(take[:, None], big, c[rows, :, mi])
    return assign


# --------------------------------------------------------------------------
# targets
# --------------------------------------------------------------------------

def gaussian_heatmap_targets(gt_boxes, gt_valid, num_class: int, feature_map_size,
                             point_cloud_range, voxel_size, feature_map_stride,
                             gaussian_overlap: float = 0.1, min_radius: int = 2):
    """Dense gaussian heat-map targets (B, H, W, num_class), all classes in
    one map (JAX center_head.gaussian_heatmap_targets): box centres
    truncated to their cell, the class id clipped to [0, num_class], per
    class the max over boxes of one (B, M, H, W) outer product."""
    h, w = feature_map_size
    dev = gt_boxes.device
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    stride = float(feature_map_stride)
    gt_boxes = gt_boxes.float()
    cls_id = torch.clamp(gt_boxes[..., -1].to(torch.int32), 0, num_class)
    coord_x = torch.clamp((gt_boxes[..., 0] - pcr[0]) / vs[0] / stride, 0.0, w - 0.5)
    coord_y = torch.clamp((gt_boxes[..., 1] - pcr[1]) / vs[1] / stride, 0.0, h - 0.5)
    cx, cy = coord_x.to(torch.int32), coord_y.to(torch.int32)
    dx = gt_boxes[..., 3] / vs[0] / stride
    dy = gt_boxes[..., 4] / vs[1] / stride
    radius = torch.clamp(gaussian_radius(dx, dy, gaussian_overlap).to(torch.int32),
                         min=min_radius)
    live = gt_valid & (dx > 0) & (dy > 0) & (cls_id > 0)
    off_y = torch.arange(h, dtype=torch.int32, device=dev)[None, None, :] - cy[..., None]
    off_x = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :] - cx[..., None]
    sigma = (2.0 * radius.float() + 1.0) / 6.0
    inv = 1.0 / (2.0 * sigma * sigma)
    g_y = torch.exp(-(off_y.float() ** 2) * inv[..., None])
    g_x = torch.exp(-(off_x.float() ** 2) * inv[..., None])
    g_y = torch.where((off_y.abs() <= radius[..., None]) & live[..., None], g_y, 0.0)
    g_x = torch.where(off_x.abs() <= radius[..., None], g_x, 0.0)
    maps = []
    for c in range(num_class):
        gy = torch.where((cls_id == c + 1)[..., None], g_y, 0.0)
        maps.append((gy[..., :, None] * g_x[..., None, :]).amax(dim=1))
    return torch.stack(maps, dim=-1)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def _token_bn(bn, x):
    """BatchNorm over the tokens of x (B, N, C)."""
    b, n, c = x.shape
    return bn(x.reshape(b * n, c)).reshape(b, n, c)


class PositionEmbeddingLearned(nn.Module):
    """Linear(2 → C) → BN → ReLU → Linear(C → C) on raw cell coordinates
    (transfusion_utils.py:10-26)."""

    def __init__(self, channels: int, keep: float = 0.9):
        super().__init__()
        self.dense_0 = nn.Linear(2, channels)
        self.bn = BatchNorm(channels, eps=1e-5, keep=keep)
        self.dense_1 = nn.Linear(channels, channels)

    def forward(self, xy):
        return self.dense_1(F.relu(_token_bn(self.bn, self.dense_0(xy))))


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention with qkv and out features = C: the
    query, key and value projections (flax kernels (C, H, D) as Linear
    weights (H·D, C)), the query divided by sqrt(D), softmax(q·kᵀ) over the
    keys, then the output projection (flax kernel (H, D, C) as (C, H·D))."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, q, k, v):
        b, nq, c = q.shape
        h = self.num_heads
        d = c // h

        def heads(x):
            return x.view(b, x.shape[1], h, d).transpose(1, 2)

        qh = heads(self.query(q))
        qh = qh / torch.tensor(math.sqrt(d), dtype=qh.dtype, device=qh.device)
        o = F.scaled_dot_product_attention(qh, heads(self.key(k)), heads(self.value(v)),
                                           scale=1.0)
        return self.out(o.transpose(1, 2).reshape(b, nq, c))


class LayerNorm(nn.Module):
    """flax LayerNorm(epsilon=1e-5) on the fp32 input: mean and E[x²] -
    mean² (clamped at 0) over the last axis; the result cast back to the
    input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def _fp32_linear(linear, x):
    """A Linear applied in its weights' dtype (fp32) to the input cast to
    it, also under autocast (a flax Dense with dtype float32)."""
    with torch.autocast(x.device.type, enabled=False):
        return linear(x.to(linear.weight.dtype))


class TransFusionHead(nn.Module):
    """config (JAX TransFusion): NUM_PROPOSALS, HIDDEN_CHANNEL, NUM_HEADS,
    FFN_CHANNEL, NUM_HM_CONV, NMS_KERNEL_SIZE, 'vel' in HEAD_ORDER,
    TARGET_ASSIGNER_CONFIG.DATASET / FEATURE_MAP_STRIDE,
    USE_BIAS_BEFORE_NORM, BN_MOMENTUM, MATCHER (hungarian | greedy; auto
    is the Hungarian). DROPOUT and the POST_PROCESSING NMS are not read, as
    in the JAX package."""

    def __init__(self, in_channels: int, num_class: int, point_cloud_range: Sequence[float],
                 voxel_size: Sequence[float], num_proposals: int = 200, hidden: int = 128,
                 num_heads: int = 8, ffn_channel: int = 256, head_channels: int = 64,
                 num_conv: int = 2, num_hm_conv: int = 2, use_vel: bool = False,
                 nms_kernel_size: int = 3, dataset_name: str = "nuScenes",
                 use_bias_before_norm: bool = False, keep: float = 0.9,
                 feature_map_stride: int = 8, matcher: str = "auto"):
        super().__init__()
        if matcher not in ("auto", "hungarian", "greedy"):
            raise ValueError(f"MATCHER must be auto, hungarian or greedy, got {matcher!r}")
        self.num_class = num_class
        self.num_proposals = num_proposals
        self.hidden = hidden
        self.nms_kernel_size = nms_kernel_size
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.feature_map_stride = feature_map_stride
        self.matcher = "greedy" if matcher == "greedy" else "hungarian"
        if dataset_name == "nuScenes" and num_class > 9:
            self.small_classes = (8, 9)     # pedestrian and traffic cone
        elif dataset_name == "Waymo" and num_class > 2:
            self.small_classes = (1, 2)     # pedestrian and cyclist
        else:
            self.small_classes = ()
        self.shared_conv = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.hm_conv = nn.Conv2d(hidden, hidden, 3, padding=1, bias=use_bias_before_norm)
        self.hm_bn = BatchNorm(hidden, eps=1e-5, keep=keep)
        self.hm_out = nn.Conv2d(hidden, num_class, 3, padding=1)
        self.class_encoding = nn.Linear(num_class, hidden)
        self.self_posembed = PositionEmbeddingLearned(hidden, keep)
        self.cross_posembed = PositionEmbeddingLearned(hidden, keep)
        self.self_attn = MultiHeadAttention(hidden, num_heads)
        self.cross_attn = MultiHeadAttention(hidden, num_heads)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(hidden) for _ in range(3))
        self.linear1 = nn.Linear(hidden, ffn_channel)
        self.linear2 = nn.Linear(ffn_channel, hidden)
        self.branches = [("center", 2, num_conv), ("height", 1, num_conv), ("dim", 3, num_conv),
                         ("rot", 2, num_conv)]
        if use_vel:
            self.branches.append(("vel", 2, num_conv))
        self.branches.append(("heatmap", num_class, num_hm_conv))
        for name, ch, nc in self.branches:
            for i in range(nc - 1):
                self.add_module(f"{name}_conv{i}",
                                nn.Linear(head_channels if i else hidden, head_channels,
                                          bias=use_bias_before_norm))
                self.add_module(f"{name}_bn{i}", BatchNorm(head_channels, eps=1e-5, keep=keep))
            self.add_module(f"{name}_out",
                            nn.Linear(head_channels if nc > 1 else hidden, ch))

    def local_max(self, hm):
        """Interior local maxima of hm (B, C, H, W): a VALID max pool pasted
        into zeros (the borders stay 0), the small classes at kernel 1
        (their own values)."""
        k = self.nms_kernel_size
        pad = k // 2
        h, w = hm.shape[2:]
        out = torch.zeros_like(hm)
        out[:, :, pad:h - pad, pad:w - pad] = F.max_pool2d(hm, k, stride=1)
        for c in self.small_classes:
            out[:, c] = hm[:, c]
        return out

    def branch(self, name, num_conv, z):
        """Linear [→ BN → ReLU] × (num_conv - 1) → the fp32 out Linear."""
        for i in range(num_conv - 1):
            z = F.relu(_token_bn(getattr(self, f"{name}_bn{i}"),
                                 getattr(self, f"{name}_conv{i}")(z)))
        return _fp32_linear(getattr(self, f"{name}_out"), z)

    def heatmap(self, bev):
        """bev (B, H, W, C) → (the shared conv's output, NCHW view of NHWC;
        the dense heat map (B, num_class, H, W) fp32)."""
        x = self.shared_conv(bev.permute(0, 3, 1, 2))
        hmx = F.relu(self.hm_bn(self.hm_conv(x)))
        with torch.autocast(x.device.type, enabled=False):
            return x, self.hm_out(hmx.float())

    def init_queries(self, x, dense_heatmap):
        """The top-Q (class, cell) of the detached, local-max-masked sigmoid
        heat map over its class-major flatten (index class · H·W + cell),
        ties to the lower index as jax.lax.top_k: (the masked heat map, the
        flattened features (B, H·W, C), q_cls, q_cell, the queries (the
        features at their cells plus the class encoding), bev_pos (H·W, 2),
        q_pos (B, Q, 2))."""
        b, _, h, w = dense_heatmap.shape
        hw = h * w
        hm = torch.sigmoid(dense_heatmap.detach())
        hm = hm * (hm == self.local_max(hm))
        _, top = top_k(hm.reshape(b, self.num_class * hw), self.num_proposals)
        q_cls, q_cell = top // hw, top % hw
        feat_flat = x.permute(0, 2, 3, 1).reshape(b, hw, self.hidden)
        q_feat = torch.gather(feat_flat, 1, q_cell[..., None].expand(-1, -1, self.hidden))
        query = q_feat + self.class_encoding(F.one_hot(q_cls, self.num_class).float())
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                                torch.arange(w, dtype=torch.float32, device=x.device),
                                indexing="ij")
        bev_pos = torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(hw, 2)
        return hm, feat_flat, q_cls, q_cell, query, bev_pos, bev_pos[q_cell]

    def decoder(self, query, q_pos, feat_flat, bev_pos):
        """The post-norm decoder layer: self-attention over the queries,
        cross-attention to every cell, FFN; the learned position embeddings
        added to q, k and v."""
        qpe = self.self_posembed(q_pos)
        kpe = self.cross_posembed(bev_pos[None].expand(feat_flat.shape[0], -1, 2))
        qp = query + qpe
        query = self.norm1(query + self.self_attn(qp, qp, qp))
        kv = feat_flat + kpe
        query = self.norm2(query + self.cross_attn(query + qpe, kv, kv))
        return self.norm3(query + self.linear2(F.relu(self.linear1(query))))

    def forward(self, bev) -> Dict[str, torch.Tensor]:
        """bev (B, H, W, C) → the per-query predictions: dense_heatmap (B, H,
        W, num_class) fp32, q_pos (B, Q, 2), q_cls and q_cell (B, Q), the
        branches (B, Q, c) fp32 (center in absolute cells) and
        query_heatmap_score (B, Q, num_class)."""
        x, dense_heatmap = self.heatmap(bev)
        hm, feat_flat, q_cls, q_cell, query, bev_pos, q_pos = self.init_queries(x, dense_heatmap)
        query = self.decoder(query, q_pos, feat_flat, bev_pos)
        out = {name: self.branch(name, nc, query) for name, _, nc in self.branches}
        out["center"] = out["center"] + q_pos
        b, c, h, w = hm.shape
        hm_cells = hm.permute(0, 2, 3, 1).reshape(b, h * w, c)
        out.update(
            dense_heatmap=dense_heatmap.permute(0, 2, 3, 1), q_pos=q_pos, q_cls=q_cls,
            q_cell=q_cell,
            query_heatmap_score=torch.gather(hm_cells, 1, q_cell[..., None].expand(-1, -1, c)))
        return out

    def _grid_scale(self, device):
        pcr = torch.tensor(self.point_cloud_range, dtype=torch.float32, device=device)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=device)
        return pcr[:2], vs[:2] * self.feature_map_stride

    def decode(self, preds):
        """Per-query predictions → boxes (B, Q, 7, or 9 with the velocity),
        scores (B, Q) and 1-based labels (B, Q) (reference get_bboxes +
        decode_bbox): score = sigmoid(heatmap) · query score · one-hot of
        the query's class, label its first maximal class."""
        origin, cell = self._grid_scale(preds["center"].device)
        xy = preds["center"] * cell + origin
        dims = torch.exp(torch.clamp(preds["dim"], -5.0, 5.0))
        angle = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1])
        parts = [xy, preds["height"], dims, angle[..., None]]
        if "vel" in preds:
            parts.append(preds["vel"])
        boxes = torch.cat(parts, dim=-1)
        one_hot = F.one_hot(preds["q_cls"].long(), self.num_class).float()
        scores = torch.sigmoid(preds["heatmap"]) * preds["query_heatmap_score"] * one_hot
        return boxes, scores.amax(dim=-1), torch.argmax(scores, dim=-1) + 1

    def match_cost(self, boxes, cls_logits, gt_boxes, gt_valid):
        """The assignment cost (B, Q, M): 0.25 · centre distance + 0.25 · L1
        of the log dims + 0.15 · (1 - p of the gt's class); 1e6 at invalid
        gt."""
        d_center = torch.sqrt(((boxes[:, :, None, :2] - gt_boxes[:, None, :, :2]) ** 2).sum(-1))
        d_dim = (torch.log(torch.clamp(boxes[:, :, None, 3:6], min=1e-3))
                 - torch.log(torch.clamp(gt_boxes[:, None, :, 3:6], min=1e-3))).abs().sum(-1)
        p = torch.sigmoid(cls_logits)                                   # (B, Q, C)
        gt_cls = torch.clamp(gt_boxes[..., -1].to(torch.int64) - 1, 0, self.num_class - 1)
        p_gt = torch.gather(p, 2, gt_cls[:, None, :].expand(-1, p.shape[1], -1))
        cost = 0.25 * d_center + 0.25 * d_dim + 0.15 * (1.0 - p_gt)
        return torch.where(gt_valid[:, None, :], cost, 1e6)

    def match(self, cost, gt_valid):
        fn = greedy_match if self.matcher == "greedy" else hungarian_match
        return fn(cost.detach(), gt_valid)

    def heatmap_targets(self, gt_boxes, gt_valid, feature_map_size):
        return gaussian_heatmap_targets(gt_boxes, gt_valid, self.num_class, feature_map_size,
                                        self.point_cloud_range, self.voxel_size,
                                        self.feature_map_stride)

    def loss(self, preds, gt_boxes, gt_valid, loss_weights=None):
        """(total, {tf_cls_loss, tf_reg_loss, tf_hm_loss}) (JAX
        TransFusionHead.loss): the focal cls over all queries with matched
        ones → their gt's class, normalised by max(#matched, 1); the L1 reg
        on [cells xy, z, log dims, sin, cos(, vel)] with code_weights over
        the matched; the dense heat map's gaussian focal with positives at
        t > 0.999; weighted cls 1, bbox 0.25, hm 1 by default."""
        lw = dict(loss_weights or {})
        gt_boxes = gt_boxes.float()
        boxes, _, _ = self.decode(preds)
        cost = self.match_cost(boxes, preds["heatmap"], gt_boxes, gt_valid)
        match = self.match(cost, gt_valid)                            # (B, Q)
        matched = match >= 0
        n_matched = torch.clamp(matched.sum().float(), min=1.0)
        gt_m = torch.gather(gt_boxes, 1, torch.clamp(match, min=0)[..., None].expand(
            -1, -1, gt_boxes.shape[-1]))

        gt_cls = torch.clamp(gt_m[..., -1].to(torch.int64) - 1, 0, self.num_class - 1)
        onehot = F.one_hot(gt_cls, self.num_class).float() * matched[..., None]
        logits = preds["heatmap"]
        p = torch.sigmoid(logits)
        alpha, gamma = 0.25, 2.0
        pt = onehot * p + (1 - onehot) * (1 - p)
        af = onehot * alpha + (1 - onehot) * (1 - alpha)
        bce = torch.clamp(logits, min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
        cls_loss = (af * ((1 - pt) ** gamma) * bce).sum() / n_matched

        origin, cell = self._grid_scale(gt_boxes.device)
        t_parts = [(gt_m[..., :2] - origin) / cell, gt_m[..., 2:3],
                   torch.log(torch.clamp(gt_m[..., 3:6], min=1e-3)),
                   torch.sin(gt_m[..., 6:7]), torch.cos(gt_m[..., 6:7])]
        pred_parts = [preds["center"], preds["height"], preds["dim"], preds["rot"]]
        if "vel" in preds:
            if gt_m.shape[-1] < 10:
                raise ValueError("a 'vel' TransFusion head needs velocity-width (10-column) gt")
            t_parts.append(gt_m[..., 7:9])
            pred_parts.append(preds["vel"])
        t = torch.cat(t_parts, dim=-1)
        cw = lw.get("code_weights")
        cw = (torch.tensor(list(cw), dtype=torch.float32, device=t.device)[:t.shape[-1]]
              if cw is not None else torch.ones(t.shape[-1], device=t.device))
        reg = ((torch.cat(pred_parts, dim=-1) - t).abs() * cw).sum(-1)
        reg_loss = torch.where(matched, reg, 0.0).sum() / n_matched

        hm_t = self.heatmap_targets(gt_boxes, gt_valid, preds["dense_heatmap"].shape[1:3])
        hmp = torch.sigmoid(preds["dense_heatmap"])
        pos = (hm_t > 0.999).float()
        neg_w = (1 - hm_t) ** 4
        eps = 1e-6
        hm_loss = -(pos * ((1 - hmp) ** 2) * torch.log(hmp + eps)
                    + (1 - pos) * neg_w * (hmp ** 2) * torch.log(1 - hmp + eps))
        hm_loss = hm_loss.sum() / torch.clamp(pos.sum(), min=1.0)

        total = (lw.get("cls_weight", 1.0) * cls_loss + lw.get("bbox_weight", 0.25) * reg_loss
                 + lw.get("hm_weight", 1.0) * hm_loss)
        return total, {"tf_cls_loss": cls_loss, "tf_reg_loss": reg_loss, "tf_hm_loss": hm_loss}
