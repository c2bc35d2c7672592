"""Rotated NMS with fixed-size outputs (port of dfu3d_tpu/core/geometry/nms.py).

The JAX functions handle one problem and are vmapped; here every function
takes a leading batch of problems, so all NMS problems of an eval step share
one IoU kernel launch.
"""
from __future__ import annotations

import torch

from .iou import pairwise_iou_bev

_NEG_INF = -1e9


def top_k(x, k: int):
    """`jax.lax.top_k` over the last axis: descending, and among equal values
    the lower index first (a stable sort; `torch.topk` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppression_scan_reference(iou_mat, valid, thresh):
    """Greedy keep-scan, literal sequential form (slow; the test oracle).

    keep[i] = valid[i] and no kept j < i with iou[j, i] > thresh.
    iou_mat (…, n, n), valid (…, n) → keep (…, n).
    """
    n = iou_mat.shape[-1]
    over = iou_mat > thresh
    idx = torch.arange(n, device=iou_mat.device)
    keep = valid.clone()
    for i in range(n):
        suppressed = (over[..., :, i] & keep & (idx < i)).any(dim=-1)
        keep[..., i] = keep[..., i] & ~suppressed
    return keep


def _suppression_scan(iou_mat, valid, thresh):
    """Greedy keep-scan by alternating fixed-point iteration (nms.py:41-72).

    f(keep)[i] = valid[i] & ¬∃ j<i : over[j,i] & keep[j] is antitone, so
    iterating f∘f from `valid` and from f(valid) squeezes the greedy result
    between an upper and a lower bound; they meet after about the depth of
    the suppression chains. Each step costs one host sync to test for
    convergence. Batched problems iterate together; one that has converged
    stays at its fixed point. Returns (keep, iterations).
    """
    n = iou_mat.shape[-1]
    idx = torch.arange(n, device=iou_mat.device)
    over_tri = (iou_mat > thresh) & (idx[:, None] < idx[None, :])

    def f(keep):
        sup = (over_tri & keep[..., :, None]).any(dim=-2)
        return valid & ~sup

    u, l = valid, f(valid)
    t = 0
    while t < n and bool((u != l).any()):
        u, l = f(f(u)), f(f(l))
        t += 1
    return u, t


def nms_bev(boxes, scores, thresh: float, pre_max: int, post_max: int, valid=None):
    """Rotated-BEV NMS over a batch of problems.

    Args:
        boxes: (G, N, 7) lidar boxes.
        scores: (G, N).
        thresh: IoU threshold; a box is suppressed by iou > thresh (strict).
        pre_max: boxes entering NMS after the score sort.
        post_max: most boxes returned.
        valid: optional (G, N) bool mask of live boxes.
    Returns:
        (indices, keep): (G, post_max) int64 indices into `boxes` ordered by
        descending score, and (G, post_max) bool; invalid slots point at 0.
    """
    n = boxes.shape[-2]
    pre_max = min(pre_max, n)
    post_max = min(post_max, pre_max)

    if valid is not None:
        scores = torch.where(valid, scores, _NEG_INF)
    top_scores, order = top_k(scores, pre_max)
    live = top_scores > _NEG_INF / 2

    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    iou = pairwise_iou_bev(b, b)
    keep, _ = _suppression_scan(iou, live, thresh)

    kept_scores = torch.where(keep, top_scores, _NEG_INF)
    sel_scores, sel_pos = top_k(kept_scores, post_max)
    sel_valid = sel_scores > _NEG_INF / 2
    sel_indices = torch.where(sel_valid, torch.gather(order, -1, sel_pos), 0)
    return sel_indices, sel_valid


def circle_nms(boxes, scores, min_radius: float, post_max: int, valid=None):
    """Distance-based NMS over a batch of problems (JAX circle_nms,
    nms.py:194-215; reference centernet_utils.circle_nms): every live box in
    descending score order (the full top-K order), a box suppressed by a
    kept higher-scoring one whose BEV centre lies closer than `min_radius`
    (d² < r², strict), then the top `post_max` of the kept scores. Launches
    no overlap kernel.

    boxes (G, N, 7+), scores (G, N), valid optional (G, N) →
    (indices (G, min(post_max, N)) int64, keep (G, min(post_max, N)) bool),
    as `nms_bev` returns them."""
    n = boxes.shape[-2]
    post_max = min(post_max, n)
    if valid is not None:
        scores = torch.where(valid, scores, _NEG_INF)
    top_scores, order = top_k(scores, n)
    live = top_scores > _NEG_INF / 2
    xy = torch.gather(boxes[..., 0:2].float(), -2, order[..., None].expand(*order.shape, 2))
    d2 = ((xy[..., :, None, :] - xy[..., None, :, :]) ** 2).sum(dim=-1)
    r = torch.tensor(min_radius, dtype=torch.float32, device=boxes.device)
    near = torch.where(d2 < r * r, 1.0, 0.0)
    keep, _ = _suppression_scan(near, live, 0.5)
    kept_scores = torch.where(keep, top_scores, _NEG_INF)
    sel_scores, sel_pos = top_k(kept_scores, post_max)
    sel_valid = sel_scores > _NEG_INF / 2
    sel_indices = torch.where(sel_valid, torch.gather(order, -1, sel_pos), 0)
    return sel_indices, sel_valid
