"""PointNet++ ops (port of dfu3d_tpu/core/pointnet2.py:18-154): farthest point
sampling, ball query, grouping, 3-NN interpolation and PV-RCNN++'s vector
pool.

Every op takes a leading batch dimension (the JAX ops handle one frame and
are vmapped) and keeps the JAX ops' masked semantics exactly: invalid points
never win a sample or a neighbour slot, and every gather index is in range.
Squared distances are sum((a - b)²) in fp32, the three squares added in
order, as JAX computes them; an expanded ‖a‖² + ‖b‖² - 2ab rounds otherwise
and would flip a point on a radius boundary or an FPS argmax. The ops are
elementwise and reductions, so bf16 autocast leaves them in fp32;
`vector_pool` turns autocast off for its one product.
"""
from __future__ import annotations

import torch

_BIG = 1e9


def _sq_dist(a, b):
    """a (B, M, 3), b (B, N, 3) → (B, M, N) fp32: (dx² + dy²) + dz² of a - b."""
    a, b = a.float(), b.float()
    d2 = None
    for k in range(3):
        t = a[:, :, None, k] - b[:, None, :, k]
        t = t.mul_(t)
        d2 = t if d2 is None else d2.add_(t)
    return d2


def farthest_point_sample(xyz, valid, npoint: int):
    """Iterative farthest-point sampling.

    xyz (B, N, 3), valid (B, N) bool → (B, npoint) int64 indices. Each
    problem starts at its first valid point (argmax of `valid`); invalid
    points sit at distance -1e9, so they are never picked while a valid one
    is left. With fewer valid points than `npoint` the loop goes on picking
    the first point at distance 0 (torch.argmax, like jnp.argmax, returns the
    first of equal maxima), so `valid` gathered at the result marks those
    repeats valid, as in JAX."""
    xyz = xyz.float()
    big = torch.full((), _BIG, dtype=torch.float32, device=xyz.device)
    neg_big = -big
    dists = torch.where(valid, big, neg_big)
    last = torch.argmax(valid.to(torch.uint8), dim=-1, keepdim=True)  # (B, 1)
    idxs = [last]
    for _ in range(1, npoint):
        d = xyz - torch.gather(xyz, 1, last[..., None].expand(-1, -1, 3))
        d = d.mul_(d)
        d = d[..., 0] + d[..., 1] + d[..., 2]
        dists = torch.minimum(dists, torch.where(valid, d, neg_big))
        last = torch.argmax(dists, dim=-1, keepdim=True)
        idxs.append(last)
    return torch.cat(idxs, dim=1)


def ball_query(radius: float, nsample: int, xyz, xyz_valid, new_xyz, new_valid):
    """Up to `nsample` points within `radius` of each centre.

    xyz (B, N, 3), xyz_valid (B, N), new_xyz (B, M, 3), new_valid (B, M) →
    idx (B, M, nsample) int64, has_neighbor (B, M) bool. A point is a hit
    when d² <= radius² (fp32, boundary included); the hits fill the slots in
    index order (the 1-based rank of each hit in its row), hits past
    `nsample` are dropped, empty slots repeat the first hit, and a centre
    with no hit gets index 0 and has_neighbor False."""
    d2 = _sq_dist(new_xyz, xyz)
    thresh = torch.full((), radius * radius, dtype=torch.float32, device=d2.device)
    within = (d2 <= thresh) & xyz_valid[:, None, :] & new_valid[:, :, None]
    del d2
    rank = torch.cumsum(within, dim=-1, dtype=torch.int32)
    del within
    counts = rank[..., -1]
    # the slot-s hit is the first position whose rank reaches s + 1
    want = torch.arange(1, nsample + 1, dtype=torch.int32, device=rank.device)
    pos = torch.searchsorted(rank, want.expand(*rank.shape[:-1], nsample).contiguous())
    first = torch.where(counts > 0, pos[..., 0], 0)
    filled = torch.clamp(counts, max=nsample)[..., None]
    in_slot = torch.arange(nsample, device=rank.device) < filled
    idx = torch.where(in_slot, pos, first[..., None])
    return idx, counts > 0


def group_points(features, idx):
    """Gather: features (B, N, C), idx (B, M, K) → (B, M, K, C)."""
    rows = torch.arange(features.shape[0], device=features.device)
    return features[rows.view(-1, *([1] * (idx.dim() - 1))), idx]


def three_nn(unknown, unknown_valid, known, known_valid):
    """The 3 nearest valid known points of each unknown point.

    unknown (B, M, 3), known (B, N, 3) → dist (B, M, 3) = sqrt(max(d², 1e-12)),
    idx (B, M, 3) int64, nearest first and, among equal distances, the lower
    index first (jax.lax.top_k's order): three passes of a first-index
    argmin, each masking the point it took. `unknown_valid` is unused, as in
    JAX (invalid rows get neighbours all the same)."""
    d2 = _sq_dist(unknown, known)
    d2.masked_fill_(~known_valid[:, None, :], _BIG)
    vals, idxs = [], []
    for k in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        vals.append(d2.gather(-1, i))
        idxs.append(i)
        if k < 2:
            d2.scatter_(-1, i, float("inf"))
    dist = torch.sqrt(torch.clamp(torch.cat(vals, dim=-1), min=1e-12))
    return dist, torch.cat(idxs, dim=-1)


def three_interpolate(features, idx, dist):
    """Inverse-squared-distance weighted sum of 3 neighbours' features:
    features (B, N, C), idx and dist (B, M, 3) → (B, M, C)."""
    w = 1.0 / torch.clamp(dist * dist, min=1e-8)
    w = w / (w[..., 0] + w[..., 1] + w[..., 2])[..., None]
    g = group_points(features, idx)  # (B, M, 3, C)
    return (g[..., 0, :] * w[..., 0, None] + g[..., 1, :] * w[..., 1, None]
            + g[..., 2, :] * w[..., 2, None])


def vector_pool(queries, q_valid, xyz, xyz_valid, feats, radius: float, nsample: int,
                bins=(3, 3, 3)):
    """VectorPool aggregation (the JAX package's vector_pool, the
    reference's pointnet2_stack vector_pool_gpu with avg pooling): each
    query's cube of half-extent `radius` is split into bins = (nx, ny, nz)
    sub-voxels, the ball query's neighbours are averaged per sub-voxel, and
    the output is the flattened per-bin [mean Δxyz, mean features].

    queries (B, M, 3), q_valid (B, M), xyz (B, N, 3), xyz_valid (B, N),
    feats (B, N, C) or None → (B, M, nx·ny·nz·(3 + C)) fp32, has_neighbor
    (B, M). A slot counts when its point lies within the radius, its query
    has a neighbour, and it is not one of the ball query's repeats of slot 0
    (a true neighbour's index differs from slot 0's). The bin of each axis
    is trunc(rel · n) clipped to [0, n - 1], rel = (Δ + radius) / 2 radius;
    bin ids run x slowest. The per-bin sums are a one-hot product in fp32,
    as JAX's einsum; its summation order differs from XLA's by rounding."""
    nx, ny, nz = (int(v) for v in bins)
    nbins = nx * ny * nz
    idx, has = ball_query(radius, nsample, xyz, xyz_valid, queries, q_valid)
    with torch.autocast(queries.device.type, enabled=False):
        grouped_xyz = group_points(xyz.float(), idx) - queries.float()[:, :, None, :]
        sq = grouped_xyz * grouped_xyz
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        thresh = torch.full((), radius * radius, dtype=torch.float32, device=d2.device)
        slot_ok = (d2 <= thresh) & has[..., None]
        first_dup = idx[..., 1:] != idx[..., :1]
        slot_ok[..., 1:] &= first_dup
        rel = (grouped_xyz + radius) / (2.0 * radius)
        cells = []
        for axis, n in enumerate((nx, ny, nz)):
            cells.append(torch.clamp((rel[..., axis] * n).to(torch.int32), 0, n - 1))
        bin_id = (cells[0] * ny + cells[1]) * nz + cells[2]
        bin_id = torch.where(slot_ok, bin_id, nbins).long()
        # (B, M, S, nbins + 1): the last column takes the slots that count nowhere
        onehot = torch.zeros(*bin_id.shape, nbins + 1, dtype=torch.float32,
                             device=bin_id.device)
        onehot.scatter_(-1, bin_id[..., None], 1.0)
        onehot = onehot[..., :nbins]
        payload = grouped_xyz
        if feats is not None:
            payload = torch.cat([grouped_xyz, group_points(feats, idx).float()], dim=-1)
        b, m, s = idx.shape
        sums = torch.bmm(onehot.reshape(b * m, s, nbins).transpose(1, 2),
                         payload.reshape(b * m, s, -1))
        counts = onehot.sum(dim=2).reshape(b * m, nbins, 1)
        means = sums / torch.clamp(counts, min=1.0)
    return means.reshape(b, m, -1), has
