"""Pairwise rotated-BEV overlap: the CUDA kernel, its wrapper and its plain twin.

The kernel (csrc/iou_bev.cu) replaces the TPU kernel
dfu3d_tpu/core/geometry/iou_pallas.py::_overlap_kernel and computes what
dfu3d_tpu/core/geometry/iou.py::pairwise_overlap_bev computes, centring each
pair on its own midpoint. It culls the pairs whose bounding boxes are more
than CULL_MARGIN apart (they are exactly 0; `overlap_bev_cull_plain` is the
predicate's plain twin) and runs the full clip, 686 operations plus 15 per
surviving clipped edge, only for the others (see the source).

`overlap_bev` takes a CPU tensor to the plain PyTorch version and a CUDA
tensor to the kernel; on the card it launches or raises, with no fallback.
The library is built at first use with nvcc for sm_90a into
dfu3d_tpu_torch/csrc_build/ and loaded with ctypes (`cuda_build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "iou_bev.cu"
NVCC_FLAGS = ("--fmad=false",)  # each operation rounds as in the plain twin
OPS_PER_PAIR = 686         # fp32 operations of one pair's full clip, data-independent part
OPS_PER_LIVE_EDGE = 15     # added for each clipped edge that survives
OPS_PER_PAIR_CULL = 0      # a culled pair: 4 compares, and compares are not counted
CULL_MARGIN = 1e-2         # m; bounding boxes farther apart than this are culled
COORD_LIMIT = 1024.0       # m; a box with a corner beyond this is never culled
MIN_EDGE2 = 1e-4           # m²; a box with a shorter edge is never culled (unless a point)
POINT, QUAD = 1, 2         # box kinds of the cull; 0 is never culled

_EPS = 1e-9
_TOL = 1e-6

launches = 0  # kernel launches since the last reset; read by chip_smoke.py
_fn = None


# ---------------------------------------------------------------------------
# Plain version: line-by-line twin of dfu3d_tpu/core/geometry/iou.py:32-98.
# ---------------------------------------------------------------------------

def _edge_contributions(poly_p, poly_q, boundary_shift):
    """Signed Green's-theorem contribution of poly_p's edges clipped inside
    poly_q; both (..., 4, 2) CCW quads → (...,)."""
    p = poly_p
    q = torch.roll(poly_p, -1, dims=-2)

    e1 = poly_q
    e2 = torch.roll(poly_q, -1, dims=-2)
    d = e2 - e1
    inv_len = torch.rsqrt(torch.clamp(d[..., 0] ** 2 + d[..., 1] ** 2, min=_EPS))

    def sides(pts):
        rel_x = pts[..., :, None, 0] - e1[..., None, :, 0]
        rel_y = pts[..., :, None, 1] - e1[..., None, :, 1]
        s = d[..., None, :, 0] * rel_y - d[..., None, :, 1] * rel_x
        return s * inv_len[..., None, :] + boundary_shift

    sp = sides(p)
    sq = sides(q)

    den = sp - sq
    den = torch.where(den.abs() < _EPS, _EPS, den)
    t_cross = sp / den

    p_in = sp >= 0.0
    q_in = sq >= 0.0
    t_lo_k = torch.where(~p_in & q_in, t_cross, 0.0)
    t_hi_k = torch.where(p_in & ~q_in, t_cross, 1.0)
    empty_k = ~p_in & ~q_in
    t_lo = torch.where(empty_k, 1.0, t_lo_k).amax(dim=-1)
    t_hi = torch.where(empty_k, 0.0, t_hi_k).amin(dim=-1)
    live = t_hi > t_lo

    seg = q - p
    px = p[..., 0] + seg[..., 0] * t_lo
    py = p[..., 1] + seg[..., 1] * t_lo
    qx = p[..., 0] + seg[..., 0] * t_hi
    qy = p[..., 1] + seg[..., 1] * t_hi
    contrib = 0.5 * (px * qy - qx * py)
    return torch.where(live, contrib, 0.0).sum(dim=-1)


def _quad_intersection_area(corners_a, corners_b):
    """Intersection area of CCW quads: (..., 4, 2) × (..., 4, 2) → (...,)."""
    mid = (corners_a.mean(dim=-2, keepdim=True) + corners_b.mean(dim=-2, keepdim=True)) * 0.5
    ca = corners_a - mid
    cb = corners_b - mid
    area = _edge_contributions(ca, cb, +_TOL) + _edge_contributions(cb, ca, -_TOL)
    return torch.clamp(area, min=0.0)


def overlap_bev_plain(corners_a, corners_b, chunk_pairs: int = 1 << 20):
    """(G, N, 4, 2) × (G, M, 4, 2) → (G, N, M), in chunks of about
    `chunk_pairs` pairs so the (…, 4, 4) intermediates stay small."""
    g, n, m = corners_a.shape[0], corners_a.shape[1], corners_b.shape[1]
    out = corners_a.new_empty((g, n, m))
    if out.numel() == 0:
        return out
    if n * m <= chunk_pairs:
        step = chunk_pairs // (n * m)
        for g0 in range(0, g, step):
            out[g0:g0 + step] = _quad_intersection_area(
                corners_a[g0:g0 + step, :, None], corners_b[g0:g0 + step, None])
    else:
        rows = max(1, chunk_pairs // m)
        for gi in range(g):
            for r0 in range(0, n, rows):
                out[gi, r0:r0 + rows] = _quad_intersection_area(
                    corners_a[gi, r0:r0 + rows, None], corners_b[gi, None])
    return out


def _box_kind(corners):
    """(..., 4, 2) → (...,) kind, as the kernel's box_kind: POINT (four equal
    finite corners), QUAD (finite, within COORD_LIMIT, convex and
    counter-clockwise, every edge ≥ 1 cm, every corner between 30° and
    150°) or 0. Same fp32 operations as the kernel."""
    x, y = corners[..., 0], corners[..., 1]
    in_range = ((x.abs() <= COORD_LIMIT) & (y.abs() <= COORD_LIMIT)).all(dim=-1)
    point = ((x == x[..., :1]) & (y == y[..., :1])).all(dim=-1)
    ex = torch.roll(x, -1, dims=-1) - x
    ey = torch.roll(y, -1, dims=-1) - y
    len2 = ex * ex + ey * ey
    ex1, ey1, len2_1 = (torch.roll(t, -1, dims=-1) for t in (ex, ey, len2))
    cross = ex * ey1 - ey * ex1
    quad = ((len2 >= MIN_EDGE2) & (cross > 0.0) & (4.0 * cross * cross >= len2 * len2_1)).all(dim=-1)
    kind = torch.where(point, POINT, torch.where(quad, QUAD, 0))
    return torch.where(in_range, kind, 0)


def _bounds(corners, kind, margin):
    """AABB (lo_x, hi_x, lo_y, hi_y) widened by `margin`, NaN where kind is 0."""
    x, y = corners[..., 0], corners[..., 1]
    nan = torch.tensor(float("nan"), dtype=corners.dtype, device=corners.device)
    return tuple(torch.where(kind > 0, v, nan) for v in (
        x.amin(dim=-1) - margin, x.amax(dim=-1) + margin,
        y.amin(dim=-1) - margin, y.amax(dim=-1) + margin))


def overlap_bev_cull_plain(corners_a, corners_b, margin: float = CULL_MARGIN):
    """(G, N, 4, 2) × (G, M, 4, 2) → (G, N, M) bool: the pairs the kernel
    culls and sets to exactly 0. A pair is culled when A's bounding box,
    widened by `margin`, and B's are apart in x or y, and A is a point or
    both boxes are quads (`_box_kind`); a box of kind 0 gets NaN bounds, so
    a pair with a non-finite corner is never culled. Used by the tests and
    chip_smoke.py; the wrapper never calls it."""
    kind_a, kind_b = _box_kind(corners_a), _box_kind(corners_b)
    alx, ahx, aly, ahy = (v[..., :, None] for v in _bounds(corners_a, kind_a, margin))
    blx, bhx, bly, bhy = (v[..., None, :] for v in _bounds(corners_b, kind_b, 0.0))
    apart = (ahx < blx) | (bhx < alx) | (ahy < bly) | (bhy < aly)
    return apart & ((kind_a == POINT)[..., :, None] | (kind_b == QUAD)[..., None, :])


# ---------------------------------------------------------------------------
# Build and bind.
# ---------------------------------------------------------------------------

def _kernel():
    global _fn
    if _fn is None:
        _fn = cuda_build.load(SOURCE, NVCC_FLAGS, "dfu3d_overlap_bev",
                              [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def _check(corners_a, corners_b):
    for name, t in (("corners_a", corners_a), ("corners_b", corners_b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or tuple(t.shape[2:]) != (4, 2):
            raise ValueError(f"{name} must be (G, N, 4, 2), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if corners_a.device != corners_b.device:
        raise ValueError(f"corners on {corners_a.device} and {corners_b.device}")
    if corners_a.shape[0] != corners_b.shape[0]:
        raise ValueError("corners_a and corners_b differ in their leading dim")


def overlap_bev(corners_a, corners_b):
    """Rotated-BEV intersection area of every pair, per problem g:
    (G, N, 4, 2) × (G, M, 4, 2) fp32 CCW corners → (G, N, M) fp32."""
    global launches
    _check(corners_a, corners_b)
    dev = corners_a.device
    if dev.type == "cpu":
        return overlap_bev_plain(corners_a, corners_b)
    if dev.type != "cuda":
        raise ValueError(f"overlap_bev runs on cpu or cuda, not {dev}")
    g, n, m = corners_a.shape[0], corners_a.shape[1], corners_b.shape[1]
    out = torch.empty((g, n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    for name, t in (("corners_a", corners_a), ("corners_b", corners_b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             "reads a box as two 16-byte loads)")
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(corners_a.data_ptr(), corners_b.data_ptr(), out.data_ptr(), g, n, m,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"iou_bev kernel launch failed with CUDA error {rc}")
    launches += 1
    return out
