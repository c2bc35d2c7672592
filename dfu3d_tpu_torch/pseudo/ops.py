"""The pseudo-box factory's device programs in PyTorch (port of
dfu3d_tpu/pseudo/ops.py), batched over instances and clusters by leading
dimensions where the JAX package vmaps.

Redesigns of the reference's per-frame CPU loops (SURVEY §3.1,
tools/PENet/dataloaders/my_loader.py + rectangle_fitting/rectangle_fitting.py):

* ground-plane RANSAC (sklearn RANSACRegressor, my_loader.py:448-469) →
  fixed-iteration 3-point hypotheses + least-squares refine. The hypotheses'
  point triples are drawn apart (`sample_ground_triples`, from an explicit
  torch.Generator) so that a caller can inject the JAX package's draws.
* open3d `remove_radius_outlier` (my_loader.py:568-599) → masked pairwise
  neighbour counts.
* `BallQuery` cross-modal gate (my_loader.py:489-494) → masked min-distance.
* adaptive range segmentation (rectangle_fitting.py:161-191) → connected
  components of the R(r) = R0 + Rd·‖p‖ adjacency by min-label propagation.
* L-shape θ-scan (rectangle_fitting.py:113-159) → one (…, Θ, N) projection
  and a masked variance criterion.

Every function computes in fp32 on the device of its inputs. The sums of a
few terms are written out in the JAX package's order, so that its results
repeat on the CPU up to the rounding of the longer reductions.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e9
# label propagation rounds between two host reads of "did anything change"
CHECK_EVERY = 2


def _norm3(p):
    return torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2])


# ---------------------------------------------------------------------------
# Ground plane
# ---------------------------------------------------------------------------

def sample_ground_triples(valid, iters: int = 128, generator=None):
    """(iters, 3) int64 point indices, each uniform over the valid points
    (the JAX package's categorical draw over logits 0 / -1e9, ops.py:47-51),
    drawn on the CPU from `generator` and returned on `valid`'s device."""
    idx = torch.nonzero(valid.cpu()).squeeze(1)
    if not len(idx):
        return torch.zeros((iters, 3), dtype=torch.int64, device=valid.device)
    pick = torch.randint(len(idx), (iters, 3), generator=generator)
    return idx[pick].to(valid.device)


def fit_ground_plane(points, valid, triples, inlier_thresh: float = 0.15):
    """RANSAC plane fit z ≈ ax + by + c over the hypotheses of `triples` →
    plane (4,) [nx, ny, nz, d] with a unit normal pointing up (nz > 0); the
    signed distance of p is dot(p, n) + d (ops.py:32-80). The hypothesis with
    the most inliers wins, the first among equals; a least-squares fit to its
    inliers refines it."""
    pts = points[:, 0:3].float()
    tri = pts[triples]                                        # (iters, 3, 3)
    a, b = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    normal = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                          a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                          a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    norm = _norm3(normal)[:, None]
    normal = normal / torch.clamp(norm, min=1e-9)
    normal = torch.where(normal[:, 2:3] < 0, -normal, normal)
    t0 = tri[:, 0]
    d = -(normal[:, 0] * t0[:, 0] + normal[:, 1] * t0[:, 1] + normal[:, 2] * t0[:, 2])

    dist = torch.abs(pts @ normal.T + d[None, :])            # (n, iters)
    inliers = (dist < inlier_thresh) & valid[:, None]
    # degenerate or steep hypotheses are rejected (ground is near-horizontal)
    ok = (norm[:, 0] > 1e-6) & (normal[:, 2] > 0.7)
    score = torch.where(ok, inliers.sum(0), -1)
    best = torch.argmax(score)

    m = inliers[:, best].float()
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    A = torch.stack([x, y, torch.ones_like(x)], dim=-1) * m[:, None]
    ata = A.T @ A + 1e-6 * torch.eye(3, device=pts.device)
    atb = A.T @ (z * m)
    coef = torch.linalg.solve(ata, atb)                       # (a, b, c)
    w = torch.stack([-coef[0], -coef[1], torch.ones_like(coef[0])])
    nrm = _norm3(w)
    return torch.cat([w / nrm, (-coef[2] / nrm)[None]])


def above_plane(points, plane, offset: float = 0.05):
    """(N, 3+) × (4,) → (N,) bool: strictly above the plane by > offset."""
    return points[:, 0:3] @ plane[0:3] + plane[3] > offset


def plane_and_above(points, valid, triples):
    """The factory's first device program (factory.py:147-151): the ground
    plane and the valid points above it."""
    plane = fit_ground_plane(points, valid, triples)
    return plane, above_plane(points, plane) & valid


# ---------------------------------------------------------------------------
# Noise suppression + cross-modal gate
# ---------------------------------------------------------------------------

def _pair_d2(a, b, dims: int = 3):
    """(…, N, ≥dims) × (…, M, ≥dims) → (…, N, M) squared distances over the
    first `dims` coordinates, one coordinate at a time (no (…, N, M, dims)
    tensor)."""
    d2 = None
    for c in range(dims):
        d = a[..., :, None, c] - b[..., None, :, c]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def radius_outlier_mask(points, valid, radius, min_neighbors: int = 1):
    """Keep points with ≥ min_neighbors OTHER valid points within `radius`
    (per leading index, or a float). The reference's open3d call counts the
    query point itself and is a no-op; the JAX package (ops.py:93-104) and
    this port drop isolated points, its evident intent."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=points.device)[..., None, None]
    within = (_pair_d2(points, points) <= r * r) & valid[..., None, :]
    counts = within.sum(-1) - valid.int()                     # exclude self
    return valid & (counts >= min_neighbors)


def ball_gate_mask(pseudo_points, pseudo_valid, lidar_points, lidar_valid, c: float = 0.1):
    """Keep pseudo points within distance c of any valid LiDAR point
    (reference BallQuery gate, my_loader.py:489-494 + :602-604)."""
    d2 = torch.where(lidar_valid[..., None, :], _pair_d2(pseudo_points, lidar_points), BIG)
    min_d = torch.sqrt(d2.amin(-1))
    return pseudo_valid & (min_d < c) & lidar_valid.any(-1, keepdim=True)


# ---------------------------------------------------------------------------
# Clustering (adaptive range segmentation → connected components)
# ---------------------------------------------------------------------------

def reach(points, valid, r0: float = 3.0, rd: float = 0.001):
    """(…, P, P) bool: valid j lies within R_i = r0 + rd·‖p_i‖ of valid i in
    BEV (the reference's per-point set)."""
    r = r0 + rd * _norm3(points)
    within = _pair_d2(points, points, dims=2) <= (r * r)[..., :, None]
    return within & valid[..., None, :] & valid[..., :, None]


def adjacency(points, valid, r0: float = 3.0, rd: float = 0.001):
    """(…, P, P) bool: i ~ j iff ∃k in the `reach` of both i and j (the
    reference's set construction: clusters merge iff their sets
    intersect). Valid points are their own neighbours.

    The product reach·reachᵀ counts the shared k. Its operands are 0 or 1,
    which bf16 holds exactly, the tensor cores sum them in fp32 (exact below
    2^24 terms), and only `> 0` is read: any rounding of the bf16 result
    keeps a positive count positive. So the bf16 product on the card gives
    exactly the adjacency of the fp32 one."""
    within = reach(points, valid, r0, rd)
    dtype = torch.bfloat16 if within.is_cuda else torch.float32
    r16 = within.to(dtype)
    return (r16 @ r16.transpose(-1, -2)) > 0


def connected_components(points, valid, r0: float = 3.0, rd: float = 0.001, stats=None):
    """(…, P) int64 cluster labels: each valid point gets the smallest index
    of its component in the `adjacency` graph, invalid points get P
    (ops.py:124-157).

    The JAX package iterates min-label sweeps in a while_loop until nothing
    changes. The converged label is a function of the component only, so any
    exact method gives the same labels; here each round is a min sweep over
    the neighbours followed by one pointer jump (label ← label of label,
    which stays in the component and never grows), all leading indices
    together. The host reads "did anything change" once every CHECK_EVERY
    rounds; `stats` (a dict) accumulates "sweeps" and "syncs"."""
    n = points.shape[-2]
    adj = adjacency(points, valid, r0, rd)
    idx = torch.arange(n, device=points.device, dtype=torch.int32)
    labels = torch.where(valid, idx, n)
    pad = torch.full_like(labels[..., :1], n)
    sweeps = syncs = 0
    while True:
        for _ in range(CHECK_EVERY):
            neigh = torch.where(adj, labels[..., None, :], n).amin(-1)
            new = torch.minimum(labels, neigh)
            new = torch.gather(torch.cat([new, pad], -1), -1, new.long())
            changed = new != labels
            labels = new
            sweeps += 1
        syncs += 1
        if not bool(changed.any()):
            break
    if stats is not None:
        stats["sweeps"] = stats.get("sweeps", 0) + sweeps
        stats["syncs"] = stats.get("syncs", 0) + syncs
    return labels.long()


def top_cluster_masks(labels, valid, num_clusters: int, min_pts: int):
    """The `num_clusters` largest clusters as masks (ops.py:236-253): sel
    (…, C, P) bool and counts (…, C), by size, the lower label first among
    equal sizes (lax.top_k's order, kept by a stable descending sort);
    clusters under min_pts get an empty mask and count 0."""
    p = labels.shape[-1]
    counts = torch.zeros(*labels.shape[:-1], p + 1, dtype=torch.int64, device=labels.device)
    counts.scatter_add_(-1, labels, valid.long())
    counts[..., p] = 0
    top_counts, top_labels = torch.sort(counts, dim=-1, descending=True, stable=True)
    top_counts, top_labels = top_counts[..., :num_clusters], top_labels[..., :num_clusters]
    big_enough = top_counts >= min_pts
    sel = labels[..., None, :] == top_labels[..., :, None]
    sel = sel & valid[..., None, :] & big_enough[..., None]
    return sel, torch.where(big_enough, top_counts, 0)


# ---------------------------------------------------------------------------
# L-shape rectangle search
# ---------------------------------------------------------------------------

def theta_grid(dtheta_deg: float = 1.0) -> np.ndarray:
    """The search's θ grid, [0, π/2 − dθ) in steps of dθ, float32: numpy's
    arange in float32, which is what jnp.arange gives for these concrete
    arguments (ops.py:181), bit for bit."""
    dtheta = np.deg2rad(dtheta_deg)
    return np.arange(0.0, np.pi / 2.0 - dtheta, dtheta, dtype=np.float32)


def _masked_var(x, mask):
    cnt = mask.sum(-1)
    mean = (x * mask).sum(-1) / torch.clamp(cnt, min=1.0)
    var = (((x - mean[..., None]) ** 2) * mask).sum(-1) / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, var, 0.0)


def rectangle_costs(x, y, valid, thetas):
    """(…, T) variance criterion of each θ: project onto (e1, e2), split the
    point-to-nearest-edge distances by the nearer edge direction, and score
    −Var(E1) − Var(E2); −1e9 where no point is valid."""
    ct, st = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    xs, ys = x[..., None, :], y[..., None, :]
    c1 = xs * ct + ys * st                                    # (…, T, N)
    c2 = -xs * st + ys * ct
    v = valid[..., None, :]
    big = torch.where(v, 0.0, BIG)
    c1_max = (c1 - big).amax(-1, keepdim=True)
    c1_min = (c1 + big).amin(-1, keepdim=True)
    c2_max = (c2 - big).amax(-1, keepdim=True)
    c2_min = (c2 + big).amin(-1, keepdim=True)
    d1 = torch.minimum(c1_max - c1, c1 - c1_min)
    d2 = torch.minimum(c2_max - c2, c2 - c2_min)
    nearer1 = d1 < d2
    cost = (-_masked_var(d1, (nearer1 & v).float())
            - _masked_var(d2, (~nearer1 & v).float()))
    return torch.where(valid.float().sum(-1, keepdim=True) > 0, cost, -BIG)


def rectangle_search(x, y, valid, dtheta_deg: float = 1.0):
    """Variance-criterion L-shape search (rectangle_fitting.py:113-159;
    ops.py:171-233) over (…, N) points → corners (…, 4, 2) of the best
    rectangle in the reference's calc_rect_contour order, and its θ (…). The
    first θ of the largest cost wins."""
    x, y = x.float(), y.float()
    thetas = torch.from_numpy(theta_grid(dtheta_deg)).to(x.device)
    best = torch.argmax(rectangle_costs(x, y, valid, thetas), dim=-1)
    theta = thetas[best]
    cb, sb = torch.cos(thetas)[best][..., None], torch.sin(thetas)[best][..., None]
    c1 = x * cb + y * sb
    c2 = -x * sb + y * cb
    vbig = torch.where(valid, 0.0, BIG)
    c1_min, c1_max = (c1 + vbig).amin(-1), (c1 - vbig).amax(-1)
    c2_min, c2_max = (c2 + vbig).amin(-1), (c2 - vbig).amax(-1)
    cb, sb = cb[..., 0], sb[..., 0]

    def cross(a1, b1, cc1, a2, b2, cc2):
        den = a1 * b2 - a2 * b1
        den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        return torch.stack([(cc1 * b2 - cc2 * b1) / den, (a1 * cc2 - a2 * cc1) / den], -1)

    # edges in the reference's order: (e1, c1min), (e2, c2min), (e1, c1max), (e2, c2max)
    e1a, e1b, e2a, e2b = cb, sb, -sb, cb
    corners = torch.stack([
        cross(e1a, e1b, c1_min, e2a, e2b, c2_min),
        cross(e2a, e2b, c2_min, e1a, e1b, c1_max),
        cross(e1a, e1b, c1_max, e2a, e2b, c2_max),
        cross(e2a, e2b, c2_max, e1a, e1b, c1_min),
    ], dim=-2)
    return corners, theta


def box_from_corners(corners, max_z, object_class_is_car, ground_z: float = 0.0,
                     z_offset: float = 1.5, size_prior=None, height_prior=None,
                     center_type: str | None = None):
    """A LiDAR box (…, 7) and its ok flag (…) from rectangle corners (…, 4, 2)
    (GenerateAnns semantics, my_loader.py:633-684; ops.py:288-390):
    center = (c0 + c2)/2; z = (max_z + ground_z)/2 − z_offset; h = max_z −
    ground_z; l/w from the edges; heading from the longer edge's slope; a Car
    with aspect > 5 is rejected.

    The cross-dataset knobs (my_loader_KittiPandasetWaymo.py:883-1010):
    size_prior (…, 2) (l, w), ≤ 0 disables, replaces the size when set;
    height_prior (…), applied when the measured height < 1 m, ≤ 0 disables;
    center_type None | 'ori' | 'prior_centerline' | 'prior_linecorner' |
    'prior_center' moves the center with the measured rect and the prior."""
    c0, c1, c2, c3 = corners[..., 0, :], corners[..., 1, :], corners[..., 2, :], corners[..., 3, :]

    def norm2(v):
        return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])

    center = (c0 + c2) / 2.0
    l1, l2 = norm2(c0 - c3), norm2(c0 - c1)
    use_l1 = l1 >= l2
    length = torch.where(use_l1, l1, l2)
    width = torch.where(use_l1, l2, l1)
    slope_num = torch.where(use_l1, c3[..., 1] - c0[..., 1], c1[..., 1] - c0[..., 1])
    slope_den = torch.where(use_l1, c3[..., 0] - c0[..., 0], c1[..., 0] - c0[..., 0]) + 1e-8
    rotation = torch.atan(slope_num / slope_den)
    rotation_cam = -rotation - np.pi / 2
    heading = -(rotation_cam + np.pi / 2)                    # LiDAR heading
    center_z = (max_z + ground_z) / 2.0 - z_offset
    height = max_z - ground_z
    if height_prior is not None:
        hp = torch.as_tensor(height_prior, dtype=torch.float32, device=corners.device)
        height = torch.where((hp > 0) & (height < 1.0), hp, height)
    aspect = torch.maximum(l1, l2) / torch.clamp(torch.minimum(l1, l2), min=1e-6)
    ok = torch.where(torch.as_tensor(object_class_is_car, device=corners.device),
                     aspect <= 5.0, True)

    if size_prior is not None:
        sp = torch.as_tensor(size_prior, dtype=torch.float32, device=corners.device)
        has_prior = (sp > 0).all(-1)
    if center_type in ("prior_centerline", "prior_linecorner", "prior_center"):
        pl, pw = sp[..., 0], sp[..., 1]
        # a "small" fitted rect (the reference's l2 < 1.5 and l1 < 2 gate,
        # short and long swapped in the l1 < l2 branch, :932, :979)
        small = torch.where(use_l1, (l2 < 1.5) & (l1 < 2.0), (l1 < 1.5) & (l2 < 2.0))
        # the slope of the OTHER edge (:938, :986)
        o_num = torch.where(use_l1, c1[..., 1] - c0[..., 1], c3[..., 1] - c0[..., 1])
        o_den = torch.where(use_l1, c1[..., 0] - c0[..., 0], c3[..., 0] - c0[..., 0]) + 1e-8
        rot_o = torch.atan(o_num / o_den)
        if center_type == "prior_centerline":
            # from the short edge's midpoint along (sin r, cos r) by half the
            # prior extent (:930-936, :978-984)
            w_mid = torch.where(use_l1[..., None], (c0 + c1) / 2.0, (c0 + c3) / 2.0)
            step = torch.where(small, pw, pl) / 2.0
            moved = w_mid + step[..., None] * torch.stack(
                [torch.sin(rotation), torch.cos(rotation)], -1)
            center = torch.where(has_prior[..., None], moved, center)
        elif center_type == "prior_linecorner":
            # a small Car rect's center along the other edge's heading by the
            # half size deficit (:937-948, :985-995)
            shift = (pl - length) / 2.0
            moved = center + shift[..., None] * torch.stack([torch.cos(rot_o), torch.sin(rot_o)], -1)
            do = has_prior & small & torch.as_tensor(object_class_is_car, device=corners.device)
            center = torch.where(do[..., None], moved, center)
        else:  # prior_center: a diagonal shift toward the prior box's center
            theta = torch.atan((pw - width) / (pl - length) + 1e-8)
            delta = theta + rot_o
            dist = torch.sqrt(((pl - length) / 2.0) ** 2 + ((pw - width) / 2.0) ** 2)
            moved = center + dist[..., None] * torch.stack([torch.cos(delta), torch.sin(delta)], -1)
            center = torch.where((has_prior & small)[..., None], moved, center)
    if size_prior is not None:
        length = torch.where(has_prior, sp[..., 0], length)
        width = torch.where(has_prior, sp[..., 1], width)

    box = torch.stack([center[..., 0], center[..., 1], center_z, length, width, height,
                       heading], -1)
    return box, ok


def instance_boxes(points, valid, is_car, num_clusters: int, min_pts: int,
                   ground_z: float = 0.0, z_offset: float = 1.5, size_prior=None,
                   height_prior=None, center_type: str | None = None, stats=None):
    """Cluster each instance's points (…, P, 3) and L-shape-fit its clusters
    (ops.py:256-285): connected_components → top_cluster_masks →
    rectangle_search → box_from_corners. is_car (…), size_prior (…, 2),
    height_prior (…). Returns boxes (…, C, 7), ok (…, C), counts (…, C)."""
    labels = connected_components(points, valid, stats=stats)
    sel, counts = top_cluster_masks(labels, valid, num_clusters, min_pts)
    pts = points[..., None, :, :].expand(*sel.shape, points.shape[-1])
    corners, _ = rectangle_search(pts[..., 0], pts[..., 1], sel)
    max_z = torch.where(sel, pts[..., 2], -BIG).amax(-1)
    is_car = torch.as_tensor(is_car, device=points.device)[..., None]
    sp = None if size_prior is None else torch.as_tensor(size_prior, device=points.device)[..., None, :]
    hp = None if height_prior is None else torch.as_tensor(height_prior,
                                                           device=points.device)[..., None]
    boxes, ok = box_from_corners(corners, max_z, is_car, ground_z=ground_z, z_offset=z_offset,
                                 size_prior=sp, height_prior=hp, center_type=center_type)
    return boxes, ok & (counts >= min_pts), counts


def frame_program(obj_lidar, obj_lidar_valid, obj_pseudo, obj_pseudo_valid, radius, is_car,
                  size_prior, height_prior, num_clusters: int, min_pts: int,
                  ball_gate_c: float, ground_z: float = 0.0, z_offset: float = 1.5,
                  center_type: str | None = None, stats=None):
    """All K instances of a frame at once (factory.py:154-204): noise
    suppression → cross-modal gate → the kept LiDAR and pseudo points
    compacted, in order, into one P-slot buffer → clusters → boxes.

    obj_lidar / obj_pseudo (K, P, 3) with masks (K, P); radius (K,); is_car
    (K,) bool; size_prior (K, 2) and height_prior (K,) (≤ 0 disables).
    Returns boxes (K, C, 7), ok (K, C), counts (K, C), n_obj (K,)."""
    p = obj_lidar.shape[1]
    lid_keep = radius_outlier_mask(obj_lidar, obj_lidar_valid, radius)
    pse_keep = radius_outlier_mask(obj_pseudo, obj_pseudo_valid, radius)
    pse_keep = ball_gate_mask(obj_pseudo, pse_keep, obj_lidar, lid_keep, ball_gate_c)
    pts = torch.cat([obj_lidar, obj_pseudo], dim=1)          # (K, 2P, 3)
    keep = torch.cat([lid_keep, pse_keep], dim=1)
    # kept points first, in order (jnp.argsort is stable)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :p]
    pts_c = torch.gather(pts, 1, order[..., None].expand(-1, -1, pts.shape[-1]))
    keep_c = torch.gather(keep, 1, order)
    n_obj = keep.sum(1)
    boxes, ok, counts = instance_boxes(pts_c, keep_c, is_car, num_clusters, min_pts,
                                       ground_z=ground_z, z_offset=z_offset,
                                       size_prior=size_prior, height_prior=height_prior,
                                       center_type=center_type, stats=stats)
    return boxes, ok & (n_obj >= min_pts)[:, None], counts, n_obj
