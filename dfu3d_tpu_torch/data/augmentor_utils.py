"""Point/box augmentation transforms (host-side numpy).

Own copy of dfu3d_tpu/data/augmentor_utils.py, the multimodal image flip
included. Same transform semantics as the reference's augmentor_utils.py
(random world flip/rotation/scaling/translation and their effect on boxes),
expressed as pure functions returning (gt_boxes, points, params) so the
applied transform is recorded.
"""
from __future__ import annotations

import numpy as np


def _rotate_points_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
    out = points.copy()
    out[:, 0:3] = points[:, 0:3] @ rot
    return out


def random_flip_along_x(gt_boxes, points, rng, force=None):
    """Flip y → −y with prob 0.5 (reference augmentor_utils.random_flip_along_x)."""
    enable = rng.choice([False, True]) if force is None else force
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:  # velocity channels
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points, bool(enable)


def random_flip_along_y(gt_boxes, points, rng, force=None):
    enable = rng.choice([False, True]) if force is None else force
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points, bool(enable)


def global_rotation(gt_boxes, points, rot_range, rng, force=None):
    angle = rng.uniform(rot_range[0], rot_range[1]) if force is None else force
    points = _rotate_points_z(points, angle)
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = _rotate_points_z(gt_boxes[:, 0:3], angle)
    gt_boxes[:, 6] += angle
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate(
            [gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1), gt_boxes.dtype)], axis=1
        )
        gt_boxes[:, 7:9] = _rotate_points_z(vel, angle)[:, 0:2]
    return gt_boxes, points, float(angle)


def global_scaling(gt_boxes, points, scale_range, rng, force=None):
    if scale_range[1] - scale_range[0] < 1e-3 and force is None:
        return gt_boxes, points, 1.0
    scale = rng.uniform(scale_range[0], scale_range[1]) if force is None else force
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] *= scale
    return gt_boxes, points, float(scale)


def global_translation(gt_boxes, points, noise_std, rng, force=None):
    offset = (
        np.array(
            [
                rng.normal(0, noise_std[0]),
                rng.normal(0, noise_std[1]),
                rng.normal(0, noise_std[2]),
            ],
            dtype=points.dtype,
        )
        if force is None
        else np.asarray(force, dtype=points.dtype)
    )
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] += offset
    gt_boxes[:, :3] += offset
    return gt_boxes, points, offset


# ---------------------------------------------------------------------------
# Local (per-object) augmentations + frustum dropouts + pyramid augs
# (reference augmentor_utils.py:153-658; vectorized point-in-box masks,
#  per-box host loops only where the reference's semantics are inherently
#  per-box — N ≤ a few hundred boxes)
# ---------------------------------------------------------------------------

def points_in_box_mask(points, box):
    """Axis-heading-aware point-in-box test (reference get_points_in_box)."""
    cx, cy, cz, dx, dy, dz, heading = box[:7]
    sx, sy, sz = points[:, 0] - cx, points[:, 1] - cy, points[:, 2] - cz
    c, s = np.cos(-heading), np.sin(-heading)
    lx = sx * c - sy * s
    ly = sx * s + sy * c
    return (
        (np.abs(sz) <= dz / 2.0)
        & (np.abs(lx) <= dx / 2.0)
        & (np.abs(ly) <= dy / 2.0)
    )


def random_local_translation_along_x(gt_boxes, points, offset_range, rng):
    for idx in range(len(gt_boxes)):
        offset = rng.uniform(offset_range[0], offset_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        points[mask, 0] += offset
        gt_boxes[idx, 0] += offset
    return gt_boxes, points


def random_local_translation_along_y(gt_boxes, points, offset_range, rng):
    for idx in range(len(gt_boxes)):
        offset = rng.uniform(offset_range[0], offset_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        points[mask, 1] += offset
        gt_boxes[idx, 1] += offset
    return gt_boxes, points


def random_local_translation_along_z(gt_boxes, points, offset_range, rng):
    for idx in range(len(gt_boxes)):
        offset = rng.uniform(offset_range[0], offset_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        points[mask, 2] += offset
        gt_boxes[idx, 2] += offset
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range, rng):
    for idx in range(len(gt_boxes)):
        ang = rng.uniform(rot_range[0], rot_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        c, s = np.cos(ang), np.sin(ang)
        ctr = gt_boxes[idx, 0:3].copy()
        rel = points[mask, 0:3] - ctr
        points[mask, 0] = rel[:, 0] * c - rel[:, 1] * s + ctr[0]
        points[mask, 1] = rel[:, 0] * s + rel[:, 1] * c + ctr[1]
        gt_boxes[idx, 6] += ang
    return gt_boxes, points


def local_scaling(gt_boxes, points, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    for idx in range(len(gt_boxes)):
        sc = rng.uniform(scale_range[0], scale_range[1])
        mask = points_in_box_mask(points, gt_boxes[idx])
        ctr = gt_boxes[idx, 0:3]
        points[mask, 0:3] = (points[mask, 0:3] - ctr) * sc + ctr
        gt_boxes[idx, 3:6] *= sc
    return gt_boxes, points


def global_frustum_dropout(gt_boxes, points, intensity_range, direction, rng):
    """Drop everything beyond a threshold along z (top/bottom) or y
    (left/right) — reference global_frustum_dropout_*:219-285."""
    intensity = rng.uniform(intensity_range[0], intensity_range[1])
    axis = 2 if direction in ("top", "bottom") else 1
    lo, hi = points[:, axis].min(), points[:, axis].max()
    if direction in ("top", "left"):
        thr = hi - intensity * (hi - lo)
        pm, bm = points[:, axis] < thr, gt_boxes[:, axis] < thr
    else:
        thr = lo + intensity * (hi - lo)
        pm, bm = points[:, axis] > thr, gt_boxes[:, axis] > thr
    return gt_boxes[bm], points[pm]


def local_frustum_dropout(gt_boxes, points, intensity_range, direction, rng):
    """Per-box frustum dropout (reference local_frustum_dropout_*:369-445)."""
    for idx in range(len(gt_boxes)):
        box = gt_boxes[idx]
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        mask = points_in_box_mask(points, box)
        if direction == "top":
            thr = (box[2] + box[5] / 2) - intensity * box[5]
            drop = mask & (points[:, 2] >= thr)
        elif direction == "bottom":
            thr = (box[2] - box[5] / 2) + intensity * box[5]
            drop = mask & (points[:, 2] <= thr)
        elif direction == "left":
            thr = (box[1] + box[4] / 2) - intensity * box[4]
            drop = mask & (points[:, 1] >= thr)
        else:
            thr = (box[1] - box[4] / 2) + intensity * box[4]
            drop = mask & (points[:, 1] <= thr)
        points = points[~drop]
    return gt_boxes, points


# --- pyramid augmentations (reference :503-658) ---

def get_pyramids(boxes):
    """(N, 7) boxes → (N, 6, 15): apex (box center) + 4 corners per face."""
    from . import np_geometry as npg

    corners = npg.boxes_to_corners_3d(boxes[:, :7])  # (N, 8, 3)
    # faces as corner-index quads (order: front, back, left, right, top, bottom)
    faces = [(0, 1, 5, 4), (2, 3, 7, 6), (0, 3, 7, 4), (1, 2, 6, 5),
             (4, 5, 6, 7), (0, 1, 2, 3)]
    apex = boxes[:, None, 0:3]
    pyr = np.zeros((len(boxes), 6, 5, 3), np.float32)
    for f, quad in enumerate(faces):
        pyr[:, f, 0] = apex[:, 0]
        for k, ci in enumerate(quad):
            pyr[:, f, 1 + k] = corners[:, ci]
    return pyr.reshape(len(boxes), 6, 15)


def _pyramid_coords(points, pyramid):
    """Affine (alpha, beta, gamma) of points in a face pyramid (reference
    local_pyramid_swap.get_points_ratio). For rectangular boxes the
    face-center→apex direction is ⊥ the face, so these are exact."""
    p = pyramid.reshape(15)
    surface_center = (p[3:6] + p[6:9] + p[9:12] + p[12:15]) / 4.0
    v0 = p[6:9] - p[3:6]
    v1 = p[12:15] - p[3:6]
    v2 = p[0:3] - surface_center
    alphas = ((points[:, 0:3] - p[3:6]) * v0).sum(-1) / max((v0 ** 2).sum(), 1e-9)
    betas = ((points[:, 0:3] - p[3:6]) * v1).sum(-1) / max((v1 ** 2).sum(), 1e-9)
    gammas = ((points[:, 0:3] - surface_center) * v2).sum(-1) / max((v2 ** 2).sum(), 1e-9)
    return alphas, betas, gammas


def _recover_from_pyramid_coords(ratio, pyramid):
    alphas, betas, gammas = ratio
    p = pyramid.reshape(15)
    surface_center = (p[3:6] + p[6:9] + p[9:12] + p[12:15]) / 4.0
    v0 = p[6:9] - p[3:6]
    v1 = p[12:15] - p[3:6]
    v2 = p[0:3] - surface_center
    return (alphas[:, None] * v0 + betas[:, None] * v1) + p[3:6] + gammas[:, None] * v2


def points_in_pyramids_mask(points, pyramids):
    """(M,) x (P, 15) → (M, P) bool, via the affine-coordinates test."""
    pyramids = pyramids.reshape(-1, 15)
    flags = np.zeros((points.shape[0], pyramids.shape[0]), bool)
    for i in range(pyramids.shape[0]):
        a, b, g = _pyramid_coords(points, pyramids[i])
        half = g / 2.0
        flags[:, i] = (
            (g >= 0) & (g <= 1)
            & (a >= half) & (a <= 1 - half)
            & (b >= half) & (b <= 1 - half)
        )
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, rng, pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)  # (N, 6, 15)
    if len(pyramids) == 0:
        return gt_boxes, points, pyramids
    drop_idx = rng.randint(0, 6, len(pyramids))
    drop_box = rng.uniform(0, 1, len(pyramids)) <= dropout_prob
    if drop_box.sum() > 0:
        drop_pyr = pyramids[drop_box, drop_idx[drop_box]]
        pm = points_in_pyramids_mask(points, drop_pyr)
        points = points[~pm.any(-1)]
    pyramids = pyramids[~drop_box]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, rng,
                           pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    if len(pyramids) == 0:
        return gt_boxes, points, pyramids
    sp_idx = rng.randint(0, 6, len(pyramids))
    sp_box = rng.uniform(0, 1, len(pyramids)) <= prob
    sampled = pyramids[sp_box, sp_idx[sp_box]]
    if len(sampled) > 0:
        pm = points_in_pyramids_mask(points, sampled)
        valid = pm.sum(0) > max_num_pts
        if valid.sum() > 0:
            pm = pm[:, valid]
            remain = points[~pm.any(-1)]
            kept = []
            for i in range(pm.shape[1]):
                inside = points[pm[:, i]]
                sel = rng.choice(len(inside), size=max_num_pts, replace=False)
                kept.append(inside[sel])
            points = np.concatenate([remain] + kept, axis=0)
    pyramids = pyramids[~sp_box]
    return gt_boxes, points, pyramids


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, rng,
                       pyramids=None):
    """Swap the point sets of two same-face pyramids across boxes via their
    affine coordinates, intensity re-ranged (reference :581-658)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    if len(pyramids) == 0:
        return gt_boxes, points
    swap_box = rng.uniform(0, 1, len(pyramids)) <= prob
    if swap_box.sum() == 0:
        return gt_boxes, points
    pm_all = points_in_pyramids_mask(points, pyramids)  # (M, N*6)
    counts = pm_all.sum(0).reshape(len(pyramids), 6)
    eligible = counts > max_num_pts
    selected = eligible & swap_box[:, None]
    if selected.sum() == 0:
        return gt_boxes, points
    pairs = []
    for i in np.nonzero(swap_box)[0]:
        js = np.nonzero(selected[i])[0]
        if len(js) == 0:
            continue
        j = rng.choice(js)
        # partner: another box with an eligible face-j pyramid
        cands = np.nonzero(eligible[:, j] & (np.arange(len(pyramids)) != i))[0]
        if len(cands) == 0:
            continue
        pairs.append((i, int(rng.choice(cands)), j))
    if not pairs:
        return gt_boxes, points
    swap_masks, new_chunks = [], []
    for i, k, j in pairs:
        m_i = pm_all[:, i * 6 + j]
        m_k = pm_all[:, k * 6 + j]
        pts_i, pts_k = points[m_i], points[m_k]
        for src, dst_pyr, dst in ((pts_k, pyramids[i, j], pts_i),
                                  (pts_i, pyramids[k, j], pts_k)):
            ratio = _pyramid_coords(src, dst_pyr.reshape(1, 15)[0])
            xyz = _recover_from_pyramid_coords(ratio, dst_pyr)
            inten = src[:, -1:]
            lo, hi = inten.min(), inten.max()
            r = (inten - lo) / np.clip(hi - lo, 1e-6, None)
            dlo, dhi = dst[:, -1:].min(), dst[:, -1:].max()
            out = np.concatenate(
                [xyz, np.zeros((len(xyz), points.shape[1] - 4)),
                 r * (dhi - dlo) + dlo], axis=1
            ) if points.shape[1] > 4 else np.concatenate(
                [xyz, r * (dhi - dlo) + dlo], axis=1
            )
            new_chunks.append(out.astype(points.dtype))
        swap_masks.extend([m_i, m_k])
    drop = np.logical_or.reduce(swap_masks)
    return gt_boxes, np.concatenate([points[~drop]] + new_chunks, axis=0)


def random_image_flip_horizontal(image, depth_map, gt_boxes, calib):
    """Multimodal horizontal flip (JAX augmentor_utils.py:359-368; reference
    :113-151): the image and the depth map mirrored left to right; the gt
    boxes stay in the lidar frame as they are, as the JAX package keeps
    them, and `calib` is not read. Returns (image, depth_map, gt_boxes),
    the arrays contiguous copies."""
    image = np.ascontiguousarray(image[:, ::-1])
    depth_map = np.ascontiguousarray(depth_map[:, ::-1]) if depth_map is not None else None
    return image, depth_map, gt_boxes
