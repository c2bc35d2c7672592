"""ONCE benchmark evaluator (own copy of dfu3d_tpu/eval/once_eval.py; reference
pcdet/datasets/once/once_eval/evaluation.py + eval_utils.py), in numpy.

The ONCE protocol: superclass grouping (Car / Bus / Truck -> Vehicle),
per-class IoU thresholds, the Overall and distance tiers (0-30 m, 30-50 m,
50 m-inf), the heading-gated 3D IoU (a pair more than pi/2 apart in yaw
overlaps 0), the 50-point PR sampling with the reference's recall-level
threshold walk, and the two-pass greedy matching (the matched scores first,
then TP / FP / FN at each threshold). Rotated overlaps come from
`data.np_geometry.pairwise_overlap_bev`.

The matching keeps the JAX package's loop over the ground truth and its
order of decisions; the loop over the predictions of one ground-truth box is
a numpy expression of the same rule (the first of the highest-scoring, or
the first of the largest-IoU candidates, as the scalar loop keeps them), so
tied scores and IoUs resolve as they do there. Sorts use the same calls.
"""
from __future__ import annotations

import numpy as np

from ..data import np_geometry as npg

IOU_THRESHOLD = {"Car": 0.7, "Bus": 0.7, "Truck": 0.7,
                 "Pedestrian": 0.3, "Cyclist": 0.5}
SUPERCLASS_IOU_THRESHOLD = {"Vehicle": 0.7, "Pedestrian": 0.3, "Cyclist": 0.5}


def iou3d_with_heading(gt_boxes, pred_boxes, with_heading=True):
    """(N, 7) x (M, 7) lidar boxes -> heading-gated 3D IoU (N, M)."""
    n, m = len(gt_boxes), len(pred_boxes)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    inter_2d = npg.pairwise_overlap_bev(
        np.ascontiguousarray(gt_boxes[:, [0, 1, 3, 4, 6]], np.float32),
        np.ascontiguousarray(pred_boxes[:, [0, 1, 3, 4, 6]], np.float32),
    ).astype(np.float64)
    gt_max = gt_boxes[:, [2]] + gt_boxes[:, [5]] * 0.5
    gt_min = gt_boxes[:, [2]] - gt_boxes[:, [5]] * 0.5
    pr_max = pred_boxes[:, [2]] + pred_boxes[:, [5]] * 0.5
    pr_min = pred_boxes[:, [2]] - pred_boxes[:, [5]] * 0.5
    inter_h = np.minimum(gt_max, pr_max.T) - np.maximum(gt_min, pr_min.T)
    inter_h[inter_h <= 0] = 0
    inter_3d = inter_2d * inter_h
    vol_gt = (gt_boxes[:, [3]] * gt_boxes[:, [4]] * gt_boxes[:, [5]])
    vol_pr = (pred_boxes[:, [3]] * pred_boxes[:, [4]] * pred_boxes[:, [5]])
    iou = inter_3d / np.maximum(vol_gt + vol_pr.T - inter_3d, 1e-9)
    if with_heading:
        d = np.abs(gt_boxes[:, [6]] - pred_boxes[:, [6]].T)
        d = np.where(d >= np.pi, 2 * np.pi - d, d)
        iou[d > np.pi / 2] = 0
    return iou


def _distance_ignore(boxes, level, mode):
    dist = np.linalg.norm(boxes[:, 0:3], axis=1)
    if mode == "Overall":
        return np.zeros(len(boxes), bool)
    if mode == "Distance":
        bands = [dist < 30, (dist >= 30) & (dist < 50), dist >= 50]
        return ~bands[level]
    # Overall&Distance
    if level == 0:
        return np.zeros(len(boxes), bool)
    bands = [dist < 30, (dist >= 30) & (dist < 50), dist >= 50]
    return ~bands[level - 1]


def _flags(anno, class_name, level, mode, use_superclass):
    """Per box: -1 another class, 1 ignored (outside the distance tier), 0 counted."""
    names = np.asarray(anno["name"])
    flag = np.zeros(len(names), np.int64)
    if use_superclass and class_name == "Vehicle":
        reject = (names == "Pedestrian") | (names == "Cyclist")
    else:
        reject = names != class_name
    flag[reject] = -1
    ig = _distance_ignore(np.asarray(anno["boxes_3d"]).reshape(-1, 7),
                          level, mode)
    flag[ig & (flag == 0)] = 1
    return flag


def _first_max(values, cand):
    """Index of the first largest of `values` where `cand`, or -1."""
    if not cand.any():
        return -1
    return int(np.argmax(np.where(cand, values, -np.inf)))


def _accumulate_scores(iou, scores, gt_flag, pred_flag, thr):
    """The scores of the predictions the counted ground truth matches: each
    ground-truth box (in order) takes the highest-scoring free prediction
    above `thr`."""
    assigned = np.zeros(len(scores), bool)
    open_pred = (pred_flag != -1) & (scores > -1.0)
    out = []
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        det = _first_max(scores, open_pred & ~assigned & (iou[i] > thr))
        if det == -1:
            continue
        assigned[det] = True
        if gt_flag[i] == 1 or pred_flag[det] == 1:
            continue
        out.append(scores[det])
    return np.asarray(out)


def _statistics(iou, scores, gt_flag, pred_flag, score_th, iou_th):
    """(TP, FP, FN) at one score threshold: each ground-truth box takes the
    free counted prediction of largest IoU above `iou_th`, else the first
    free ignored one."""
    assigned = np.zeros(len(scores), bool)
    under = scores < score_th
    open_pred = (pred_flag != -1) & ~under
    tp = fp = fn = 0
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        above = open_pred & ~assigned & (iou[i] > iou_th)
        det = _first_max(iou[i], above & (pred_flag == 0))
        if det == -1:
            ignored = np.flatnonzero(above & (pred_flag == 1))
            det = int(ignored[0]) if len(ignored) else -1
        detected = det != -1
        if not detected and gt_flag[i] == 0:
            fn += 1
        elif detected and (gt_flag[i] == 1 or pred_flag[det] == 1):
            assigned[det] = True
        elif detected:
            tp += 1
            assigned[det] = True
    fp += int((~(assigned | (pred_flag != 0) | under)).sum())
    return tp, fp, fn


def _thresholds(scores, num_gt, num_pr_points):
    eps = 1e-6
    scores = np.sort(scores)[::-1]
    out, recall_level = [], 0.0
    for i, s in enumerate(scores):
        l_r = (i + 1) / num_gt
        r_r = (i + 2) / num_gt if i < len(scores) - 1 else l_r
        if (r_r + l_r < 2 * recall_level) and i < len(scores) - 1:
            continue
        out.append(s)
        recall_level += 1 / num_pr_points
        while r_r + l_r + eps > 2 * recall_level:
            out.append(s)
            recall_level += 1 / num_pr_points
    return out


def get_evaluation_results(gt_annos, pred_annos, classes, use_superclass=True,
                           iou_thresholds=None, num_pr_points=50,
                           difficulty_mode="Overall&Distance",
                           ap_with_heading=True):
    """(result text, {"AP_<class>/<tier>": AP, "AP_mean/<tier>": mAP}) over
    annos with "name", "boxes_3d" (and the predictions' "score")."""
    if iou_thresholds is None:
        iou_thresholds = (SUPERCLASS_IOU_THRESHOLD if use_superclass
                          else IOU_THRESHOLD)
    classes = list(classes)
    if use_superclass and any(c in classes for c in ("Car", "Bus", "Truck")):
        classes = [c for c in classes if c not in ("Car", "Bus", "Truck")]
        classes.insert(0, "Vehicle")

    diff_types = {
        "Overall": ["overall"],
        "Distance": ["0-30m", "30-50m", "50m-inf"],
        "Overall&Distance": ["overall", "0-30m", "30-50m", "50m-inf"],
    }[difficulty_mode]

    ious = [
        iou3d_with_heading(
            np.asarray(g["boxes_3d"]).reshape(-1, 7),
            np.asarray(p["boxes_3d"]).reshape(-1, 7), ap_with_heading,
        )
        for g, p in zip(gt_annos, pred_annos)
    ]

    nc, nd = len(classes), len(diff_types)
    precision = np.zeros([nc, nd, num_pr_points + 1])
    recall = np.zeros([nc, nd, num_pr_points + 1])
    for ci, cls in enumerate(classes):
        iou_th = iou_thresholds[cls]
        for di in range(nd):
            flags = [
                (_flags(g, cls, di, difficulty_mode, use_superclass),
                 _flags(p, cls, di, difficulty_mode, use_superclass))
                for g, p in zip(gt_annos, pred_annos)
            ]
            num_valid_gt = sum(int((gf == 0).sum()) for gf, _ in flags)
            all_scores = np.concatenate([
                _accumulate_scores(iou, np.asarray(p["score"]), gf, pf, iou_th)
                for iou, p, (gf, pf) in zip(ious, pred_annos, flags)
            ]) if flags else np.zeros(0)
            ths = _thresholds(all_scores, max(num_valid_gt, 1), num_pr_points)
            cm = np.zeros([len(ths), 3])
            for iou, p, (gf, pf) in zip(ious, pred_annos, flags):
                sc = np.asarray(p["score"])
                for ti, th in enumerate(ths):
                    tp, fp, fn = _statistics(iou, sc, gf, pf, th, iou_th)
                    cm[ti] += (tp, fp, fn)
            for ti in range(len(ths)):
                recall[ci, di, ti] = cm[ti, 0] / max(cm[ti, 0] + cm[ti, 2], 1e-9)
                precision[ci, di, ti] = cm[ti, 0] / max(cm[ti, 0] + cm[ti, 1], 1e-9)
            for ti in range(len(ths)):
                precision[ci, di, ti] = np.max(precision[ci, di, ti:])
                recall[ci, di, ti] = np.max(recall[ci, di, ti:])

    ap = precision[..., 1:].sum(-1) / num_pr_points * 100
    ret, lines = {}, [f"|AP@{num_pr_points:<9}|"
                      + "".join(f"{t:<12}|" for t in diff_types)]
    for ci, cls in enumerate(classes):
        row = f"|{cls:<12}|"
        for di, t in enumerate(diff_types):
            ret[f"AP_{cls}/{t}"] = ap[ci, di]
            row += f"{ap[ci, di]:<12.2f}|"
        lines.append(row)
    m = ap.mean(0)
    row = f"|{'mAP':<12}|"
    for di, t in enumerate(diff_types):
        ret[f"AP_mean/{t}"] = m[di]
        row += f"{m[di]:<12.2f}|"
    lines.append(row)
    return "\n" + "\n".join(lines) + "\n", ret
