"""KITTI-protocol AP evaluator — DFU3D's modified 10-class variant.

Own copy of dfu3d_tpu/eval/kitti_eval.py. Protocol parity with the reference
(pcdet/datasets/kitti/kitti_object_eval_python/eval.py): 41-point and R40
interpolated AP over bbox/BEV/3D metrics, the DFU3D-modified
10-nuScenes-class table with min IoU 0.5/0.5/0.25 for all classes
(eval.py:704-744), greedy score-ordered matching with ignored/DontCare
handling (compute_statistics_jit, eval.py:161-283), and the same
result-string layout. The numba-CUDA rotated IoU (rotate_iou.py) is replaced
by the vectorized numpy Green's-theorem overlap (data/np_geometry.py), the
JAX package's numpy form, so the overlaps equal its own. The greedy matcher
runs in the native library (eval/csrc/kitti_match.cpp, `use_native=True`,
which raises when it cannot be built or loaded) or in its plain Python twin
here (`use_native=False`).

This is the comparison contract: golden tests pin its output.
"""
from __future__ import annotations

import io as sysio

import numpy as np

from ..data import np_geometry as npg

CLASS_TO_NAME = {
    0: "Car",
    1: "Truck",
    2: "Construction_vehicle",
    3: "Bus",
    4: "Trailer",
    5: "Barrier",
    6: "Motorcycle",
    7: "Bicycle",
    8: "Pedestrian",
    9: "Traffic_cone",
    # classic-KITTI extras beyond the reference's 10-class nuScenes table
    # (eval.py:723-744): the same uniform 0.5/0.5/0.25 overlap rule applies,
    # so KITTI-style Cyclist/Van class lists evaluate under one protocol
    10: "Cyclist",
    11: "Van",
    12: "Person_sitting",
}
CLASS_NAMES = [CLASS_TO_NAME[i] for i in range(len(CLASS_TO_NAME))]

MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]

NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds at ~uniform recall steps (eval.py:9-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < (len(scores) - 1)
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Per-class gt/dt filtering with difficulty rules (eval.py:30-90)."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = False
        if difficulty < 3 and (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        ):
            ignore = True
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(num_dt):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if difficulty in (0, 1, 2) and height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Axis-aligned 2D overlap with union criterion (eval.py:93-119), vectorized."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_n = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_k = (query_boxes[:, 2] - query_boxes[:, 0]) * (
        query_boxes[:, 3] - query_boxes[:, 1]
    )
    if criterion == -1:
        ua = area_n[:, None] + area_k[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_n[:, None], inter.shape).copy()
    elif criterion == 1:
        ua = np.broadcast_to(area_k[None, :], inter.shape).copy()
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / np.maximum(ua, 1e-12), 0.0)


def _rotated_overlap(boxes5, qboxes5, criterion=-1):
    """Rotated rectangle overlap in camera BEV, criterion semantics of
    rotate_iou_gpu_eval (rotate_iou.py:249-261)."""
    inter = npg.pairwise_overlap_bev(
        np.ascontiguousarray(boxes5, np.float32),
        np.ascontiguousarray(qboxes5, np.float32),
    ).astype(np.float64)
    area1 = (boxes5[:, 2] * boxes5[:, 3])[:, None]
    area2 = (qboxes5[:, 2] * qboxes5[:, 3])[None, :]
    if criterion == -1:
        return inter / np.maximum(area1 + area2 - inter, 1e-12)
    if criterion == 0:
        return inter / np.maximum(area1, 1e-12)
    if criterion == 1:
        return inter / np.maximum(area2, 1e-12)
    return inter  # raw intersection area


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return _rotated_overlap(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D IoU (eval.py:126-158): rotated BEV ∩ × y-extent ∩.

    boxes: (N, 7) [x, y, z, l, h, w, ry] camera, y is the bottom.
    """
    rinc = _rotated_overlap(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    iw = np.minimum(boxes[:, None, 1], qboxes[None, :, 1]) - np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4], qboxes[None, :, 1] - qboxes[None, :, 4]
    )
    area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(area1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area2, inc.shape)
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0), inc / np.maximum(ua, 1e-12), 0.0)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy matching (exact port of compute_statistics_jit, eval.py:161-283).

    overlaps indexed [det, gt].
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (
                compute_fp
                and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp
                and overlap > min_overlap
                and valid_detection == NO_DETECTION
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (
                assigned_detection[i]
                or ignored_det[i] == -1
                or ignored_det[i] == 1
                or ignored_threshold[i]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (
                        assigned_detection[j]
                        or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]
                    ):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, np.array(thresholds)


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_dc_num = []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty
        )
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dc_bboxes = (
            np.zeros((0, 4), np.float64)
            if len(dc_bboxes) == 0
            else np.stack(dc_bboxes, 0).astype(np.float64)
        )
        total_dc_num.append(dc_bboxes.shape[0])
        dontcares.append(dc_bboxes)
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate(
                [gt_annos[i]["bbox"], gt_annos[i]["alpha"][..., np.newaxis]], 1
            )
        )
        dt_datas_list.append(
            np.concatenate(
                [
                    dt_annos[i]["bbox"],
                    dt_annos[i]["alpha"][..., np.newaxis],
                    dt_annos[i]["score"][..., np.newaxis],
                ],
                1,
            )
        )
    return (
        gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
        np.stack(total_dc_num, axis=0), total_num_valid_gt,
    )


def _calculate_iou(dt_annos, gt_annos, metric):
    """Per-frame [det, gt] overlap matrices."""
    overlaps = []
    for dt, gt in zip(dt_annos, gt_annos):
        if metric == 0:
            o = image_box_overlap(
                np.asarray(dt["bbox"], np.float64), np.asarray(gt["bbox"], np.float64)
            )
        elif metric == 1:
            db = np.concatenate(
                [dt["location"][:, [0, 2]], dt["dimensions"][:, [0, 2]],
                 dt["rotation_y"][..., None]], axis=1,
            )
            gb = np.concatenate(
                [gt["location"][:, [0, 2]], gt["dimensions"][:, [0, 2]],
                 gt["rotation_y"][..., None]], axis=1,
            )
            o = bev_box_overlap(db, gb)
        elif metric == 2:
            db = np.concatenate(
                [dt["location"], dt["dimensions"], dt["rotation_y"][..., None]], axis=1
            )
            gb = np.concatenate(
                [gt["location"], gt["dimensions"], gt["rotation_y"][..., None]], axis=1
            )
            o = d3_box_overlap(db, gb)
        else:
            raise ValueError(metric)
        overlaps.append(o.astype(np.float64))
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, use_native=True):
    """(eval.py:458-565) → dict of recall/precision/aos curves.

    Matching runs in the native C++ matcher (eval/csrc/kitti_match.cpp)
    with `use_native`, else in the plain Python matcher below, its twin
    (held equal to it in tests/test_torch_port_eval.py).
    """
    assert len(gt_annos) == len(dt_annos)
    overlaps = _calculate_iou(dt_annos, gt_annos, metric)
    lib = None
    if use_native:
        from .native import get_lib

        lib = get_lib()
    n_sample_pts = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
             total_dc_num, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty
            )
            flat = None
            if lib is not None:
                from .native import FlatFrames

                flat = FlatFrames(
                    overlaps, gt_datas_list, dt_datas_list, ignored_gts,
                    ignored_dets, dontcares,
                )
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                if flat is not None:
                    thresholdss = flat.collect_thresholds(lib, metric, min_overlap)
                else:
                    thresholdss = []
                    for i in range(len(gt_annos)):
                        _, _, _, _, th = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=0.0,
                            compute_fp=False,
                        )
                        thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(np.array(thresholdss),
                                                     total_num_valid_gt))
                if flat is not None:
                    pr = flat.fused_statistics(
                        lib, metric, min_overlap, thresholds, compute_aos
                    )
                else:
                    pr = np.zeros([len(thresholds), 4])
                    for i in range(len(gt_annos)):
                        for t, thresh in enumerate(thresholds):
                            tp, fp, fn, similarity, _ = compute_statistics(
                                overlaps[i], gt_datas_list[i], dt_datas_list[i],
                                ignored_gts[i], ignored_dets[i], dontcares[i],
                                metric, min_overlap=min_overlap, thresh=thresh,
                                compute_fp=True, compute_aos=compute_aos,
                            )
                            pr[t, 0] += tp
                            pr[t, 1] += fp
                            pr[t, 2] += fn
                            if similarity != -1:
                                pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-12)
                    precision[m, ld, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-12)
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(precision[m, ld, k, i:], axis=-1)
                    recall[m, ld, k, i] = np.max(recall[m, ld, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False,
            difficultys=(0, 1, 2), use_native=True):
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, use_native=use_native)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps,
                     use_native=use_native)
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps,
                     use_native=use_native)
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
            mAP_3d_R40, mAP_aos_R40)


def _print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def get_official_eval_result(gt_annos, dt_annos, current_classes, use_native=True):
    """DFU3D 10-class table: IoU 0.5 (strict/moderate) and 0.25 for all classes
    (eval.py:693-836)."""
    num_c = len(CLASS_TO_NAME)
    overlap_0_7 = np.full((3, num_c), 0.5)
    overlap_0_5 = np.full((3, num_c), 0.5)
    overlap_0_25 = np.full((3, num_c), 0.25)
    min_overlaps = np.stack([overlap_0_7, overlap_0_5, overlap_0_25], axis=0)

    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else int(c) for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos, use_native=use_native)

    result = ""
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        name = CLASS_TO_NAME[curcls]
        for i in range(min_overlaps.shape[0]):
            result += _print_str(
                f"{name} AP@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:"
            )
            result += _print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, "
                f"{mAPbbox[j, 2, i]:.4f}"
            )
            result += _print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, "
                f"{mAPbev[j, 2, i]:.4f}"
            )
            result += _print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, "
                f"{mAP3d[j, 2, i]:.4f}"
            )
            if compute_aos:
                result += _print_str(
                    f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, "
                    f"{mAPaos[j, 2, i]:.2f}"
                )
            result += _print_str(
                f"{name} AP_R40@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:"
            )
            result += _print_str(
                f"bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, {mAPbbox_R40[j, 1, i]:.4f}, "
                f"{mAPbbox_R40[j, 2, i]:.4f}"
            )
            result += _print_str(
                f"bev  AP:{mAPbev_R40[j, 0, i]:.4f}, {mAPbev_R40[j, 1, i]:.4f}, "
                f"{mAPbev_R40[j, 2, i]:.4f}"
            )
            result += _print_str(
                f"3d   AP:{mAP3d_R40[j, 0, i]:.4f}, {mAP3d_R40[j, 1, i]:.4f}, "
                f"{mAP3d_R40[j, 2, i]:.4f}"
            )
            if compute_aos:
                result += _print_str(
                    f"aos  AP:{mAPaos_R40[j, 0, i]:.2f}, {mAPaos_R40[j, 1, i]:.2f}, "
                    f"{mAPaos_R40[j, 2, i]:.2f}"
                )
                if i == 0:
                    ret_dict[f"{name}_aos/easy_R40"] = mAPaos_R40[j, 0, 0]
                    ret_dict[f"{name}_aos/moderate_R40"] = mAPaos_R40[j, 1, 0]
                    ret_dict[f"{name}_aos/hard_R40"] = mAPaos_R40[j, 2, 0]
            if i == 0:
                ret_dict[f"{name}_3d/easy_R40"] = mAP3d_R40[j, 0, 0]
                ret_dict[f"{name}_3d/moderate_R40"] = mAP3d_R40[j, 1, 0]
                ret_dict[f"{name}_3d/hard_R40"] = mAP3d_R40[j, 2, 0]
                ret_dict[f"{name}_bev/easy_R40"] = mAPbev_R40[j, 0, 0]
                ret_dict[f"{name}_bev/moderate_R40"] = mAPbev_R40[j, 1, 0]
                ret_dict[f"{name}_bev/hard_R40"] = mAPbev_R40[j, 2, 0]
                ret_dict[f"{name}_image/easy_R40"] = mAPbbox_R40[j, 0, 0]
                ret_dict[f"{name}_image/moderate_R40"] = mAPbbox_R40[j, 1, 0]
                ret_dict[f"{name}_image/hard_R40"] = mAPbbox_R40[j, 2, 0]
    return result, ret_dict


def lidar_anno(boxes, names, scores=None):
    """A KITTI-format anno of LiDAR-frame boxes (N, 7) [x y z dx dy dz
    heading] and their (already KITTI-style) names, for the KITTI protocol
    over datasets without a camera (Waymo, Custom, Pandaset, Argo2): the
    camera layout [x = -y_l, y = -z_l, z = x_l], dims (l, h, w), ry =
    -heading - pi/2, a fixed 200-pixel image box, no truncation or
    occlusion, alpha -10 (the JAX datasets' `to_kitti`)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    n = len(boxes)
    d = {
        "name": np.array([str(x) for x in names], dtype="<U32"),
        "truncated": np.zeros(n), "occluded": np.zeros(n),
        "alpha": np.full(n, -10.0),
        "bbox": np.tile([0, 0, 200, 200.0], (n, 1)),
        "dimensions": boxes[:, [3, 5, 4]] if n else np.zeros((0, 3)),
        "location": np.stack(
            [-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], axis=1
        ) if n else np.zeros((0, 3)),
        "rotation_y": (-boxes[:, 6] - np.pi / 2) if n else np.zeros(0),
    }
    if scores is not None:
        d["score"] = np.asarray(scores)
    return d
