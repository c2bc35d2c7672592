"""Evaluation (port of dfu3d_tpu/train/eval_utils.py, itself the reference's
tools/eval_utils/eval_utils.py).

`eval_batches` runs the eval step over batches and sums the recall counters.
`eval_one_epoch` is the whole epoch over a dataset's loader: the eval step
per batch, per-frame prediction dicts sorted by score, the KITTI-format
prediction writer, the recall counters summed over the epoch (reference
detector3d_template.generate_recall_record:286-327), and
`dataset.evaluation()` (KITTI AP).

Over several ranks each rank evaluates its loader shard, and the cross-rank
merge (the JAX package's eval_utils.py:86-105, the reference's
merge_results_dist) gathers every rank's annos and recall counters, sums
the counters, and sorts the annos into the dataset's frame order
(`frame_order`). The loader pads its order to a multiple of the rank count,
and the merge keeps those padded duplicates, as JAX's does: the recall
counters and `num_frames` count them. The AP takes each frame once, the
first of its copies (JAX hands the duplicates to the evaluator, whose
one-anno-per-frame assert then fails).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Iterable, List, NamedTuple

import numpy as np
import torch

from ..parallel import mesh
from ..parallel.distributed import all_gather_objects
from .train_state import make_eval_step


class EvalResult(NamedTuple):
    metric: dict          # gt_num and recall_rcnn_{t}, summed over batches
    preds: List[tuple]    # per batch (boxes, scores, labels, valid) on the CPU
    batch_seconds: List[float]  # host clock per batch, to its results on the host


def eval_batches(model, batches: Iterable, recall_thresh=(0.3, 0.5, 0.7), device="cuda",
                 dtype=torch.float32) -> EvalResult:
    step = make_eval_step(model, recall_thresh=tuple(recall_thresh), device=device, dtype=dtype)
    metric = {"gt_num": 0, **{f"recall_rcnn_{t}": 0 for t in recall_thresh}}
    preds, seconds = [], []
    for batch in batches:
        t0 = time.perf_counter()
        boxes, scores, labels, valid, recall = step(batch)
        preds.append(tuple(t.cpu() for t in (boxes, scores, labels, valid)))
        for k, v in recall.items():
            metric[k] += int(v)
        seconds.append(time.perf_counter() - t0)
    return EvalResult(metric, preds, seconds)


def frame_order(dataset) -> dict:
    """frame_id (as a string) → its index in the dataset's infos: the
    `infos` list, or the dataset's own `<name>_infos` (KittiDataset's
    kitti_infos). Each info's id is its frame_id, else its
    point_cloud.lidar_idx, else its index (the JAX package's key)."""
    infos = getattr(dataset, "infos", None)
    if infos is None:
        infos = next((v for k, v in vars(dataset).items()
                      if k.endswith("_infos") and isinstance(v, list)), [])
    return {str(info.get("frame_id", info.get("point_cloud", {}).get("lidar_idx", i))): i
            for i, info in enumerate(infos)}


def merge_ranks(det_annos, metric, dataset):
    """The cross-rank merge: (every rank's annos in the dataset's frame
    order, the padded duplicates kept; the recall counters summed)."""
    gathered = all_gather_objects({"annos": det_annos, "metric": metric})
    merged = [a for g in gathered for a in g["annos"]]
    order = frame_order(dataset)
    merged.sort(key=lambda a: order.get(str(a.get("frame_id")), len(order)))
    return merged, {k: sum(g["metric"][k] for g in gathered) for k in metric}


def first_copies(det_annos):
    """Each frame's first anno, in order (the merged annos less the
    loader's padded duplicates)."""
    seen, out = set(), []
    for a in det_annos:
        key = str(a.get("frame_id"))
        if key not in seen:
            seen.add(key)
            out.append(a)
    return out


def eval_one_epoch(model, dataset, dataloader, cfg, logger=None, result_dir=None,
                   save_to_file=False, device="cuda", dtype=torch.float32):
    """Evaluate `model` over `dataloader` (batches of (PointBatch,
    BatchMeta)). Returns (ap_result_str, result_dict, det_annos): the AP
    dict of `dataset.evaluation`, plus "sec_per_example", "recall/rcnn_{t}",
    the summed counters "gt_num" and "recall_rcnn_{t}", and the epoch's
    host-clock split in seconds ("time/data": waiting for the loader,
    "time/eval_steps": the eval steps to their results on the host,
    "time/prediction_writer": prediction dicts and KITTI txts,
    "time/evaluation": the AP), with "eval_batches" and "num_frames". With
    `save_to_file`, one KITTI txt per frame goes to
    result_dir/final_result/data."""
    class_names = cfg.CLASS_NAMES
    thresh_list = cfg.MODEL.get("POST_PROCESSING", {}).get(
        "RECALL_THRESH_LIST", [0.3, 0.5, 0.7])
    step = make_eval_step(model, recall_thresh=tuple(thresh_list), device=device, dtype=dtype)

    det_annos = []
    metric = {"gt_num": 0, **{f"recall_rcnn_{t}": 0 for t in thresh_list}}
    out_label_dir = None
    if save_to_file and result_dir is not None:
        out_label_dir = Path(result_dir) / "final_result" / "data"
        out_label_dir.mkdir(parents=True, exist_ok=True)

    split = {"time/data": 0.0, "time/eval_steps": 0.0, "time/prediction_writer": 0.0}
    num_frames = num_batches = 0
    start = end = time.perf_counter()
    for batch, meta in dataloader:
        t0 = time.perf_counter()
        split["time/data"] += t0 - end
        boxes, scores, labels, valid, recall = step(batch)
        boxes, scores, labels, valid = (t.cpu().numpy() for t in (boxes, scores, labels, valid))
        for k, v in recall.items():
            metric[k] += int(v)
        t1 = time.perf_counter()
        pred_dicts = []
        for i in range(len(boxes)):
            v = valid[i]
            order = np.argsort(-scores[i][v])
            pred_dicts.append({"pred_boxes": boxes[i][v][order],
                               "pred_scores": scores[i][v][order],
                               "pred_labels": labels[i][v][order]})
        det_annos.extend(dataset.generate_prediction_dicts(
            meta, pred_dicts, class_names, output_path=out_label_dir))
        end = time.perf_counter()
        split["time/eval_steps"] += t1 - t0
        split["time/prediction_writer"] += end - t1
        num_frames += len(boxes)
        num_batches += 1

    if mesh.world() > 1:
        det_annos, metric = merge_ranks(det_annos, metric, dataset)
        num_frames = len(det_annos)
        logger = logger if mesh.rank() == 0 else None
    sec_per_example = (time.perf_counter() - start) / max(num_frames, 1)
    if logger:
        logger.info(f"eval: {sec_per_example:.4f} s/frame ({num_frames} frames)")
        gt_num = max(metric["gt_num"], 1)
        for t in thresh_list:
            logger.info(f"recall_rcnn_{t}: {metric[f'recall_rcnn_{t}'] / gt_num:.4f}")

    t0 = time.perf_counter()
    result_str, result_dict = dataset.evaluation(
        first_copies(det_annos) if mesh.world() > 1 else det_annos, class_names)
    split["time/evaluation"] = time.perf_counter() - t0
    if logger:
        logger.info(result_str)
        # machine-readable AP line for scripts (self-evolution rounds)
        logger.info("AP_DICT " + json.dumps(
            {k: float(v) for k, v in result_dict.items()}, sort_keys=True))
    result_dict["sec_per_example"] = sec_per_example
    for t in thresh_list:
        result_dict[f"recall/rcnn_{t}"] = metric[f"recall_rcnn_{t}"] / max(metric["gt_num"], 1)
    result_dict.update(metric, **split, eval_batches=num_batches, num_frames=num_frames)
    if logger:
        logger.info("eval time split (s): " + json.dumps(
            {k: round(v, 4) for k, v in split.items()}))
    return result_str, result_dict, det_annos
