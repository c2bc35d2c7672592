"""The official Waymo Open Dataset detection metric in process (port of
dfu3d_tpu/eval/waymo_official.py; reference pcdet/datasets/waymo/waymo_eval.py,
OpenPCDetWaymoDetectionMetricsEstimator): LEVEL_1 / LEVEL_2 AP and APH per
class through the waymo-open-dataset TensorFlow metric ops. TensorFlow and
the package are imported only when the metric runs;
`WaymoDataset.waymo_official_eval` calls it where the package imports and
otherwise dumps the pickles and the out-of-process command.

The marshalling follows the reference (waymo_eval.py:26-92):
  * class ids: unknown=0, Vehicle=1, Pedestrian=2, Sign=3, Cyclist=4
  * gt difficulty: frames tag boxes 0/1/2; boxes with difficulty 0 become 1
    when num_points_in_gt > 5, else 2; gt boxes with no points are dropped
  * heading wrapped to [-pi, pi); detections carry difficulty 0 (the metric
    op resolves their level from the matched gt)
  * IoU thresholds 0.7 (Vehicle) / 0.5 (Pedestrian / Sign / Cyclist),
    Hungarian matching, 101 score cutoffs.
"""
from __future__ import annotations

import numpy as np

WAYMO_CLASSES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


def _wrap_heading(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _flatten(infos, class_names, is_gt):
    """annos → flat (frame_id, boxes7, type, score, difficulty) arrays."""
    fid, boxes, types, scores, diffs = [], [], [], [], []
    for i, info in enumerate(infos):
        if is_gt:
            names = np.asarray(info["name"])
            mask = np.isin(names, class_names)
            npts = np.asarray(info.get("num_points_in_gt",
                                       np.ones(len(names), np.int64)))
            diff = np.asarray(info.get("difficulty",
                                       np.zeros(len(names), np.int64))).copy()
            diff[(diff == 0) & (npts > 5)] = 1
            diff[(diff == 0) & (npts <= 5)] = 2
            mask &= npts > 0
            b = np.asarray(info["gt_boxes_lidar"], np.float32).reshape(
                -1, np.asarray(info["gt_boxes_lidar"]).shape[-1])[mask, :7]
            s = np.ones(int(mask.sum()), np.float32)
            d = diff[mask]
            names = names[mask]
        else:
            names = np.asarray(info["name"])
            b = np.asarray(info["boxes_lidar"], np.float32).reshape(-1, 7)
            s = np.asarray(info["score"], np.float32)
            d = np.zeros(len(names), np.int64)
        fid.append(np.full(len(names), i, np.int64))
        boxes.append(b)
        types.append(np.asarray(
            [WAYMO_CLASSES.index(n) if n in WAYMO_CLASSES else 0
             for n in names], np.uint8))
        scores.append(s)
        diffs.append(d)
    boxes = (np.concatenate(boxes, 0) if boxes
             else np.zeros((0, 7), np.float32))
    if len(boxes):
        boxes[:, 6] = _wrap_heading(boxes[:, 6])
    return (np.concatenate(fid) if fid else np.zeros(0, np.int64), boxes,
            np.concatenate(types) if types else np.zeros(0, np.uint8),
            np.concatenate(scores) if scores else np.zeros(0, np.float32),
            np.concatenate(diffs) if diffs else np.zeros(0, np.int64))


def _metric_config():
    from google.protobuf import text_format
    from waymo_open_dataset.protos import metrics_pb2

    config = metrics_pb2.Config()
    text_format.Merge(
        """
        breakdown_generator_ids: OBJECT_TYPE
        difficulties { levels: 1 levels: 2 }
        matcher_type: TYPE_HUNGARIAN
        iou_thresholds: 0.0
        iou_thresholds: 0.7
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        box_type: TYPE_3D
        """,
        config,
    )
    for x in range(101):
        config.score_cutoffs.append(x * 0.01)
    return config


def waymo_detection_metrics(det_annos, gt_annos, class_names):
    """Run the official metric in-process. Returns {metric_name: value}."""
    import tensorflow as tf
    from waymo_open_dataset.metrics.python import detection_metrics

    pf, pb, pt, ps, _ = _flatten(det_annos, class_names, is_gt=False)
    gf, gb, gt_t, _, gd = _flatten(gt_annos, class_names, is_gt=True)

    graph = tf.Graph()
    with graph.as_default():
        ph = {
            "pd_frame_id": tf.compat.v1.placeholder(tf.int64),
            "pd_bbox": tf.compat.v1.placeholder(tf.float32),
            "pd_type": tf.compat.v1.placeholder(tf.uint8),
            "pd_score": tf.compat.v1.placeholder(tf.float32),
            "gt_frame_id": tf.compat.v1.placeholder(tf.int64),
            "gt_bbox": tf.compat.v1.placeholder(tf.float32),
            "gt_type": tf.compat.v1.placeholder(tf.uint8),
            "gt_difficulty": tf.compat.v1.placeholder(tf.uint8),
        }
        metrics = detection_metrics.get_detection_metric_ops(
            config=_metric_config(),
            prediction_frame_id=ph["pd_frame_id"],
            prediction_bbox=ph["pd_bbox"],
            prediction_type=ph["pd_type"],
            prediction_score=ph["pd_score"],
            prediction_overlap_nlz=tf.zeros_like(ph["pd_frame_id"],
                                                 dtype=tf.bool),
            ground_truth_frame_id=ph["gt_frame_id"],
            ground_truth_bbox=ph["gt_bbox"],
            ground_truth_type=ph["gt_type"],
            ground_truth_difficulty=ph["gt_difficulty"],
        )
    with tf.compat.v1.Session(graph=graph) as sess:
        sess.run(tf.compat.v1.initializers.local_variables())
        sess.run(
            [m[1] for m in metrics.values()],
            feed_dict={
                ph["pd_frame_id"]: pf, ph["pd_bbox"]: pb, ph["pd_type"]: pt,
                ph["pd_score"]: ps, ph["gt_frame_id"]: gf, ph["gt_bbox"]: gb,
                ph["gt_type"]: gt_t,
                ph["gt_difficulty"]: gd.astype(np.uint8),
            },
        )
        return {k: float(sess.run(m[0])) for k, m in metrics.items()}
