"""Waymo Open Dataset from its extracted layout (own copy of
dfu3d_tpu/data/waymo_dataset.py; reference pcdet/datasets/waymo/
waymo_dataset.py).

TFRecord extraction needs the waymo-open-dataset package and is a step of
its own (`tools/waymo_extract.py`); this class reads what it writes:

    <PROCESSED_DATA_TAG>/<sequence>/<frame:04d>.npy    (N, 6) points
        x y z intensity elongation NLZ-flag
    <PROCESSED_DATA_TAG>/<sequence>/<sequence>.pkl     the sequence's infos
        {point_cloud: {lidar_sequence, sample_idx}, frame_id,
         annos: {name, gt_boxes_lidar, num_points_in_gt, difficulty}}
    ImageSets/<split>.txt                              sequence names

with SAMPLED_INTERVAL per mode. Evaluation: the KITTI protocol over lidar
boxes with the Waymo -> KITTI class map (the reference's `kitti`
EVAL_METRIC); EVAL_METRIC 'waymo' dumps the detections and the ground truth
for the official metric and runs it in process where TensorFlow and the
waymo-open-dataset package import (`eval/waymo_official.py`), else leaves
the command that runs it out of process.

Where this copy differs from the JAX package: it keeps the elongation
column. The JAX package keeps `[:, :4]` after the NLZ filter, so a config
that encodes ['x', 'y', 'z', 'intensity', 'elongation'] (waymo_dataset.yaml,
as shipped) gets 4 columns for a 5-feature model; here it gets the 5 the
extracted layout holds (ROADMAP Queue C). A config that encodes four
features reads what the JAX package reads. As in the JAX package,
SEQUENCE_CONFIG and DISABLE_NLZ_FLAG_ON_POINTS are not read: a multi-frame
config reads one frame, and NLZ points are dropped whenever a frame flags
any.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..eval.kitti_eval import lidar_anno
from .dataset import DatasetTemplate

# the evaluator uses the DFU3D 10-class table, which has Bicycle rather than
# KITTI's Cyclist
WAYMO_TO_KITTI = {"Vehicle": "Car", "Pedestrian": "Pedestrian",
                  "Cyclist": "Bicycle", "Sign": "Sign"}
POINT_COLUMNS = 5   # x y z intensity elongation; the sixth, the NLZ flag, is dropped


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        self.data_dir = self.root_path / dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data"
        )
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        seqs = (
            [x.strip().replace(".tfrecord", "")
             for x in split_file.read_text().splitlines() if x.strip()]
            if split_file.exists() else []
        )
        interval = int(dataset_cfg.get("SAMPLED_INTERVAL", {}).get(self.mode, 1))
        self.infos = []
        for seq in seqs:
            pkl = self.data_dir / seq / f"{seq}.pkl"
            if not pkl.exists():
                continue
            with open(pkl, "rb") as f:
                self.infos.extend(pickle.load(f)[::interval])
        if logger:
            logger.info(f"WaymoDataset[{self.split}]: {len(self.infos)} frames")

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * max(self.total_epochs, 1)
        return len(self.infos)

    def get_lidar(self, sequence_name, sample_idx):
        """The frame's points, NLZ points dropped when the frame flags any,
        in the layout's first five columns."""
        pts = np.load(
            self.data_dir / sequence_name / f"{sample_idx:04d}.npy"
        ).astype(np.float32)
        if pts.shape[1] >= 6:
            pts = pts[pts[:, 5] == -1] if (pts[:, 5] < 0).any() else pts
            pts = pts[:, :POINT_COLUMNS]
        return pts

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = self.infos[index]
        pc = info["point_cloud"]
        points = self.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
        input_dict = {"frame_id": info.get("frame_id", pc["sample_idx"]),
                      "points": points}
        if "annos" in info:
            annos = info["annos"]
            keep = np.asarray(annos["name"]) != "unknown"
            input_dict["gt_names"] = np.asarray(annos["name"])[keep].copy()
            input_dict["gt_boxes"] = np.asarray(
                annos["gt_boxes_lidar"], np.float32
            ).reshape(-1, annos["gt_boxes_lidar"].shape[-1])[keep, :7].copy()
        data_dict = self.prepare_data(input_dict)
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        return data_dict

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        annos = []
        for i, box_dict in enumerate(pred_dicts):
            labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)
            annos.append({
                "frame_id": batch_meta.frame_ids[i],
                "name": np.array([class_names[l - 1] for l in labels],
                                 dtype="<U32"),
                "score": np.asarray(box_dict["pred_scores"]),
                "boxes_lidar": np.asarray(box_dict["pred_boxes"]).reshape(-1, 7),
            })
        return annos

    def waymo_official_eval(self, det_annos, class_names, output_path=None):
        """The official Waymo OD metric (reference waymo_dataset.py:436-457,
        EVAL_METRIC 'waymo'). The detections and the ground truth are dumped
        as pickles in the estimator's input format. Where TensorFlow and the
        waymo-open-dataset package import, the metric then runs in process
        (`eval/waymo_official.py`): (text, {metric: value}); without them
        the result is the command that evaluates the pickles out of
        process."""
        out = Path(output_path or ".") / "waymo_official"
        out.mkdir(parents=True, exist_ok=True)
        gt_annos = [info["annos"] for info in self.infos]
        with open(out / "det_annos.pkl", "wb") as f:
            pickle.dump(det_annos, f)
        with open(out / "gt_annos.pkl", "wb") as f:
            pickle.dump(gt_annos, f)
        try:
            from waymo_open_dataset.metrics.python import (  # noqa: F401
                detection_metrics,
            )
        except ImportError:
            cmd = (
                "python -m pcdet.datasets.waymo.waymo_eval "
                f"--pred_infos {out / 'det_annos.pkl'} "
                f"--gt_infos {out / 'gt_annos.pkl'} "
                "--class_names Vehicle Pedestrian Cyclist --sampled_interval 1"
            )
            return (
                "waymo-open-dataset not importable; annos dumped for "
                f"out-of-process evaluation:\n  {cmd}\n",
                {"det_annos": str(out / "det_annos.pkl"),
                 "gt_annos": str(out / "gt_annos.pkl"),
                 "command": cmd},
            )
        from ..eval.waymo_official import waymo_detection_metrics

        ap_dict = waymo_detection_metrics(det_annos, gt_annos, class_names)
        text = "\n".join(f"{k}: {v:.4f}" for k, v in ap_dict.items())
        return text, ap_dict

    def evaluation(self, det_annos, class_names, **kwargs):
        if str(self.dataset_cfg.get("EVAL_METRIC", "kitti")) == "waymo":
            return self.waymo_official_eval(
                det_annos, class_names, kwargs.get("output_path")
            )
        from ..eval import kitti_eval

        def to_kitti(boxes, names, scores=None):
            return lidar_anno(boxes, [WAYMO_TO_KITTI.get(str(x), str(x)) for x in names],
                              scores)

        gt_annos = []
        for info in self.infos:
            annos = info["annos"]
            keep = np.asarray(annos["name"]) != "unknown"
            gt_annos.append(to_kitti(
                np.asarray(annos["gt_boxes_lidar"]).reshape(
                    -1, np.asarray(annos["gt_boxes_lidar"]).shape[-1]
                )[keep, :7],
                np.asarray(annos["name"])[keep],
            ))
        dt_annos = [to_kitti(a["boxes_lidar"], a["name"], a["score"])
                    for a in det_annos]
        kitti_classes = sorted(
            {WAYMO_TO_KITTI.get(c, c) for c in class_names} - {"Sign"}
        )
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos,
                                                   kitti_classes)
