"""Lyft Level-5 dataset (own copy of dfu3d_tpu/data/lyft_dataset.py; reference
pcdet/datasets/lyft/lyft_dataset.py + lyft_mAP_eval/lyft_eval.py).

Lyft ships nuScenes-format raw tables, so the dataset is the port's
NuScenesDataset with the Lyft competition metric: the mean AP over 3D-IoU
thresholds 0.5:0.05:0.95, greedy score-ordered matching per threshold
(lyft_eval.get_average_precisions).

Class names: the infos carry KITTI-style names (Car, Truck, ...), as
`create_nuscenes_infos` writes them; the Lyft configs name their classes in
lower case (car, truck, emergency_vehicle, ...). Here each info name whose
lower-case form the config names is read under that name, for training and
for the metric's ground truth. The JAX package compares the names as they
are and so keeps no gt box on those configs (ROADMAP Queue C), as with the
nuScenes cbgs configs. The metric reads the boxes' first 7 columns.
"""
from __future__ import annotations

import numpy as np

from ..eval.once_eval import iou3d_with_heading
from .nuscenes_dataset import NuScenesDataset

LYFT_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def lyft_average_precisions(gt_annos, det_annos, class_names,
                            iou_thresholds=LYFT_IOU_THRESHOLDS):
    """APs (num_thresholds, num_classes): greedy matching by descending score
    at each IoU threshold, AP = the 101-point interpolated precision (the
    Lyft devkit's protocol shape)."""
    aps = np.zeros((len(iou_thresholds), len(class_names)))
    for ci, cls in enumerate(class_names):
        # per sample, the class's boxes
        pairs = []
        total_gt = 0
        for g, d in zip(gt_annos, det_annos):
            gsel = np.asarray(g["name"]) == cls
            dsel = np.asarray(d["name"]) == cls
            gb = np.asarray(g["boxes_lidar"], np.float32).reshape(-1, 7)[gsel]
            db = np.asarray(d["boxes_lidar"], np.float32).reshape(-1, 7)[dsel]
            sc = np.asarray(d["score"])[dsel]
            total_gt += len(gb)
            iou = iou3d_with_heading(gb, db, with_heading=False)
            pairs.append((iou, sc))
        if total_gt == 0:
            continue
        for ti, thr in enumerate(iou_thresholds):
            tps, scores = [], []
            for iou, sc in pairs:
                order = np.argsort(-sc)
                taken = np.zeros(iou.shape[0], bool)
                for j in order:
                    scores.append(sc[j])
                    cand = np.where(~taken & (iou[:, j] >= thr))[0]
                    if len(cand):
                        best = cand[np.argmax(iou[cand, j])]
                        taken[best] = True
                        tps.append(1.0)
                    else:
                        tps.append(0.0)
            if not scores:
                continue
            order = np.argsort(-np.asarray(scores))
            tp = np.cumsum(np.asarray(tps)[order])
            fp = np.cumsum(1.0 - np.asarray(tps)[order])
            recall = tp / total_gt
            precision = tp / np.maximum(tp + fp, 1e-9)
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                mask = recall >= r
                ap += (precision[mask].max() if mask.any() else 0.0) / 101
            aps[ti, ci] = ap
    return aps


class LyftDataset(NuScenesDataset):
    """nuScenes-format tables; the Lyft mAP."""

    @staticmethod
    def _name_map(class_names):
        """A KITTI-style info name → the config's lower-case name of it."""
        return {n.capitalize(): n for n in (class_names or []) if n != n.capitalize()}

    def evaluation(self, det_annos, class_names, **kwargs):
        """The Lyft mAP over the boxes' first 7 columns: the infos' gt and the
        detections of a velocity head carry 9 (the JAX package hands them to
        the metric whole, which reads them 7 at a time)."""
        gt_annos = [
            {"name": self._cfg_names(info["gt_names"]),
             "boxes_lidar": np.asarray(info["gt_boxes"])[:, :7]}
            for info in self.infos
        ]
        det_annos = [{**a, "boxes_lidar": np.asarray(a["boxes_lidar"])[:, :7]}
                     for a in det_annos]
        aps = lyft_average_precisions(gt_annos, det_annos, class_names)
        ret = {}
        lines = ["Lyft mAP (IoU 0.5:0.05:0.95)"]
        for ci, cls in enumerate(class_names):
            ret[f"AP_{cls}"] = float(aps[:, ci].mean())
            lines.append(f"{cls}: {ret[f'AP_{cls}']:.4f}")
        ret["mAP"] = float(aps.mean())
        lines.append(f"mAP: {ret['mAP']:.4f}")
        return "\n".join(lines), ret
