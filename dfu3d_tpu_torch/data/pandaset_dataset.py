"""Pandaset and the converted-layout Argoverse 2 dataset (own copy of
dfu3d_tpu/data/pandaset_dataset.py; reference pcdet/datasets/pandaset/
pandaset_dataset.py and pcdet/datasets/argo2/argo2_dataset.py).

The vendor formats (pandas pkl.gz sensor frames, av2 feather files) are
converted out of process; these classes read the converted layout:

    points/<frame_id>.npy        (N, >=4) float32 lidar-frame points
    <INFO_PATH>                  [{frame_id, annos: {name, gt_boxes_lidar}}]

Evaluation is the KITTI protocol over lidar boxes with each dataset's class
map. `Argo2Dataset` here is the module's own converted-layout class, as in
the JAX package; the registry's "Argo2Dataset" is `data.argo2_dataset`'s, so
no registry name reaches this one (ROADMAP Queue C).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..eval.kitti_eval import lidar_anno
from .dataset import DatasetTemplate


class _ConvertedLidarDataset(DatasetTemplate):
    """What the converted-layout datasets share."""

    INFO_PREFIX = "converted"
    CLASS_MAP: dict = {}

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        self.infos = []
        for info_path in dataset_cfg.INFO_PATH.get(self.mode, []):
            p = Path(info_path)
            if not p.is_absolute():
                p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if logger:
            logger.info(
                f"{type(self).__name__}[{self.split}]: {len(self.infos)} frames"
            )

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * max(self.total_epochs, 1)
        return len(self.infos)

    def get_lidar(self, frame_id):
        return np.load(
            self.root_path / "points" / f"{frame_id}.npy"
        ).astype(np.float32)

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = self.infos[index]
        annos = info.get("annos", {})
        input_dict = {
            "frame_id": info["frame_id"],
            "points": self.get_lidar(info["frame_id"]),
            "gt_boxes": np.asarray(
                annos.get("gt_boxes_lidar", np.zeros((0, 7))), np.float32
            ).reshape(-1, 7).copy(),
            "gt_names": np.asarray(annos.get("name", [])).copy(),
        }
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

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..eval import kitti_eval

        cmap = {**self.CLASS_MAP,
                **dict(self.dataset_cfg.get("MAP_CLASS_TO_KITTI", {}))}

        def to_kitti(boxes, names, scores=None):
            return lidar_anno(boxes, [cmap.get(str(x), str(x)) for x in names], scores)

        gt_annos = [
            to_kitti(info["annos"]["gt_boxes_lidar"], info["annos"]["name"])
            for info in self.infos
        ]
        dt_annos = [to_kitti(a["boxes_lidar"], a["name"], a["score"])
                    for a in det_annos]
        kitti_classes = sorted({cmap.get(c, c) for c in class_names})
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos,
                                                   kitti_classes)


class PandasetDataset(_ConvertedLidarDataset):
    INFO_PREFIX = "pandaset"
    CLASS_MAP = {"Car": "Car", "Pickup Truck": "Truck",
                 "Medium-sized Truck": "Truck", "Pedestrian": "Pedestrian",
                 "Bicycle": "Bicycle", "Motorcycle": "Motorcycle"}


class Argo2Dataset(_ConvertedLidarDataset):
    INFO_PREFIX = "argo2"
    CLASS_MAP = {"REGULAR_VEHICLE": "Car", "PEDESTRIAN": "Pedestrian",
                 "BICYCLIST": "Bicycle", "MOTORCYCLIST": "Motorcycle",
                 "LARGE_VEHICLE": "Truck", "BUS": "Bus"}
