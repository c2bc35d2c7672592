"""Custom dataset (own copy of dfu3d_tpu/data/custom_dataset.py; reference
pcdet/datasets/custom/custom_dataset.py): a KITTI-like layout for own data,

    points/<id>.npy            (N, 4) float32 [x y z intensity]
    labels/<id>.txt            lines `x y z dx dy dz heading name`
    ImageSets/<split>.txt      sample ids

with the infos of `create_custom_infos` (custom_infos_<split>.pkl) and the
KITTI protocol over lidar boxes through MAP_CLASS_TO_KITTI.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..eval.kitti_eval import lidar_anno
from .dataset import DatasetTemplate


class CustomDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = (
            [x.strip() for x in split_file.read_text().splitlines() if x.strip()]
            if split_file.exists() else []
        )
        self.custom_infos = []
        for info_path in dataset_cfg.INFO_PATH.get(self.mode, []):
            p = Path(info_path)
            if not p.is_absolute():
                p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.custom_infos.extend(pickle.load(f))
        if logger:
            logger.info(f"CustomDataset[{self.split}]: "
                        f"{len(self.custom_infos) or len(self.sample_id_list)} samples")

    def get_lidar(self, idx):
        return np.load(self.root_path / "points" / f"{idx}.npy").astype(np.float32)

    def get_label(self, idx):
        lines = (self.root_path / "labels" / f"{idx}.txt").read_text().splitlines()
        boxes, names = [], []
        for line in lines:
            parts = line.strip().split()
            if len(parts) < 8:
                continue
            boxes.append([float(v) for v in parts[:7]])
            names.append(parts[7])
        return (np.asarray(boxes, np.float32).reshape(-1, 7),
                np.asarray(names))

    def __len__(self):
        n = len(self.custom_infos) or len(self.sample_id_list)
        if self._merge_all_iters_to_one_epoch:
            return n * max(self.total_epochs, 1)
        return n

    def __getitem__(self, index, _retry=0):
        n = len(self.custom_infos) or len(self.sample_id_list)
        if self._merge_all_iters_to_one_epoch:
            index = index % n
        if self.custom_infos:
            info = self.custom_infos[index]
            idx = info["point_cloud"]["lidar_idx"]
            annos = info.get("annos", {})
            boxes = np.asarray(annos.get("gt_boxes_lidar",
                                         np.zeros((0, 7))), np.float32)
            names = np.asarray(annos.get("name", []))
        else:
            idx = self.sample_id_list[index]
            boxes, names = self.get_label(idx)
        input_dict = {
            "frame_id": idx,
            "points": self.get_lidar(idx),
            "gt_boxes": boxes.copy(),
            "gt_names": names.copy(),
        }
        data_dict = self.prepare_data(input_dict)
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        return data_dict

    def get_infos(self, class_names, sample_id_list=None):
        infos = []
        for idx in (sample_id_list or self.sample_id_list):
            boxes, names = self.get_label(idx)
            infos.append({
                "point_cloud": {"lidar_idx": idx,
                                "num_features": 4},
                "annos": {"name": names, "gt_boxes_lidar": boxes},
            })
        return infos

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
        """The KITTI protocol over lidar boxes (reference :113-140, through
        kitti_utils.transform_annotations_to_kitti_format)."""
        from ..eval import kitti_eval

        name_map = dict(self.dataset_cfg.get("MAP_CLASS_TO_KITTI", {}))

        def to_kitti(boxes, names, scores=None):
            return lidar_anno(boxes, [name_map.get(str(x), str(x)) for x in names], scores)

        gt_annos = [
            to_kitti(info["annos"]["gt_boxes_lidar"], info["annos"]["name"])
            for info in self.custom_infos
        ]
        dt_annos = [
            to_kitti(a["boxes_lidar"], a["name"], a["score"])
            for a in det_annos
        ]
        kitti_classes = sorted(
            {name_map.get(c, c) for c in class_names}
        )
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos,
                                                   kitti_classes)


def create_custom_infos(dataset_cfg, class_names, data_path, save_path,
                        splits=("train", "val"), logger=None):
    """custom_infos_<split>.pkl under `save_path` for each split. Returns the
    paths."""
    out = []
    for split in splits:
        cfg = type(dataset_cfg)(dataset_cfg)
        cfg["DATA_SPLIT"] = {"train": split, "test": split}
        ds = CustomDataset(cfg, class_names, training=False,
                           root_path=data_path, logger=logger)
        infos = ds.get_infos(class_names)
        fn = Path(save_path) / f"custom_infos_{split}.pkl"
        with open(fn, "wb") as f:
            pickle.dump(infos, f)
        out.append(fn)
    return out
