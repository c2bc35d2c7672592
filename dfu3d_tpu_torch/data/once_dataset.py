"""ONCE dataset (own copy of dfu3d_tpu/data/once_dataset.py; reference
pcdet/datasets/once/once_dataset.py), without the devkit.

Reads the raw ONCE layout (data/<seq>/<seq>.json with the frames and their
annos, data/<seq>/lidar_roof/<frame>.bin clouds of 4 float32 columns and
ImageSets/<split>.txt sequence lists), builds the info pkls
(`create_once_infos`) and the gt database (`create_groundtruth_database`,
once_dbinfos_<split>.pkl), serves frames through DatasetTemplate and
evaluates with the ONCE protocol (`eval.once_eval`).
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate

ONCE_CLASSES = ["Car", "Bus", "Truck", "Pedestrian", "Cyclist"]


def read_once_lidar(path) -> np.ndarray:
    return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)


class ONCEDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        self.once_infos = []
        for info_path in dataset_cfg.INFO_PATH[self.mode]:
            p = Path(info_path)
            if not p.is_absolute():
                p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    infos = pickle.load(f)
                if self.split != "raw":  # labelled splits keep annotated frames
                    infos = [i for i in infos if "annos" in i]
                self.once_infos.extend(infos)
        if logger:
            logger.info(f"ONCEDataset[{self.split}]: {len(self.once_infos)} frames")

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.once_infos) * max(self.total_epochs, 1)
        return len(self.once_infos)

    def get_lidar(self, seq_id, frame_id):
        return read_once_lidar(
            self.root_path / "data" / seq_id / "lidar_roof" / f"{frame_id}.bin"
        )

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.once_infos)
        info = self.once_infos[index]
        points = self.get_lidar(info["sequence_id"], info["frame_id"])
        input_dict = {"frame_id": info["frame_id"], "points": points}
        if "annos" in info:
            input_dict["gt_names"] = np.asarray(info["annos"]["name"]).copy()
            input_dict["gt_boxes"] = np.asarray(
                info["annos"]["boxes_3d"], np.float32
            ).reshape(-1, 7).copy()
        data_dict = self.prepare_data(input_dict)
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        return data_dict

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        annos = []
        for i, box_dict in enumerate(pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, 7)
            labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)
            annos.append({
                "frame_id": batch_meta.frame_ids[i],
                "name": np.array([class_names[l - 1] for l in labels],
                                 dtype="<U32"),
                "score": np.asarray(box_dict["pred_scores"]),
                "boxes_3d": boxes,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..eval.once_eval import get_evaluation_results

        gt_annos = [
            {"name": np.asarray(info["annos"]["name"]),
             "boxes_3d": np.asarray(info["annos"]["boxes_3d"],
                                    np.float32).reshape(-1, 7)}
            for info in self.once_infos
        ]
        return get_evaluation_results(gt_annos, det_annos, class_names)

    def get_infos(self, sample_seq_list):
        """The raw layout's frames as info dicts (reference get_infos:155-292);
        an annotated frame without boxes is left out."""
        infos = []
        for seq in sample_seq_list:
            seq_path = self.root_path / "data" / seq
            with open(seq_path / f"{seq}.json") as f:
                seq_json = json.load(f)
            for frame in seq_json["frames"]:
                fid = frame["frame_id"]
                info = {
                    "sequence_id": seq,
                    "frame_id": fid,
                    "timestamp": int(fid),
                    "lidar": str(seq_path / "lidar_roof" / f"{fid}.bin"),
                    "pose": np.asarray(frame.get("pose", np.eye(4).tolist())),
                }
                if "annos" in frame:
                    boxes = np.asarray(frame["annos"]["boxes_3d"],
                                       np.float32).reshape(-1, 7)
                    if len(boxes) == 0:
                        continue
                    info["annos"] = {
                        "name": np.asarray(frame["annos"]["names"]),
                        "boxes_3d": boxes,
                    }
                infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None,
                                    split="train"):
        """Each gt box's points (centred on the box) as gt_database_<split>/
        <frame>_<name>_<k>.bin, and once_dbinfos_<split>.pkl (reference
        :294-345). Returns the pkl's path."""
        from . import np_geometry as npg

        db_path = self.root_path / f"gt_database_{split}"
        db_path.mkdir(parents=True, exist_ok=True)
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        all_db = {}
        for info in infos:
            if "annos" not in info:
                continue
            points = self.get_lidar(info["sequence_id"], info["frame_id"])
            boxes = np.asarray(info["annos"]["boxes_3d"]).reshape(-1, 7)
            names = np.asarray(info["annos"]["name"])
            inside = npg.points_in_boxes(points[:, :3], boxes)
            for k in range(len(boxes)):
                name = str(names[k])
                if used_classes and name not in used_classes:
                    continue
                obj = points[inside[:, k]]
                obj[:, :3] -= boxes[k, :3]
                fn = db_path / f"{info['frame_id']}_{name}_{k}.bin"
                obj.astype(np.float32).tofile(fn)
                all_db.setdefault(name, []).append({
                    "name": name, "path": str(fn.relative_to(self.root_path)),
                    "gt_idx": k, "box3d_lidar": boxes[k],
                    "num_points_in_gt": int(inside[:, k].sum()),
                })
        out = self.root_path / f"once_dbinfos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(all_db, f)
        return out


def create_once_infos(dataset_cfg, class_names, data_path, save_path,
                      splits=("train", "val"), logger=None):
    """once_infos_<split>.pkl under `save_path` for each split's sequences
    (ImageSets/<split>.txt under `data_path`). Returns the paths."""
    dataset = ONCEDataset(dataset_cfg, class_names, training=False,
                          root_path=data_path, logger=logger)
    out = []
    for split in splits:
        seq_file = Path(data_path) / "ImageSets" / f"{split}.txt"
        seqs = [s.strip() for s in seq_file.read_text().splitlines() if s.strip()]
        infos = dataset.get_infos(seqs)
        fn = Path(save_path) / f"once_infos_{split}.pkl"
        with open(fn, "wb") as f:
            pickle.dump(infos, f)
        out.append(fn)
        if logger:
            logger.info(f"ONCE infos [{split}]: {len(infos)} -> {fn}")
    return out
