"""GT-database paste sampling ("gt_sampling" augmentation), LiDAR only.

Own copy of dfu3d_tpu/data/database_sampler.py, itself at behavioural parity
with the reference's DataBaseSampler (pcdet/datasets/augmentor/
database_sampler.py): class-balanced groups with epoch-persistent shuffled
pointers (:129-147), min-points/difficulty filtering, LIMIT_WHOLE_SCENE,
rotated-BEV collision rejection against scene gt and among samples
(:364-443), object point loading from per-object .bin files, and removal of
scene points inside pasted boxes. The image-domain copy-paste
(IMG_AUG_TYPE) comes with the image branch; a config that asks for it
raises.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from . import np_geometry as npg


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None, rng=None):
        if sampler_cfg.get("IMG_AUG_TYPE", None) is not None:
            raise NotImplementedError(
                f"gt_sampling with IMG_AUG_TYPE {sampler_cfg.IMG_AUG_TYPE!r} needs the image "
                "branch, which is not ported yet (ROADMAP Queue A item 6: models/image/*)")
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random.RandomState()

        self.db_infos = {name: [] for name in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = Path(db_info_path)
            if not path.is_absolute():
                path = self.root_path / db_info_path
            with open(path, "rb") as f:
                infos = pickle.load(f)
                for name in class_names:
                    if name in infos:
                        self.db_infos[name].extend(infos[name])

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        self.sample_groups = {}
        self.sample_class_num = {}
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)
            self.sample_groups[class_name] = {
                "sample_num": int(sample_num),
                "pointer": len(self.db_infos.get(class_name, [])),
                "indices": np.arange(len(self.db_infos.get(class_name, []))),
            }

    # --- PREPARE filters (names are config keys, reference :100-127) ---

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name] if info["num_points_in_gt"] >= min_num
                ]
        return db_infos

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        for key, dinfos in db_infos.items():
            db_infos[key] = [
                info for info in dinfos if info["difficulty"] not in removed_difficulty
            ]
        return db_infos

    # --- sampling ---

    def sample_with_fixed_number(self, class_name, sample_group):
        sample_num = int(sample_group["sample_num"])
        pointer, indices = sample_group["pointer"], sample_group["indices"]
        infos = self.db_infos[class_name]
        if len(infos) == 0:
            return []
        if pointer + sample_num >= len(infos):
            indices = self.rng.permutation(len(infos))
            pointer = 0
        sampled = [infos[idx] for idx in indices[pointer : pointer + sample_num]]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    def _load_obj_points(self, info):
        file_path = self.root_path / info["path"]
        num_feat = self.sampler_cfg.get("NUM_POINT_FEATURES", 4)
        obj_points = np.fromfile(str(file_path), dtype=np.float32).reshape(-1, num_feat)
        obj_points = obj_points.copy()
        obj_points[:, :3] += info["box3d_lidar"][:3].astype(np.float32)
        return obj_points

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes, total_valid_sampled):
        gt_boxes_mask = data_dict["gt_boxes_mask"]
        gt_boxes = data_dict["gt_boxes"][gt_boxes_mask]
        gt_names = data_dict["gt_names"][gt_boxes_mask]
        points = data_dict["points"]

        obj_points_list = [self._load_obj_points(info) for info in total_valid_sampled]
        sampled_gt_names = np.array([info["name"] for info in total_valid_sampled])

        if self.sampler_cfg.get("REMOVE_EXTRA_WIDTH", None) is not None:
            extra = np.asarray(self.sampler_cfg.REMOVE_EXTRA_WIDTH)
            enlarged = sampled_gt_boxes.copy()
            enlarged[:, 3:6] += extra
        else:
            enlarged = sampled_gt_boxes
        points = npg.remove_points_in_boxes(points, enlarged)

        if obj_points_list:
            obj_points = np.concatenate(obj_points_list, axis=0)
            if obj_points.shape[1] != points.shape[1]:
                # pad/truncate feature channels to scene layout
                if obj_points.shape[1] < points.shape[1]:
                    pad = np.zeros(
                        (obj_points.shape[0], points.shape[1] - obj_points.shape[1]),
                        dtype=obj_points.dtype,
                    )
                    obj_points = np.concatenate([obj_points, pad], axis=1)
                else:
                    obj_points = obj_points[:, : points.shape[1]]
            points = np.concatenate([obj_points, points], axis=0)

        sampled = sampled_gt_boxes[:, : gt_boxes.shape[1]]
        if sampled.shape[1] < gt_boxes.shape[1]:
            # 7-dim database clips into a velocity-width scene: vel = 0
            sampled = np.concatenate(
                [sampled, np.zeros((len(sampled), gt_boxes.shape[1]
                                    - sampled.shape[1]), sampled.dtype)],
                axis=1,
            )
        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled], axis=0)
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_gt_names], axis=0)
        data_dict["points"] = points
        data_dict.pop("gt_boxes_mask")
        return data_dict

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled = []
        sampled_boxes_all = np.zeros((0, gt_boxes.shape[1] if gt_boxes.size else 7), np.float32)

        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(class_name == gt_names))
                sample_group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if sample_group["sample_num"] <= 0:
                continue
            sampled_dicts = self.sample_with_fixed_number(class_name, sample_group)
            if not sampled_dicts:
                continue
            sampled_boxes = np.stack(
                [x["box3d_lidar"] for x in sampled_dicts], axis=0
            ).astype(np.float32)

            # collision rejection: no overlap with existing boxes nor among new ones
            iou_existing = npg.pairwise_iou_bev(
                sampled_boxes[:, 0:7], existed_boxes[:, 0:7]
            ) if len(existed_boxes) else np.zeros((len(sampled_boxes), 1))
            iou_self = npg.pairwise_iou_bev(sampled_boxes[:, 0:7], sampled_boxes[:, 0:7])
            iou_self[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
            keep = (iou_existing.max(axis=1) == 0) & (iou_self.max(axis=1) == 0)

            valid_sampled = [x for x, k in zip(sampled_dicts, keep) if k]
            valid_boxes = sampled_boxes[keep]
            if valid_boxes.shape[1] < existed_boxes.shape[1]:
                pad = np.zeros(
                    (len(valid_boxes), existed_boxes.shape[1] - valid_boxes.shape[1]),
                    np.float32,
                )
                valid_boxes_padded = np.concatenate([valid_boxes, pad], axis=1)
            else:
                valid_boxes_padded = valid_boxes[:, : existed_boxes.shape[1]]
            existed_boxes = np.concatenate([existed_boxes, valid_boxes_padded], axis=0)
            sampled_boxes_all = np.concatenate(
                [sampled_boxes_all, valid_boxes_padded], axis=0
            )
            total_valid_sampled.extend(valid_sampled)

        if total_valid_sampled:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_boxes_all, total_valid_sampled)
        else:
            data_dict.pop("gt_boxes_mask", None)
        return data_dict
