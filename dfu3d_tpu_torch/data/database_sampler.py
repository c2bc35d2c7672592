"""GT-database paste sampling ("gt_sampling" augmentation).

Own copy of dfu3d_tpu/data/database_sampler.py, itself at behavioural parity
with the reference's DataBaseSampler (pcdet/datasets/augmentor/
database_sampler.py): class-balanced groups with epoch-persistent shuffled
pointers (:129-147), min-points/difficulty filtering, LIMIT_WHOLE_SCENE,
rotated-BEV collision rejection against scene gt and among samples
(:364-443), object point loading from per-object .bin files, and removal of
scene points inside pasted boxes; with IMG_AUG_TYPE kitti on frames that
carry an image, the image-domain copy-paste (JAX database_sampler.py:108-320,
reference :168-305): the sampled boxes' 2D projections filtered at
IMG_AUG_IOU_THRESH against the scene's 2D gt and each other, each sampled
object's crop cut from its source frame's image (read by
`kitti_io.read_png`) and its points moved into the target frame's camera
geometry, the crops pasted far to near, and the points that the pastes
occlude dropped.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..core.geometry.calibration import Calibration
from . import kitti_io, np_geometry as npg


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None, rng=None):
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

        # the image-domain copy-paste of multimodal configs (IMG_AUG_TYPE: kitti)
        self.img_aug_type = sampler_cfg.get("IMG_AUG_TYPE", None)
        self.img_aug_iou_thresh = float(sampler_cfg.get("IMG_AUG_IOU_THRESH", 0.5))
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

    # --- image-domain copy-paste (JAX database_sampler.py:108-250) ---

    @staticmethod
    def _iou_2d(a, b):
        """Pairwise IoU of (N, 4) / (M, 4) pixel boxes [x1 y1 x2 y2]."""
        if len(a) == 0 or len(b) == 0:
            return np.zeros((len(a), len(b)), np.float32)
        x1 = np.maximum(a[:, None, 0], b[None, :, 0])
        y1 = np.maximum(a[:, None, 1], b[None, :, 1])
        x2 = np.minimum(a[:, None, 2], b[None, :, 2])
        y2 = np.minimum(a[:, None, 3], b[None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-6)

    def _project_boxes2d(self, boxes3d, calib, img_shape):
        """3D lidar boxes → their image boxes, clipped to the image
        (sample_gt_boxes_2d_kitti)."""
        corners = npg.boxes_to_corners_3d(boxes3d[:, :7])
        pts_rect = calib.lidar_to_rect(corners.reshape(-1, 3))
        boxes2d, _ = calib.corners3d_to_img_boxes(pts_rect.reshape(-1, 8, 3))
        boxes2d[:, 0::2] = np.clip(boxes2d[:, 0::2], 0, img_shape[1] - 1)
        boxes2d[:, 1::2] = np.clip(boxes2d[:, 1::2], 0, img_shape[0] - 1)
        return boxes2d.astype(np.float32)

    def _sample_boxes_2d(self, data_dict, sampled_boxes, valid_mask):
        """The sampled boxes' 2D projections and which to keep: 2D IoU below
        IMG_AUG_IOU_THRESH against the scene's 2D gt boxes (against each
        other where the scene has none) and among themselves, and
        `valid_mask` (reference sample_gt_boxes_2d_kitti :283-305)."""
        img_shape = data_dict["images"].shape[:2]
        boxes2d = self._project_boxes2d(sampled_boxes, data_dict["calib"], img_shape)
        existed = data_dict.get("gt_boxes2d", np.zeros((0, 4), np.float32))
        iou1 = self._iou_2d(boxes2d, existed)
        iou2 = self._iou_2d(boxes2d, boxes2d)
        iou2[range(len(boxes2d)), range(len(boxes2d))] = 0
        iou1 = iou1 if iou1.shape[1] > 0 else iou2
        ok = ((iou1.max(axis=1) < self.img_aug_iou_thresh)
              & (iou2.max(axis=1) < self.img_aug_iou_thresh) & valid_mask)
        return boxes2d, ok

    def _collect_image_crop(self, info, data_dict, obj_points, box2d_new):
        """A sampled object's points moved into the target frame's camera
        geometry (through its source frame's calib, where the root has it)
        and its image crop cut from the source frame's image around the
        source 2D box's centre at the new box's size, the paste box shrunk
        where the crop meets the source image's border (reference
        collect_image_crops_kitti :235-280; as in the JAX package, the 3D
        box stays as sampled). Returns (paste box, crop, points)."""
        calib_t = data_dict["calib"]
        src_calib_f = self.root_path / "calib" / f"{info['image_idx']}.txt"
        if src_calib_f.exists():
            src_calib = Calibration(str(src_calib_f))
            pts2d, depth = src_calib.lidar_to_img(obj_points[:, :3])
            rect = calib_t.img_to_rect(pts2d[:, 0], pts2d[:, 1], depth)
            obj_points = obj_points.copy()
            obj_points[:, :3] = calib_t.rect_to_lidar(rect)

        img_f = self.root_path / "image_2" / f"{info['image_idx']}.png"
        raw = kitti_io.read_png(img_f).astype(np.float32) / 255.0
        raw_center = np.asarray(info["bbox"], np.float32).reshape(2, 2).mean(0)
        new_box = box2d_new.astype(np.int64)
        shape = np.array([new_box[2] - new_box[0], new_box[3] - new_box[1]])
        raw_box = np.concatenate([raw_center - shape / 2, raw_center + shape / 2]).astype(np.int64)
        raw_box[0::2] = np.clip(raw_box[0::2], 0, raw.shape[1])
        raw_box[1::2] = np.clip(raw_box[1::2], 0, raw.shape[0])
        if (raw_box[2] - raw_box[0]) != shape[0] or (raw_box[3] - raw_box[1]) != shape[1]:
            # the source crop meets the image border: shrink the paste box
            new_center = new_box.reshape(2, 2).mean(0)
            shape = np.array([raw_box[2] - raw_box[0], raw_box[3] - raw_box[1]])
            new_box = np.concatenate([new_center - shape / 2,
                                      new_center + shape / 2]).astype(np.int64)
        crop = raw[raw_box[1]:raw_box[3], raw_box[0]:raw_box[2]]
        return new_box, crop, obj_points

    def _copy_paste_to_image(self, data_dict, crops, boxes2d, gt_number, point_obj_idx):
        """Every object's crop pasted far to near (by box x, so the nearer
        overwrite), then the points kept that a pasted object owns or that
        lie on an unpasted background pixel or on a scene object's own
        pixel (reference copy_paste_to_image_kitti :168-233, the
        'by_depth' / 'annotation' path)."""
        image = data_dict["images"].copy()
        boxes3d = data_dict["gt_boxes"]
        h, w = image.shape[:2]
        order = np.argsort(boxes3d[:, 0])[::-1]

        paste_mask = -255 * np.ones((h, w), np.int64)
        fg_mask = np.zeros((h, w), np.int64)
        for o in order:
            bx = boxes2d[o].astype(np.int64)
            crop = crops[o]
            ch = min(bx[3], h) - bx[1]
            cw = min(bx[2], w) - bx[0]
            if ch <= 0 or cw <= 0 or crop.size == 0:
                continue
            image[bx[1]:bx[1] + ch, bx[0]:bx[0] + cw] = crop[:ch, :cw]
            paste_mask[bx[1]:bx[1] + ch, bx[0]:bx[0] + cw] = o
            if o < gt_number:
                fg_mask[bx[1]:bx[1] + ch, bx[0]:bx[0] + cw] = 1
        data_dict["images"] = image

        points = data_dict["points"]
        pts2d, _ = data_dict["calib"].lidar_to_img(points[:, :3])
        px = np.clip(pts2d[:, 0], 0, w - 1).astype(np.int64)
        py = np.clip(pts2d[:, 1], 0, h - 1).astype(np.int64)
        owner = paste_mask[py, px]
        new_mask = owner == (point_obj_idx + gt_number)
        raw_fg = (fg_mask == 1) & (paste_mask >= 0) & (paste_mask < gt_number)
        raw_bg = (fg_mask == 0) & (paste_mask < 0)
        raw_mask = (raw_fg[py, px] | raw_bg[py, px]) & (point_obj_idx < 0)
        data_dict["points"] = points[new_mask | raw_mask]
        return data_dict

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes, total_valid_sampled,
                                   sampled_boxes2d=None):
        gt_boxes_mask = data_dict["gt_boxes_mask"]
        gt_boxes = data_dict["gt_boxes"][gt_boxes_mask]
        gt_names = data_dict["gt_names"][gt_boxes_mask]
        points = data_dict["points"]

        obj_points_list = [self._load_obj_points(info) for info in total_valid_sampled]
        sampled_gt_names = np.array([info["name"] for info in total_valid_sampled])

        img_aug = (self.img_aug_type == "kitti" and sampled_boxes2d is not None
                   and data_dict.get("images", None) is not None)
        sampled_crops = []
        if img_aug:
            final_boxes2d = sampled_boxes2d.copy()
            for i, info in enumerate(total_valid_sampled):
                new_box, crop, pts = self._collect_image_crop(
                    info, data_dict, obj_points_list[i], sampled_boxes2d[i])
                final_boxes2d[i] = new_box
                sampled_crops.append(crop)
                obj_points_list[i] = pts

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
        if img_aug:
            gt2d = data_dict.get("gt_boxes2d", np.zeros((0, 4), np.float32))
            gt2d = gt2d[gt_boxes_mask] if len(gt2d) == len(gt_boxes_mask) else gt2d
            gt_number = len(gt_boxes)
            image = data_dict["images"]
            gt_crops = [image[int(b[1]):int(b[3]), int(b[0]):int(b[2])] for b in gt2d]
            all_boxes2d = np.concatenate([gt2d.reshape(-1, 4), final_boxes2d.reshape(-1, 4)],
                                         axis=0)
            point_obj_idx = np.concatenate(
                [np.full(len(p), i, np.int64) for i, p in enumerate(obj_points_list)]
                + [np.full(len(points) - sum(len(p) for p in obj_points_list), -1, np.int64)])
            data_dict = self._copy_paste_to_image(data_dict, gt_crops + sampled_crops,
                                                  all_boxes2d, gt_number, point_obj_idx)
            data_dict["gt_boxes2d"] = all_boxes2d.astype(np.float32)
        data_dict.pop("gt_boxes_mask")
        return data_dict

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled = []
        sampled_boxes_all = np.zeros((0, gt_boxes.shape[1] if gt_boxes.size else 7), np.float32)
        sampled_boxes2d_all = np.zeros((0, 4), np.float32)
        img_aug = self.img_aug_type == "kitti" and data_dict.get("images") is not None

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
            if img_aug:
                boxes2d, keep = self._sample_boxes_2d(data_dict, sampled_boxes, keep)
                sampled_boxes2d_all = np.concatenate([sampled_boxes2d_all, boxes2d[keep]], axis=0)

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
                data_dict, sampled_boxes_all, total_valid_sampled,
                sampled_boxes2d=sampled_boxes2d_all if img_aug else None)
        else:
            data_dict.pop("gt_boxes_mask", None)
        return data_dict
