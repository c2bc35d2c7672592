"""KITTI-format dataset — the DFU3D workhorse (used for nuScenes-in-KITTI-format).

Own copy of dfu3d_tpu/data/kitti_dataset.py, the camera image included (read
by `kitti_io.read_png`, as PIL's RGB conversion gives it). Behavioural parity with the reference's KittiDataset
(pcdet/datasets/kitti/kitti_dataset.py): info-pkl loading, FOV filtering,
empty-label tolerance (the DFU3D modification at :212-258), KITTI-format
prediction writing (:339-419), info/gt-database generation (:158-337), and
kitti-protocol evaluation (:421-432).
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..core.geometry.calibration import Calibration
from . import kitti_io, np_geometry as npg
from .dataset import DatasetTemplate


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names, training=training,
            root_path=root_path, logger=logger,
        )
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path  # KITTI-format dirs live at DATA_PATH

        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        if split_file.exists():
            self.sample_id_list = [x.strip() for x in open(split_file).readlines()]
        else:
            # fall back to enumerating the velodyne dir
            vel = self.root_split_path / "velodyne"
            self.sample_id_list = (
                sorted(p.stem for p in vel.glob("*.bin")) if vel.exists() else []
            )

        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        if self.logger:
            self.logger.info("Loading KITTI dataset")
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = Path(info_path)
            if not info_path.is_absolute():
                info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, "rb") as f:
                infos.extend(pickle.load(f))
        self.kitti_infos.extend(infos)
        if self.logger:
            self.logger.info(f"Total samples for KITTI dataset: {len(infos)}")

    def set_split(self, split):
        self.split = split
        split_file = self.root_path / "ImageSets" / (split + ".txt")
        if split_file.exists():
            self.sample_id_list = [x.strip() for x in open(split_file).readlines()]

    # --- per-frame getters ---

    def get_lidar(self, idx):
        if self.dataset_cfg.get("USE_VELODYNE_DEPTH", False):
            f = self.root_split_path / "velodyne_depth" / f"{idx}.npy"
            if f.exists():
                # densified fused cloud (N, 8): keep xyz + intensity layout
                fused = kitti_io.read_velodyne_depth_npy(f)
                return fused[:, :4]
        lidar_file = self.root_split_path / "velodyne" / f"{idx}.bin"
        return kitti_io.read_velodyne_bin(lidar_file)

    def get_lidar_depth(self, idx):
        """Densified fused cloud from the pseudo-box factory (velodyne_depth/*.npy)."""
        f = self.root_split_path / "velodyne_depth" / f"{idx}.npy"
        return kitti_io.read_velodyne_depth_npy(f)

    def get_image_shape(self, idx):
        return kitti_io.get_image_shape(self.root_split_path / "image_2" / f"{idx}.png")

    def get_image(self, idx):
        """(H, W, 3) float32 in [0, 1] (reference get_image,
        kitti_dataset.py:75-88), decoded by `kitti_io.read_png` as PIL's
        convert("RGB") gives it."""
        return kitti_io.read_png(self.root_split_path / "image_2" / f"{idx}.png").astype(
            np.float32) / 255.0

    def get_label(self, idx):
        label_dir = self.dataset_cfg.get("LABEL_DIR", "label_2")
        label_file = self.root_split_path / label_dir / f"{idx}.txt"
        if not label_file.exists():
            return []  # DFU3D empty-label tolerance (kitti_dataset.py:212-258)
        return kitti_io.get_objects_from_label(label_file)

    def get_calib(self, idx) -> Calibration:
        return Calibration(self.root_split_path / "calib" / f"{idx}.txt")

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / "planes" / f"{idx}.txt"
        if not plane_file.exists():
            return None
        with open(plane_file, "r") as f:
            lines = f.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """Mask of points projecting into the image (kitti_dataset.py:140-156)."""
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag_1 = np.logical_and(pts_img[:, 0] >= 0, pts_img[:, 0] < img_shape[1])
        val_flag_2 = np.logical_and(pts_img[:, 1] >= 0, pts_img[:, 1] < img_shape[0])
        val_flag_merge = np.logical_and(val_flag_1, val_flag_2)
        return np.logical_and(val_flag_merge, pts_rect_depth >= 0)

    # --- info / database generation ---

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        import concurrent.futures as futures

        def process_single_scene(sample_idx):
            info = {
                "point_cloud": {"num_features": 4, "lidar_idx": sample_idx},
                "image": {
                    "image_idx": sample_idx,
                    "image_shape": self.get_image_shape(sample_idx),
                },
            }
            calib = self.get_calib(sample_idx)
            P2 = np.concatenate([calib.P2, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
            R0_4x4 = np.zeros([4, 4], dtype=calib.R0.dtype)
            R0_4x4[3, 3] = 1.0
            R0_4x4[:3, :3] = calib.R0
            V2C_4x4 = np.concatenate([calib.V2C, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
            info["calib"] = {"P2": P2, "R0_rect": R0_4x4, "Tr_velo_to_cam": V2C_4x4}

            if has_label:
                obj_list = self.get_label(sample_idx)
                if len(obj_list) > 0:
                    annos = {
                        "name": np.array([o.cls_type for o in obj_list]),
                        "truncated": np.array([o.truncation for o in obj_list]),
                        "occluded": np.array([o.occlusion for o in obj_list]),
                        "alpha": np.array([o.alpha for o in obj_list]),
                        "bbox": np.stack([o.box2d for o in obj_list]),
                        "dimensions": np.array([[o.l, o.h, o.w] for o in obj_list]),
                        "location": np.stack([o.loc for o in obj_list]),
                        "rotation_y": np.array([o.ry for o in obj_list]),
                        "score": np.array([o.score for o in obj_list]),
                        "difficulty": np.array([o.level for o in obj_list], np.int32),
                    }
                    num_objects = len(
                        [o.cls_type for o in obj_list if o.cls_type != "DontCare"]
                    )
                    num_gt = len(annos["name"])
                    annos["index"] = np.array(
                        list(range(num_objects)) + [-1] * (num_gt - num_objects),
                        dtype=np.int32,
                    )
                    loc = annos["location"][:num_objects]
                    dims = annos["dimensions"][:num_objects]
                    rots = annos["rotation_y"][:num_objects]
                    if num_objects > 0:
                        loc_lidar = calib.rect_to_lidar(loc)
                        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
                        loc_lidar[:, 2] += h[:, 0] / 2
                        gt_boxes_lidar = np.concatenate(
                            [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., np.newaxis])],
                            axis=1,
                        )
                    else:
                        gt_boxes_lidar = np.zeros((0, 7))
                    annos["gt_boxes_lidar"] = gt_boxes_lidar
                else:
                    # DFU3D empty-label tolerance: emit empty annos, keep the frame
                    annos = {
                        "name": np.array([]), "truncated": np.array([]),
                        "occluded": np.array([]), "alpha": np.array([]),
                        "bbox": np.zeros((0, 4)), "dimensions": np.zeros((0, 3)),
                        "location": np.zeros((0, 3)), "rotation_y": np.array([]),
                        "score": np.array([]), "difficulty": np.zeros((0,), np.int32),
                        "index": np.zeros((0,), np.int32),
                        "gt_boxes_lidar": np.zeros((0, 7)),
                    }
                    gt_boxes_lidar = annos["gt_boxes_lidar"]
                    num_gt = num_objects = 0
                info["annos"] = annos

                if count_inside_pts and num_gt > 0:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    fov_flag = self.get_fov_flag(
                        pts_rect, info["image"]["image_shape"], calib
                    )
                    pts_fov = points[fov_flag]
                    num_points_in_gt = -np.ones(num_gt, dtype=np.int32)
                    if num_objects > 0:
                        inside = npg.points_in_boxes(
                            pts_fov[:, 0:3], gt_boxes_lidar[:num_objects]
                        )
                        num_points_in_gt[:num_objects] = inside.sum(axis=0)
                    annos["num_points_in_gt"] = num_points_in_gt
            return info

        ids = sample_id_list if sample_id_list is not None else self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_scene, ids)
        return list(infos)

    def create_groundtruth_database(self, info_path, save_path, used_classes=None,
                                    split="train", suffix=""):
        """Carve per-object point clips + dbinfos pkl (kitti_dataset.py:284-337)."""
        database_save_path = Path(save_path) / f"gt_database{suffix}"
        db_info_save_path = Path(save_path) / f"kitti_dbinfos_{split}{suffix}.pkl"
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}

        with open(info_path, "rb") as f:
            infos = pickle.load(f)

        for k, info in enumerate(infos):
            sample_idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(sample_idx)
            annos = info["annos"]
            gt_boxes = annos["gt_boxes_lidar"]
            names = annos["name"]
            difficulty = annos["difficulty"]
            bbox = annos["bbox"]
            num_obj = len(gt_boxes)
            if num_obj == 0:
                continue
            inside = npg.points_in_boxes(points[:, 0:3], gt_boxes)
            for i in range(num_obj):
                filename = f"{sample_idx}_{names[i]}_{i}.bin"
                filepath = database_save_path / filename
                gt_points = points[inside[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(str(filepath))

                if used_classes is not None and names[i] not in used_classes:
                    continue
                db_info = {
                    "name": names[i],
                    "path": str(filepath.relative_to(Path(save_path))),
                    "image_idx": sample_idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(inside[:, i].sum()),
                    "difficulty": int(difficulty[i]) if len(difficulty) > i else 0,
                    "bbox": bbox[i] if len(bbox) > i else np.zeros(4),
                    "score": float(annos["score"][i]) if len(annos["score"]) > i else -1.0,
                }
                all_db_infos.setdefault(names[i], []).append(db_info)

        for key, val in all_db_infos.items():
            if self.logger:
                self.logger.info(f"Database {key}: {len(val)}")
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_save_path

    # --- prediction / evaluation ---

    @staticmethod
    def _empty_pred(num_samples):
        """Template prediction record (kitti_dataset.py:355-366 field layout)."""
        return {
            "name": np.zeros(num_samples, dtype="<U32"),
            "truncated": np.zeros(num_samples),
            "occluded": np.zeros(num_samples),
            "alpha": np.zeros(num_samples),
            "bbox": np.zeros([num_samples, 4]),
            "dimensions": np.zeros([num_samples, 3]),
            "location": np.zeros([num_samples, 3]),
            "rotation_y": np.zeros(num_samples),
            "score": np.zeros(num_samples),
            "boxes_lidar": np.zeros([num_samples, 7]),
        }

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        """Per-frame predictions → KITTI-format annos (kitti_dataset.py:339-419).

        Args:
            batch_meta: BatchMeta with frame_ids, calibs, image_shapes.
            pred_dicts: list of dicts with numpy 'pred_boxes' (N, 7),
                'pred_scores' (N,), 'pred_labels' (N,) 1-based.
        """
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_meta.frame_ids[index]
            calib = batch_meta.calibs[index]
            image_shape = batch_meta.image_shapes[index]

            pred_boxes = np.asarray(box_dict["pred_boxes"])
            pred_scores = np.asarray(box_dict["pred_scores"])
            pred_labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)

            single = self._empty_pred(pred_boxes.shape[0])
            if pred_boxes.shape[0] > 0:
                # lidar center boxes → camera bottom-center boxes
                xyz = pred_boxes[:, 0:3].copy()
                l, w, h = pred_boxes[:, 3:4], pred_boxes[:, 4:5], pred_boxes[:, 5:6]
                xyz[:, 2] -= h[:, 0] / 2
                xyz_cam = calib.lidar_to_rect(xyz)
                ry = -pred_boxes[:, 6:7] - np.pi / 2
                boxes_camera = np.concatenate([xyz_cam, l, h, w, ry], axis=1)

                corners_cam = self._camera_corners(boxes_camera)
                boxes_img, _ = calib.corners3d_to_img_boxes(corners_cam)
                if image_shape is not None:
                    boxes_img[:, 0] = np.clip(boxes_img[:, 0], 0, image_shape[1] - 1)
                    boxes_img[:, 1] = np.clip(boxes_img[:, 1], 0, image_shape[0] - 1)
                    boxes_img[:, 2] = np.clip(boxes_img[:, 2], 0, image_shape[1] - 1)
                    boxes_img[:, 3] = np.clip(boxes_img[:, 3], 0, image_shape[0] - 1)

                single["name"] = np.array(class_names)[pred_labels - 1]
                single["alpha"] = (
                    -np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0]) + boxes_camera[:, 6]
                )
                single["bbox"] = boxes_img
                single["dimensions"] = boxes_camera[:, 3:6]
                single["location"] = boxes_camera[:, 0:3]
                single["rotation_y"] = boxes_camera[:, 6]
                single["score"] = pred_scores
                single["boxes_lidar"] = pred_boxes[:, 0:7]

            single["frame_id"] = frame_id
            annos.append(single)

            if output_path is not None:
                kitti_io.write_kitti_label_file(
                    Path(output_path) / f"{frame_id}.txt", single
                )
        return annos

    @staticmethod
    def _camera_corners(boxes_camera):
        """(N, 7) [x,y,z,l,h,w,ry] camera boxes → (N, 8, 3) corners (bottom-center)."""
        l, h, w = boxes_camera[:, 3], boxes_camera[:, 4], boxes_camera[:, 5]
        sx = np.stack([l, l, -l, -l, l, l, -l, -l], axis=1) / 2.0
        sz = np.stack([w, -w, -w, w, w, -w, -w, w], axis=1) / 2.0
        sy = np.zeros_like(sx)
        sy[:, 4:8] = -h[:, None]
        ry = boxes_camera[:, 6]
        c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
        x = sx * c + sz * s
        z = -sx * s + sz * c
        corners = np.stack([x, sy, z], axis=-1)
        return corners + boxes_camera[:, None, 0:3]

    def evaluation(self, det_annos, class_names, **kwargs):
        if "annos" not in (self.kitti_infos[0] or {}):
            return "no ground-truth annotations available", {}
        from ..eval import kitti_eval

        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info["annos"]) for info in self.kitti_infos]
        ap_result_str, ap_dict = kitti_eval.get_official_eval_result(
            eval_gt_annos, eval_det_annos, class_names,
            use_native=kwargs.get("use_native", True),
        )
        return ap_result_str, ap_dict

    # --- iteration ---

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * max(self.total_epochs, 1)
        return len(self.kitti_infos)

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = self.get_calib(sample_idx)
        get_item_list = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])

        input_dict = {"frame_id": sample_idx, "calib": calib}

        if "annos" in info:
            annos = info["annos"]
            keep = annos["name"] != "DontCare"
            loc = annos["location"][keep]
            dims = annos["dimensions"][keep]
            rots = annos["rotation_y"][keep]
            gt_names = annos["name"][keep]
            if len(loc):
                gt_boxes_camera = np.concatenate(
                    [loc, dims, rots[..., np.newaxis]], axis=1
                ).astype(np.float32)
                xyz_lidar = calib.rect_to_lidar(gt_boxes_camera[:, 0:3])
                l, h, w = (
                    gt_boxes_camera[:, 3:4],
                    gt_boxes_camera[:, 4:5],
                    gt_boxes_camera[:, 5:6],
                )
                xyz_lidar[:, 2] += h[:, 0] / 2
                gt_boxes_lidar = np.concatenate(
                    [xyz_lidar, l, w, h, -(gt_boxes_camera[:, 6:7] + np.pi / 2)], axis=1
                )
            else:
                gt_boxes_lidar = np.zeros((0, 7), dtype=np.float32)
            input_dict.update({"gt_names": gt_names, "gt_boxes": gt_boxes_lidar})
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict["road_plane"] = road_plane

        if "points" in get_item_list:
            points = self.get_lidar(sample_idx)
            if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
                pts_rect = calib.lidar_to_rect(points[:, 0:3])
                fov_flag = self.get_fov_flag(pts_rect, img_shape, calib)
                points = points[fov_flag]
            input_dict["points"] = points

        # multimodal items (reference kitti_dataset.py:480-497): the image as
        # float [0, 1] and the camera-frame 2D gt boxes, read by the camera
        # models and the sampler's image-domain copy-paste
        if "images" in get_item_list:
            input_dict["images"] = self.get_image(sample_idx)
        if "gt_boxes2d" in get_item_list and "annos" in info:
            input_dict["gt_boxes2d"] = info["annos"]["bbox"][
                info["annos"]["name"] != "DontCare"
            ].astype(np.float32)

        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        data_dict["image_shape"] = img_shape
        return data_dict


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path,
                       splits=("train", "val"), suffix="", logger=None):
    """Build info pkls for each split (reference create_kitti_infos:504-523)."""
    dataset = KittiDataset(
        dataset_cfg=dataset_cfg, class_names=class_names, root_path=data_path,
        training=False, logger=logger,
    )
    out_paths = []
    for split in splits:
        dataset.set_split(split)
        infos = dataset.get_infos(num_workers=8, has_label=True, count_inside_pts=True)
        filename = Path(save_path) / f"kitti_infos_{split}{suffix}.pkl"
        with open(filename, "wb") as f:
            pickle.dump(infos, f)
        out_paths.append(filename)
        if logger:
            logger.info(f"info file saved to {filename} ({len(infos)} frames)")
    return out_paths


class KittiKittiDataset(KittiDataset):
    """Real-KITTI twin (reference: kitti/kittikitti_dataset.py — a
    near-duplicate of KittiDataset for real-KITTI experiments; here the same
    class, kept as a registry alias)."""
