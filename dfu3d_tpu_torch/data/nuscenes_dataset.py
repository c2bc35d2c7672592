"""nuScenes from disk (own copy of dfu3d_tpu/data/nuscenes_dataset.py;
reference pcdet/datasets/nuscenes/nuscenes_dataset.py), devkit-free over the
raw-table reader `data.nuscenes_tables`.

`create_nuscenes_infos` builds the info list from the raw JSON tables: boxes
in the key frame's LiDAR frame with their lidar-frame velocity (9 columns,
nan where a track has no neighbour), KITTI-style class names, the
lidar → global transform, and up to MAX_SWEEPS - 1 earlier sweeps with their
sweep → key-frame transforms and time lags. `NuScenesDataset` reads them:
the class-balanced resampling (CBGS) from an explicit RandomState, the key
frame plus its sweeps with a trailing time-lag channel (points within
MIN_POINT_RADIUS of the sensor dropped), KITTI AP evaluation (the
reference's `kitti` EVAL_METRIC), and the official results.json writer.

Class names: the infos carry KITTI-style names (Car, Construction_vehicle,
...), as the JAX package writes them. A config that names the nuScenes
detection classes (car, construction_vehicle, ...: the cbgs configs) has its
gt names translated to them on load, and its names translated back for the
KITTI AP; the JAX package compares the names as they are, so on those
configs it keeps no gt box.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate

# detection name → KITTI-style class (capitalised, reference kitti_utils map)
DEFAULT_MAP = {
    "car": "Car", "truck": "Truck", "construction_vehicle": "Construction_vehicle",
    "bus": "Bus", "trailer": "Trailer", "barrier": "Barrier",
    "motorcycle": "Motorcycle", "bicycle": "Bicycle", "pedestrian": "Pedestrian",
    "traffic_cone": "Traffic_cone",
}
KITTI_TO_DETECTION = {v: k for k, v in DEFAULT_MAP.items()}


def _sweep_entries(nusc, sd_ref, max_sweeps):
    """Up to max_sweeps - 1 previous sweeps with their sweep → reference
    transforms and time lags (reference nuscenes_utils.get_sweeps /
    obtain_sensor2top)."""
    from .nuscenes_tables import Quaternion, transform_matrix

    cs_ref = nusc.get("calibrated_sensor", sd_ref["calibrated_sensor_token"])
    pose_ref = nusc.get("ego_pose", sd_ref["ego_pose_token"])
    ref_from_car = transform_matrix(cs_ref["translation"], Quaternion(wxyz=cs_ref["rotation"]),
                                    inverse=True)
    car_from_global = transform_matrix(pose_ref["translation"],
                                       Quaternion(wxyz=pose_ref["rotation"]), inverse=True)
    sweeps = []
    sd = sd_ref
    while len(sweeps) < max_sweeps - 1 and sd.get("prev"):
        sd = nusc.get("sample_data", sd["prev"])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        global_from_car = transform_matrix(pose["translation"], Quaternion(wxyz=pose["rotation"]))
        car_from_sensor = transform_matrix(cs["translation"], Quaternion(wxyz=cs["rotation"]))
        sweep2ref = ref_from_car @ car_from_global @ global_from_car @ car_from_sensor
        sweeps.append({"lidar_path": sd["filename"], "transform": sweep2ref.astype(np.float32),
                       "time_lag": (sd_ref["timestamp"] - sd["timestamp"]) * 1e-6})
    return sweeps


def create_nuscenes_infos(dataroot, version="v1.0-trainval", max_sweeps=1, save_path=None,
                          logger=None):
    """The info list of every sample of `version` under `dataroot`
    (reference nuscenes_utils.fill_trainval_infos), pickled to `save_path`
    when given."""
    from .nuscenes_tables import (
        NuScenesTables,
        Quaternion,
        category_to_detection_name,
        transform_matrix,
    )

    nusc = NuScenesTables(dataroot, version)
    infos = []
    for sample in nusc.sample:
        sd_lid = nusc.get("sample_data", nusc.sample_data_token(sample, "LIDAR_TOP"))
        anns = nusc.sample_annotations_of(sample["token"])
        names, boxes = [], []
        for ann in anns:
            cat = (nusc.get("category", ann["category_token"])["name"]
                   if "category_token" in ann else ann.get("category_name", ""))
            det = category_to_detection_name(cat)
            if det is None:
                continue
            box = nusc.box_in_lidar_frame(ann, sd_lid)
            w, l, h = box.wlh
            v = box.rotation_matrix @ np.array([1.0, 0, 0])  # the box's x axis
            yaw = np.arctan2(v[1], v[0])
            # locs | dims | rot | vel (fill_trainval_infos:447-451); a track
            # without neighbours has nan velocity
            boxes.append([*box.center, l, w, h, yaw, *box.velocity[:2]])
            names.append(DEFAULT_MAP.get(det, det.capitalize()))
        cs = nusc.get("calibrated_sensor", sd_lid["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd_lid["ego_pose_token"])
        lidar2global = (transform_matrix(pose["translation"], Quaternion(wxyz=pose["rotation"]))
                        @ transform_matrix(cs["translation"], Quaternion(wxyz=cs["rotation"]))
                        ).astype(np.float32)
        infos.append({
            "token": sample["token"],
            "lidar_path": sd_lid["filename"],
            "lidar2global": lidar2global,
            "sweeps": _sweep_entries(nusc, sd_lid, max_sweeps),
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 9),
            "gt_names": np.asarray(names),
            "num_lidar_pts": np.asarray([a.get("num_lidar_pts", -1) for a in anns], np.int32),
        })
    if save_path is not None:
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(infos, f)
        if logger:
            logger.info(f"nuscenes infos saved: {save_path} ({len(infos)})")
    return infos


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None,
                 rng=None):
        """`rng`: the RandomState of the class-balanced resampling (default:
        a fresh one seeded 0)."""
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self._info_to_cfg = self._name_map(class_names)
        self.infos = []
        for info_path in dataset_cfg.INFO_PATH[self.mode]:
            p = Path(info_path)
            if not p.is_absolute():
                p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if self.training and dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self._balanced_resample(
                self.infos, rng if rng is not None else np.random.RandomState(0))
        # (vx, vy) columns in the batch whenever the infos carry them
        if any(len(i.get("gt_boxes", np.zeros((0, 7)))) and i["gt_boxes"].shape[1] >= 9
               for i in self.infos):
            self.gt_box_width = 9
        if logger:
            logger.info(f"NuScenesDataset: {len(self.infos)} samples")

    @staticmethod
    def _name_map(class_names):
        """KITTI-style info names → the config's, where it names detection classes."""
        return (KITTI_TO_DETECTION if class_names
                and all(n in DEFAULT_MAP for n in class_names) else {})

    def _cfg_names(self, names):
        return np.asarray([self._info_to_cfg.get(str(n), str(n)) for n in names])

    def _balanced_resample(self, infos, rng):
        """Duplicate samples so that every class appears about equally often
        (reference balanced_infos_resampling:66-106), drawing from `rng`."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(self._cfg_names(info["gt_names"]).tolist()):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / max(len(self.class_names), 1)
        out = []
        for v in cls_infos.values():
            if len(v) == 0:
                continue
            take = int(len(v) * (frac / (len(v) / duplicated)))
            idx = rng.choice(len(v), take, replace=True) if take else []
            out.extend(v[i] for i in idx)
        return out or infos

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * max(self.total_epochs, 1)
        return len(self.infos)

    def _load_points(self, info):
        """The key frame's points, then with MAX_SWEEPS > 1 its sweeps moved
        into the key frame, each with a trailing time-lag channel (reference
        get_lidar_with_sweeps)."""
        from .nuscenes_tables import read_nuscenes_lidar

        radius = float(self.dataset_cfg.get("MIN_POINT_RADIUS", 1.0))
        max_sweeps = int(self.dataset_cfg.get("MAX_SWEEPS", 1))

        def load_one(path, transform=None, time_lag=0.0):
            pts = read_nuscenes_lidar(self.root_path / path)
            pts = pts[np.linalg.norm(pts[:, 0:2], axis=1) > radius]
            if transform is not None:
                xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1), np.float32)], axis=1)
                pts[:, :3] = (xyz1 @ np.asarray(transform, np.float32).T)[:, :3]
            if max_sweeps > 1:
                pts = np.concatenate([pts, np.full((len(pts), 1), time_lag, np.float32)], axis=1)
            return pts

        parts = [load_one(info["lidar_path"])]
        for sw in info.get("sweeps", [])[:max_sweeps - 1]:
            parts.append(load_one(sw["lidar_path"], sw["transform"], sw["time_lag"]))
        return np.concatenate(parts, axis=0)

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = self.infos[index]
        gt_boxes = info["gt_boxes"].copy()
        if self.dataset_cfg.get("SET_NAN_VELOCITY_TO_ZEROS", True):
            gt_boxes[np.isnan(gt_boxes)] = 0.0
        data_dict = self.prepare_data({"frame_id": info["token"],
                                       "points": self._load_points(info),
                                       "gt_boxes": gt_boxes,
                                       "gt_names": self._cfg_names(info["gt_names"])})
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        return data_dict

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names, output_path=None):
        """LiDAR-frame annos for the KITTI-style evaluation (no camera
        geometry: `evaluation` fills the sentinels)."""
        annos = []
        for i, box_dict in enumerate(pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"])
            labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)
            annos.append({
                "frame_id": batch_meta.frame_ids[i],
                "name": np.array([class_names[l - 1] for l in labels], dtype="<U32"),
                "score": np.asarray(box_dict["pred_scores"]),
                # (vx, vy) kept where the model regresses them (devkit cols 7:9)
                "boxes_lidar": boxes[:, :9 if boxes.shape[1] >= 9 else 7],
                "pred_labels": labels,
            })
        return annos

    # the attribute per detection class where the speed gate does not decide
    _DEFAULT_ATTR = {
        "car": "vehicle.parked", "truck": "vehicle.parked", "bus": "vehicle.moving",
        "trailer": "vehicle.parked", "construction_vehicle": "vehicle.parked",
        "pedestrian": "pedestrian.standing", "motorcycle": "cycle.without_rider",
        "bicycle": "cycle.without_rider", "barrier": "", "traffic_cone": "",
    }

    def write_nuscenes_results_json(self, det_annos, output_path):
        """The official nuScenes detection results.json, boxes moved into the
        global frame through each sample's lidar2global (reference
        nuscenes_utils.py:479-588), for the devkit's out-of-process
        `python -m nuscenes.eval.detection.evaluate --result_path ...`."""
        from .nuscenes_tables import Quaternion

        by_token = {info["token"]: info for info in self.infos}
        results = {}
        for anno in det_annos:
            token = anno["frame_id"]
            info = by_token.get(token)
            tf = np.asarray(info.get("lidar2global", np.eye(4)) if info else np.eye(4),
                            np.float64)
            dets = []
            boxes = np.asarray(anno["boxes_lidar"], np.float64)
            for j in range(len(boxes)):
                b = boxes[j]
                center = tf[:3, :3] @ b[:3] + tf[:3, 3]
                yaw = b[6]
                rot = tf[:3, :3] @ np.array([[np.cos(yaw), -np.sin(yaw), 0],
                                             [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
                q = Quaternion(matrix=rot).q  # (w, x, y, z)
                name = KITTI_TO_DETECTION.get(str(anno["name"][j]), str(anno["name"][j]).lower())
                vel = (tf[:3, :3] @ np.nan_to_num(np.array([b[7], b[8], 0.0]))
                       if boxes.shape[1] >= 9 else np.zeros(3))
                # speed-gated attribute (reference nuscenes_utils:526-539)
                if float(np.hypot(vel[0], vel[1])) > 0.2:
                    attr = ("vehicle.moving" if name in ("car", "construction_vehicle", "bus",
                                                         "truck", "trailer")
                            else "cycle.with_rider" if name in ("bicycle", "motorcycle")
                            else self._DEFAULT_ATTR.get(name, ""))
                else:
                    attr = ("pedestrian.standing" if name == "pedestrian"
                            else "vehicle.stopped" if name == "bus"
                            else self._DEFAULT_ATTR.get(name, ""))
                dets.append({
                    "sample_token": token,
                    "translation": center.tolist(),
                    "size": [float(b[4]), float(b[3]), float(b[5])],  # w, l, h
                    "rotation": [float(v) for v in q],
                    "velocity": [float(vel[0]), float(vel[1])],
                    "detection_name": name,
                    "detection_score": float(anno["score"][j]),
                    "attribute_name": attr,
                })
            results[token] = dets
        payload = {"meta": {"use_camera": False, "use_lidar": True, "use_radar": False,
                            "use_map": False, "use_external": False},
                   "results": results}
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        output_path.write_text(json.dumps(payload))
        return output_path

    def evaluation(self, det_annos, class_names, **kwargs):
        """KITTI-style AP over LiDAR boxes (the reference's `kitti`
        EVAL_METRIC), names in KITTI style. With EVAL_METRIC 'nuscenes' the
        results.json is written first; without the nuScenes devkit (it is
        not a dependency) that json and how to evaluate it are returned."""
        if kwargs.get("eval_metric") == "nuscenes" or (
                self.dataset_cfg.get("EVAL_METRIC") == "nuscenes"):
            out = Path(kwargs.get("output_path", self.root_path)) / "results_nusc.json"
            self.write_nuscenes_results_json(det_annos, out)
            try:
                from nuscenes import NuScenes  # noqa: F401 (optional devkit)
                from nuscenes.eval.detection.evaluate import NuScenesEval  # noqa: F401
            except ImportError:
                return (f"nuScenes results written to {out}; install the nuscenes devkit and "
                        "run nuscenes.eval.detection.evaluate on it (devkit not available in "
                        "this environment)", {"results_json": str(out)})
        from ..eval import kitti_eval

        def kitti_names(names):
            return np.asarray([DEFAULT_MAP.get(str(n), str(n)) for n in names])

        def to_kitti(boxes, names, scores=None):
            n = len(boxes)
            d = {
                "name": kitti_names(names),
                "truncated": np.zeros(n),
                "occluded": np.zeros(n),
                "alpha": np.full(n, -10.0),
                "bbox": np.tile([0, 0, 200, 200.0], (n, 1)),
                # camera layout [x = -y_l, y = -z_l, z = x_l], dims (l, h, w),
                # ry = -heading - pi/2
                "dimensions": boxes[:, [3, 5, 4]] if n else np.zeros((0, 3)),
                "location": (np.stack([-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], axis=1)
                             if n else np.zeros((0, 3))),
                "rotation_y": (-boxes[:, 6] - np.pi / 2) if n else np.zeros(0),
            }
            if scores is not None:
                d["score"] = np.asarray(scores)
            return d

        gt_annos = [to_kitti(info["gt_boxes"], info["gt_names"]) for info in self.infos]
        dt_annos = [to_kitti(a["boxes_lidar"], a["name"], a["score"]) for a in det_annos]
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos,
                                                   list(kitti_names(class_names)))
