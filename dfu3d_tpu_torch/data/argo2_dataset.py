"""Argoverse 2 sensor dataset: the converter and the loader over what it
writes (own copy of dfu3d_tpu/data/argo2_dataset.py; reference
pcdet/datasets/argo2/argo2_dataset.py + argo2_utils/so3.py).

`convert_av2_sensor` reads the AV2 feather layout (pandas, imported where a
feather file is read or written):

    <av2_root>/<split>/<log_id>/sensors/lidar/<timestamp_ns>.feather
        columns x, y, z, intensity (among others)
    <av2_root>/<split>/<log_id>/annotations.feather
        LABEL_ATTR (tx/ty/tz, length/width/height, qw qx qy qz), category,
        num_interior_pts, timestamp_ns

and writes, as the reference's prepare() / create_argo2_infos (:109-166),
velodyne bins named <split prefix><log:03d><frame:03d> (4 float32 columns),
argo2_infos_<split>.pkl with the cuboids' quaternions collapsed to yaw
(`quat_to_yaw`), and val_anno.feather for the official evaluator.
`Argo2Dataset` reads the bins and the infos; it needs no pandas.

Evaluation runs the av2 devkit where it can be imported (the reference's
protocol, :416-485); without it, the KITTI protocol over lidar boxes with
the competition -> KITTI class map (`_kitti_fallback_eval`).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..eval.kitti_eval import lidar_anno
from .dataset import DatasetTemplate

LABEL_ATTR = (
    "tx_m", "ty_m", "tz_m",
    "length_m", "width_m", "height_m",
    "qw", "qx", "qy", "qz",
)


# --- SO3 (argo2_utils/so3.py) ---

def quat_to_yaw(quat_wxyz: np.ndarray) -> np.ndarray:
    """Scalar-first quaternion → yaw about +z (so3.py quat_to_yaw / quat_to_xyz)."""
    qw, qx, qy, qz = (quat_wxyz[..., i] for i in range(4))
    siny_cosp = 2 * (qw * qz + qx * qy)
    cosy_cosp = 1 - 2 * (qy * qy + qz * qz)
    return np.arctan2(siny_cosp, cosy_cosp)


def yaw_to_quat(yaw: np.ndarray) -> np.ndarray:
    """Yaw about +z → scalar-first quaternion (so3.py yaw_to_quat)."""
    half = np.asarray(yaw) / 2.0
    out = np.zeros(np.shape(half) + (4,), np.float64)
    out[..., 0] = np.cos(half)
    out[..., 3] = np.sin(half)
    return out


# --- conversion (reference prepare + create_argo2_infos, :109-166) ---

def _read_feather(path):
    import pandas as pd

    return pd.read_feather(path)


def convert_av2_sensor(av2_sensor_root, output_dir, splits=("train", "val"),
                       save_bin=True, logger=None):
    """The AV2 sensor layout → velodyne bins, info pkls and val_anno.feather
    under `output_dir`. Returns {split: info pkl path}."""
    import pandas as pd

    av2_sensor_root = Path(av2_sensor_root)
    output_dir = Path(output_dir)
    prefix_of = {"train": "0", "val": "1", "test": "2"}
    out_paths = {}
    val_annos = []
    for split in splits:
        prefix = prefix_of[split]
        split_dir = "training" if split != "test" else "testing"
        (output_dir / split_dir / "velodyne").mkdir(parents=True, exist_ok=True)
        infos = []
        seg_dirs = sorted(p for p in (av2_sensor_root / split).iterdir()
                          if p.is_dir())
        for seg_idx, seg_path in enumerate(seg_dirs):
            assert seg_idx < 1000
            anno_path = seg_path / "annotations.feather"
            seg_anno = _read_feather(anno_path) if anno_path.exists() else None
            if split == "val" and seg_anno is not None:
                va = seg_anno.copy()
                va["log_id"] = seg_path.name
                val_annos.append(va)
            frame_files = sorted((seg_path / "sensors" / "lidar").glob("*.feather"))
            for frame_idx, frame_path in enumerate(frame_files):
                assert frame_idx < 1000
                ts = int(frame_path.stem)
                sample_idx = f"{prefix}{seg_idx:03d}{frame_idx:03d}"
                info = {
                    "uuid": f"{seg_path.name}/{ts}",
                    "sample_idx": sample_idx,
                    "frame_id": sample_idx,
                    "point_cloud": {
                        "num_features": 4,
                        "velodyne_path": f"{split_dir}/velodyne/{sample_idx}.bin",
                    },
                    "image": {}, "calib": {}, "pose": {}, "sweeps": [],
                }
                if seg_anno is not None:
                    fa = seg_anno[seg_anno["timestamp_ns"] == ts]
                    fa = fa[fa["num_interior_pts"] > 0]
                    cuboids = fa.loc[:, list(LABEL_ATTR)].to_numpy()
                    yaw = quat_to_yaw(cuboids[:, -4:])
                    cat = np.array(
                        [str(c).lower().capitalize() for c in
                         fa["category"].to_numpy()]
                    )
                    n = len(cat)
                    info["annos"] = {
                        "name": cat,
                        "truncated": np.zeros(n),
                        "occluded": np.zeros(n, np.int64),
                        "alpha": -10 * np.ones(n),
                        "dimensions": cuboids[:, 3:6].astype(np.float64),
                        "location": cuboids[:, 0:3].astype(np.float64),
                        "rotation_y": yaw.astype(np.float64),
                        "index": np.arange(n, dtype=np.int32),
                        "num_points_in_gt":
                            fa["num_interior_pts"].to_numpy().astype(np.int32),
                    }
                if save_bin:
                    lidar = _read_feather(frame_path)
                    pts = lidar.loc[:, ["x", "y", "z", "intensity"]].to_numpy()
                    pts.astype(np.float32).tofile(
                        output_dir / split_dir / "velodyne" / f"{sample_idx}.bin"
                    )
                infos.append(info)
        out = output_dir / f"argo2_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        out_paths[split] = out
        if logger:
            logger.info(f"argo2 {split}: {len(infos)} frames -> {out}")
    if val_annos:
        pd.concat(val_annos).reset_index(drop=True).to_feather(
            output_dir / "val_anno.feather"
        )
    return out_paths


def _gt_boxes(annos):
    """The infos' cuboids as (N, 7) lidar boxes [location, dimensions, yaw]."""
    return np.concatenate(
        [annos["location"], annos["dimensions"], annos["rotation_y"][..., None]], axis=1
    ) if len(annos["name"]) else np.zeros((0, 7))


class Argo2Dataset(DatasetTemplate):
    """Argoverse 2 over the converted bins and info pkls."""

    # competition categories → KITTI-protocol names (the fallback evaluation)
    CLASS_MAP = {
        "Regular_vehicle": "Car", "Pedestrian": "Pedestrian",
        "Bicyclist": "Cyclist", "Bicycle": "Bicycle",
        "Motorcyclist": "Motorcycle", "Motorcycle": "Motorcycle",
        "Large_vehicle": "Truck", "Box_truck": "Truck", "Truck": "Truck",
        "Bus": "Bus",
    }

    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        self.evaluate_range = float(dataset_cfg.get("EVALUATE_RANGE", 200.0))
        self.argo2_infos = []
        for info_path in dataset_cfg.INFO_PATH.get(self.mode, []):
            p = Path(info_path)
            if not p.is_absolute():
                p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.argo2_infos.extend(pickle.load(f))
        if logger:
            logger.info(
                f"Argo2Dataset[{self.split}]: {len(self.argo2_infos)} frames"
            )
        self.infos = self.argo2_infos

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.argo2_infos) * max(self.total_epochs, 1)
        return len(self.argo2_infos)

    def get_lidar(self, info):
        lidar_file = self.root_path / info["point_cloud"]["velodyne_path"]
        return np.fromfile(str(lidar_file), np.float32).reshape(
            -1, info["point_cloud"].get("num_features", 4)
        )

    def __getitem__(self, index, _retry=0):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.argo2_infos)
        info = self.argo2_infos[index]
        input_dict = {
            "frame_id": info["sample_idx"],
            "points": self.get_lidar(info),
        }
        if "annos" in info:
            input_dict.update({
                "gt_names": np.asarray(info["annos"]["name"]).copy(),
                "gt_boxes": _gt_boxes(info["annos"]).astype(np.float32),
            })
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict.pop("_needs_resample", False):
            return self.__getitem__(self._resample(_retry), _retry + 1)
        return data_dict

    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        """Annos with each box's first 7 columns: the shipped VoxelNeXt config
        keeps the nuScenes heads' velocity, 9 columns, which the JAX package
        reshapes to rows of 7 (ROADMAP Queue C)."""
        annos = []
        for i, box_dict in enumerate(pred_dicts):
            labels = np.asarray(box_dict["pred_labels"]).astype(np.int64)
            annos.append({
                "frame_id": batch_meta.frame_ids[i],
                "name": np.array([class_names[l - 1] for l in labels],
                                 dtype="<U32"),
                "score": np.asarray(box_dict["pred_scores"]),
                "boxes_lidar":
                    np.asarray(box_dict["pred_boxes"]).reshape(len(labels), -1)[:, :7],
            })
        return annos

    def format_results(self, det_annos, out_feather=None):
        """Detections → the AV2 submission frame (argo2_dataset.py:340-404)."""
        import pandas as pd

        uuid_of = {info["sample_idx"]: info["uuid"]
                   for info in self.argo2_infos}
        rows = []
        for a in det_annos:
            log_id, ts = uuid_of[str(a["frame_id"])].split("/")
            boxes = np.asarray(a["boxes_lidar"], np.float64).reshape(-1, 7)
            quat = yaw_to_quat(boxes[:, 6])
            df = pd.DataFrame(
                np.concatenate([boxes[:, 0:6], quat], axis=1),
                columns=list(LABEL_ATTR),
            )
            df["score"] = np.asarray(a["score"], np.float64)
            df["log_id"] = log_id
            df["timestamp_ns"] = int(ts)
            df["category"] = [str(n).upper() for n in a["name"]]
            rows.append(df)
        dts = (
            pd.concat(rows).set_index(["log_id", "timestamp_ns"]).sort_index()
            .sort_values("score", ascending=False).reset_index()
        )
        if out_feather is not None:
            dts.to_feather(out_feather)
        return dts.set_index(["log_id", "timestamp_ns"]).sort_index()

    def evaluation(self, det_annos, class_names, **kwargs):
        try:
            from av2.evaluation.detection.constants import CompetitionCategories
            from av2.evaluation.detection.eval import evaluate
            from av2.evaluation.detection.utils import DetectionCfg
        except ImportError:
            return self._kitti_fallback_eval(det_annos, class_names)

        dts = self.format_results(det_annos)
        gts = _read_feather(self.root_path / "val_anno.feather")
        gts = gts.set_index(["log_id", "timestamp_ns"]).sort_values("category")
        valid = set(gts.index.tolist()) & set(dts.index.tolist())
        gts = gts.loc[list(valid)].sort_index()
        categories = set(x.value for x in CompetitionCategories)
        categories &= set(gts["category"].unique().tolist())
        cfg = DetectionCfg(
            dataset_dir=Path(self.root_path) / "sensor" / "val",
            categories=tuple(sorted(categories)),
            max_range_m=self.evaluate_range,
            eval_only_roi_instances=True,
        )
        _, _, metrics = evaluate(dts.reset_index(), gts.reset_index(), cfg)
        ap_dict = {idx: row.to_json() for idx, row in metrics.iterrows()}
        return str(metrics.loc[sorted(categories) + ["AVERAGE_METRICS"]]), ap_dict

    def _kitti_fallback_eval(self, det_annos, class_names):
        """The KITTI protocol over lidar boxes (the av2 devkit absent)."""
        from ..eval import kitti_eval

        cmap = {**self.CLASS_MAP,
                **dict(self.dataset_cfg.get("MAP_CLASS_TO_KITTI", {}))}

        def to_kitti(boxes, names, scores=None):
            return lidar_anno(boxes, [cmap.get(str(x), str(x)) for x in names], scores)

        gt_annos = [to_kitti(_gt_boxes(info["annos"]), info["annos"]["name"])
                    for info in self.argo2_infos]
        dt_annos = [to_kitti(a["boxes_lidar"], a["name"], a["score"])
                    for a in det_annos]
        kitti_classes = sorted(
            {cmap.get(c, c) for c in class_names}
            & set(kitti_eval.CLASS_TO_NAME.values())
        ) or ["Car"]
        return kitti_eval.get_official_eval_result(
            gt_annos, dt_annos, kitti_classes
        )
