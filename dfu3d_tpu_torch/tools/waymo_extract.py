"""Waymo TFRecord -> extracted-layout writer (port of tools/waymo_extract.py;
reference pcdet/datasets/waymo/waymo_utils.py:23-266 and waymo_dataset.py's
`process_single_sequence` driver).

    python -m dfu3d_tpu_torch.tools.waymo_extract --raw_data_dir DIR --save_dir TAG_DIR \
        [--sampled_interval 1] [--no_labels]

The layout it writes is the one `dfu3d_tpu_torch.data.waymo_dataset.WaymoDataset`
reads:

    <tag>/<sequence>/<frame:04d>.npy   (N, 6) [x y z intensity elongation NLZ]
    <tag>/<sequence>/<sequence>.pkl    per-sequence info list

Decoding a TFRecord needs TensorFlow and the waymo-open-dataset package;
`decode_tfrecord` imports them when called and raises a clear error without
them. Everything after the decode (the labels with the global-to-ego speed
rotation, the 9-column gt_boxes_lidar, the infos, the layout) is numpy.

A "decoded frame" is a plain dict:
    {"points": (N, 6) float32 as above (vehicle frame),
     "num_points_of_each_lidar": [int] * 5,
     "pose": (4, 4) float64 vehicle->global,
     "frame_id": str, "sequence_name": str, "sample_idx": int,
     "timestamp": int, "image_shapes": [(h, w)] * n_cam,
     "labels": [{"name", "box": (7,) [x y z l w h heading],
                 "speed_global": (2,), "accel_global": (2,),
                 "obj_id", "num_points_in_gt", "difficulty",
                 "tracking_difficulty"}]}
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def build_annotations(labels, pose):
    """Labels of one frame -> the reference's annos dict
    (waymo_utils.generate_labels:23-71): per-object arrays plus
    gt_boxes_lidar (M, 9) = [xyz lwh heading v_ego_xy], where the global
    speed is rotated into the ego frame with inv(pose[:3,:3].T)."""
    labels = [l for l in labels if l["name"] != "unknown"]
    annos = {
        "name": np.array([l["name"] for l in labels], dtype="<U32"),
        "difficulty": np.array([l.get("difficulty", 0) for l in labels]),
        "dimensions": np.array([l["box"][3:6] for l in labels]).reshape(-1, 3),
        "location": np.array([l["box"][0:3] for l in labels]).reshape(-1, 3),
        "heading_angles": np.array([l["box"][6] for l in labels]),
        "obj_ids": np.array([l.get("obj_id", "") for l in labels]),
        "tracking_difficulty": np.array(
            [l.get("tracking_difficulty", 0) for l in labels]
        ),
        "num_points_in_gt": np.array(
            [l.get("num_points_in_gt", -1) for l in labels]
        ),
        "speed_global": np.array(
            [l.get("speed_global", (0.0, 0.0)) for l in labels]
        ).reshape(-1, 2),
        "accel_global": np.array(
            [l.get("accel_global", (0.0, 0.0)) for l in labels]
        ).reshape(-1, 2),
    }
    if len(labels):
        global_speed = np.pad(annos["speed_global"], ((0, 0), (0, 1)))
        speed = global_speed @ np.linalg.inv(np.asarray(pose)[:3, :3].T)
        annos["gt_boxes_lidar"] = np.concatenate(
            [annos["location"], annos["dimensions"],
             annos["heading_angles"][:, None], speed[:, :2]], axis=1
        ).astype(np.float64)
    else:
        annos["gt_boxes_lidar"] = np.zeros((0, 9))
    return annos


def build_info(decoded, has_label=True):
    """Decoded frame -> the reference's per-frame info dict
    (waymo_utils.process_single_sequence:221-258)."""
    info = {
        "point_cloud": {
            "num_features": 5,
            "lidar_sequence": decoded["sequence_name"],
            "sample_idx": decoded["sample_idx"],
        },
        "frame_id": decoded["frame_id"],
        "metadata": {
            "context_name": decoded["sequence_name"],
            "timestamp_micros": decoded.get("timestamp", 0),
        },
        "image": {
            f"image_shape_{i}": np.asarray(shape)
            for i, shape in enumerate(decoded.get("image_shapes", []))
        },
        "pose": np.asarray(decoded["pose"]),
        "num_points_of_each_lidar": decoded.get(
            "num_points_of_each_lidar", [decoded["points"].shape[0]]
        ),
    }
    if has_label:
        info["annos"] = build_annotations(
            decoded.get("labels", []), decoded["pose"]
        )
    return info


def process_single_sequence(decoded_frames, save_path, sampled_interval=1,
                            has_label=True):
    """Write one sequence's extracted layout (ref :197-266): the per-frame
    npy point files and the `<sequence>.pkl` info list. `decoded_frames` is
    any iterable of decoded-frame dicts (see module docstring)."""
    save_path = Path(save_path)
    infos, seq_name = [], None
    for cnt, decoded in enumerate(decoded_frames):
        if cnt % sampled_interval:
            continue
        seq_name = decoded["sequence_name"]
        seq_dir = save_path / seq_name
        seq_dir.mkdir(parents=True, exist_ok=True)
        np.save(seq_dir / f"{decoded['sample_idx']:04d}.npy",
                np.asarray(decoded["points"], np.float32))
        infos.append(build_info(decoded, has_label=has_label))
    if seq_name is not None:
        with open(save_path / seq_name / f"{seq_name}.pkl", "wb") as f:
            pickle.dump(infos, f)
    return infos


def decode_tfrecord(sequence_file, use_two_returns=True):
    """Yield decoded-frame dicts from one TFRecord. Needs TensorFlow + the
    waymo-open-dataset package (the reference's extraction dependency,
    waymo_utils.py:1-20); everything else in this tool is numpy-only."""
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise ImportError(
            "Waymo TFRecord extraction needs `tensorflow` and "
            "`waymo-open-dataset` (pip install waymo-open-dataset-tf-2-x-x). "
            "Run this tool in an environment with them installed; the "
            "produced layout is portable."
        ) from e

    sequence_name = Path(sequence_file).stem.replace(".tfrecord", "")
    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type="")
    for cnt, data in enumerate(dataset):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        ri, cp, *rest = frame_utils.parse_range_image_and_camera_projection(
            frame
        )
        top_pose = rest[-1]
        points, _cp, nlz, intensity, elongation = [], [], [], [], []
        for ri_index in (0, 1) if use_two_returns else (0,):
            pts, cps = frame_utils.convert_range_image_to_point_cloud(
                frame, ri, cp, top_pose, ri_index=ri_index, keep_polar_features=True
            )
            # keep_polar_features rows: [range, intensity, elongation, x, y, z]
            points.extend([p[:, 3:6] for p in pts])
            intensity.extend([p[:, 1] for p in pts])
            elongation.extend([p[:, 2] for p in pts])
            nlz.extend([np.full(p.shape[0], -1.0) for p in pts])
        num_each = [p.shape[0] for p in points]
        pose = np.array(frame.pose.transform, np.float64).reshape(4, 4)
        labels = [
            {
                "name": WAYMO_CLASSES[l.type],
                "box": np.array([
                    l.box.center_x, l.box.center_y, l.box.center_z,
                    l.box.length, l.box.width, l.box.height, l.box.heading,
                ]),
                "speed_global": (l.metadata.speed_x, l.metadata.speed_y),
                "accel_global": (l.metadata.accel_x, l.metadata.accel_y),
                "obj_id": l.id,
                "num_points_in_gt": l.num_lidar_points_in_box,
                "difficulty": l.detection_difficulty_level,
                "tracking_difficulty": l.tracking_difficulty_level,
            }
            for l in frame.laser_labels
        ]
        yield {
            "points": np.concatenate([
                np.concatenate(points, 0),
                np.concatenate(intensity, 0)[:, None],
                np.concatenate(elongation, 0)[:, None],
                np.concatenate(nlz, 0)[:, None],
            ], axis=-1).astype(np.float32),
            "num_points_of_each_lidar": num_each,
            "pose": pose,
            "frame_id": f"{sequence_name}_{cnt:03d}",
            "sequence_name": sequence_name,
            "sample_idx": cnt,
            "timestamp": frame.timestamp_micros,
            "image_shapes": [(im.height, im.width) for im in
                             frame.context.camera_calibrations],
            "labels": labels,
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--raw_data_dir", required=True,
                    help="directory of .tfrecord files")
    ap.add_argument("--save_dir", required=True,
                    help="output <tag> directory (e.g. waymo_processed_data)")
    ap.add_argument("--sampled_interval", type=int, default=1)
    ap.add_argument("--no_labels", action="store_true")
    args = ap.parse_args(argv)
    records = sorted(Path(args.raw_data_dir).glob("*.tfrecord"))
    if not records:
        raise SystemExit(f"no .tfrecord files under {args.raw_data_dir}")
    for rec in records:
        infos = process_single_sequence(
            decode_tfrecord(rec), args.save_dir,
            sampled_interval=args.sampled_interval,
            has_label=not args.no_labels,
        )
        print(f"{rec.name}: {len(infos)} frames")


if __name__ == "__main__":
    main()
