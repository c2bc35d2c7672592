"""Synthetic roots in the on-disk layouts of the other lidar datasets (Waymo's
extracted layout, ONCE, Lyft, Custom, Pandaset, Argoverse 2), for smoke runs
and tests that must not download data; the counterpart of `kitti_synthetic`
and `nuscenes_synthetic`, written with numpy, json and pickle.

A frame is `zoo.waymo_batches`' scene (`zoo._waymo_frame`): 15 % of its
points on the faces of its boxes, which stand on the ground at z = 0 with
random headings and the class's size within +-10 %, 70 % on the ground with
a density falling as 1 / range, 15 % clutter in the point-cloud range. Each
writer takes the dataset's classes and range and returns what it wrote.

    write_waymo_root       <tag>/<seq>/<frame:04d>.npy (x y z intensity
                           elongation NLZ) and <seq>.pkl, ImageSets/*.txt
    write_once_root        data/<seq>/lidar_roof/<frame>.bin, <seq>.json,
                           ImageSets/*.txt (infos: `once_dataset.create_once_infos`)
    write_lyft_root        nuScenes-format tables (`nuscenes_synthetic`) of
                           Lyft's classes that nuScenes also has, and
                           lyft_infos_<split>.pkl
    write_custom_root      points/<id>.npy, labels/<id>.txt, ImageSets/*.txt
                           (infos: `custom_dataset.create_custom_infos`)
    write_pandaset_root    points/<frame>.npy, pandaset_infos_<split>.pkl
    write_argo2_root       training/velodyne/<sample>.bin and
                           argo2_infos_<split>.pkl as `argo2_dataset.
                           convert_av2_sensor` writes them (no feather, no pandas)
"""
from __future__ import annotations

import json
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import np_geometry as npg

# (length, width, height) in metres of each dataset's classes
WAYMO_DIMS = {"Vehicle": (4.7, 2.1, 1.7), "Pedestrian": (0.9, 0.9, 1.8),
              "Cyclist": (1.8, 0.8, 1.8)}
ONCE_DIMS = {"Car": (4.4, 1.9, 1.6), "Bus": (11.0, 2.9, 3.3), "Truck": (8.0, 2.7, 3.2),
             "Pedestrian": (0.7, 0.7, 1.7), "Cyclist": (1.8, 0.8, 1.7)}
CUSTOM_DIMS = {"Vehicle": (4.7, 2.1, 1.7), "Pedestrian": (0.9, 0.9, 1.8),
               "Cyclist": (1.8, 0.8, 1.8)}
ARGO2_DIMS = {"Regular_vehicle": (4.6, 1.9, 1.7), "Pedestrian": (0.7, 0.7, 1.7),
              "Bicyclist": (1.8, 0.8, 1.8), "Bus": (11.5, 2.9, 3.3),
              "Box_truck": (7.5, 2.6, 3.2), "Bollard": (0.3, 0.3, 1.0)}
PANDASET_DIMS = {"Car": (4.5, 1.9, 1.6), "Pedestrian": (0.7, 0.7, 1.7)}
LYFT_CLASSES = ("car", "truck", "bus", "motorcycle", "bicycle", "pedestrian")  # in nuScenes too
NLZ_SHARE = 0.05   # share of a Waymo frame's points flagged in a no-label zone
WRITER_THREADS = 4  # threads saving Waymo frames and counting their boxes' points


def scene(rng, class_dims, point_cloud_range, num_points, num_boxes=(20, 40)):
    """One frame: (points (num_points, 5) x y z intensity elongation, boxes
    (M, 7) float32 [x y z dx dy dz heading], names (M,))."""
    from ..zoo import _waymo_frame

    lo = np.asarray(point_cloud_range[:3], np.float32)
    hi = np.asarray(point_cloud_range[3:], np.float32)
    names = list(class_dims)
    m = rng.randint(num_boxes[0], num_boxes[1] + 1)
    cls = rng.randint(0, len(names), m)
    dims = np.array([class_dims[names[c]] for c in cls], np.float32)
    dims *= rng.uniform(0.9, 1.1, dims.shape).astype(np.float32)
    ctr = rng.uniform(lo[:2] * 0.9, hi[:2] * 0.9, (m, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    points = _waymo_frame(rng, ctr, dims, yaw, num_points, lo, hi)
    boxes = np.concatenate([ctr, dims[:, 2:3] / 2, dims, yaw[:, None]], axis=1)
    return points, boxes.astype(np.float32), np.array([names[c] for c in cls])


def _write_split_files(root, splits):
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    for split, names in splits.items():
        (root / "ImageSets" / f"{split}.txt").write_text("".join(f"{n}\n" for n in names))


def write_waymo_root(root, train_frames, val_frames, point_cloud_range, num_points=150_000,
                     num_boxes=(20, 40), seed=0, tag="waymo_processed_data_v0_5_0"):
    """Waymo's extracted layout under `root`: one sequence per entry of
    `train_frames` / `val_frames` (its frame count), each frame `num_points`
    points in 6 columns, a share NLZ_SHARE of them flagged 1 in the NLZ
    column and the rest -1, its `<seq>.pkl` of infos, and ImageSets/
    {train,val}.txt naming the sequences as .tfrecord files. Returns
    {split: [sequence names]}."""
    root = Path(root)
    rng = np.random.RandomState(seed)

    def finish(path, pts, nlz, boxes):
        """Save the frame; its boxes' point counts (NLZ points left out)."""
        np.save(path, np.concatenate([pts, nlz[:, None].astype(np.float32)], axis=1))
        return npg.points_in_boxes(pts[nlz < 0, :3], boxes).sum(0).astype(np.int32)

    out = {"train": [], "val": []}
    with ThreadPoolExecutor(WRITER_THREADS) as pool:
        for split, counts in (("train", train_frames), ("val", val_frames)):
            for s, n_frames in enumerate(counts):
                seq = f"segment-{split}{s:03d}_with_camera_labels"
                seq_dir = root / tag / seq
                seq_dir.mkdir(parents=True, exist_ok=True)
                infos, counted = [], []
                for i in range(n_frames):
                    pts, boxes, names = scene(rng, WAYMO_DIMS, point_cloud_range, num_points,
                                              num_boxes)
                    nlz = np.where(rng.uniform(size=len(pts)) < NLZ_SHARE, 1.0, -1.0)
                    counted.append(pool.submit(finish, seq_dir / f"{i:04d}.npy", pts, nlz,
                                               boxes))
                    infos.append({
                        "point_cloud": {"lidar_sequence": seq, "sample_idx": i},
                        "frame_id": f"{seq}_{i:03d}",
                        "annos": {"name": names, "gt_boxes_lidar": boxes,
                                  "difficulty": np.zeros(len(boxes), np.int32)},
                    })
                for info, n in zip(infos, counted):
                    info["annos"]["num_points_in_gt"] = n.result()
                with open(seq_dir / f"{seq}.pkl", "wb") as f:
                    pickle.dump(infos, f)
                out[split].append(seq)
    _write_split_files(root, {k: [f"{s}.tfrecord" for s in v] for k, v in out.items()})
    return out


def write_once_root(root, train_frames, val_frames, point_cloud_range, num_points=60_000,
                    num_boxes=(20, 40), seed=0):
    """The raw ONCE layout under `root`: one sequence per split (`train_frames`
    and `val_frames` frames), each frame data/<seq>/lidar_roof/<frame>.bin
    in 4 float32 columns and its annos in data/<seq>/<seq>.json; ImageSets/
    {train,val}.txt. Returns {split: (sequence, [frame ids])}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    out = {}
    for s, (split, n) in enumerate((("train", train_frames), ("val", val_frames))):
        seq = f"{s:06d}"
        lidar_dir = root / "data" / seq / "lidar_roof"
        lidar_dir.mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(n):
            fid = str(1616000000000 + 100 * (1000 * s + i))
            pts, boxes, names = scene(rng, ONCE_DIMS, point_cloud_range, num_points, num_boxes)
            np.ascontiguousarray(pts[:, :4]).tofile(lidar_dir / f"{fid}.bin")
            frames.append({"frame_id": fid, "pose": np.eye(4).tolist(),
                           "annos": {"names": names.tolist(), "boxes_3d": boxes.tolist()}})
        (root / "data" / seq / f"{seq}.json").write_text(
            json.dumps({"meta_info": {}, "calib": {}, "frames": frames}))
        out[split] = (seq, [f["frame_id"] for f in frames])
    _write_split_files(root, {split: [seq] for split, (seq, _) in out.items()})
    return out


def write_lyft_root(root, n_train, n_val, max_sweeps=5, points_per_sweep=34_000,
                    num_boxes=(20, 40), seed=0):
    """Lyft's nuScenes-format tables under `root` through `nuscenes_synthetic`,
    with the Lyft classes that nuScenes also has (LYFT_CLASSES), and their
    infos (`create_nuscenes_infos`, `max_sweeps`) as lyft_infos_{train,val}.pkl.
    Returns {split: path}."""
    from . import nuscenes_synthetic

    written = nuscenes_synthetic.write_root(root, n_train, n_val,
                                            points_per_sweep=points_per_sweep,
                                            num_boxes=num_boxes, seed=seed,
                                            classes=LYFT_CLASSES)
    return nuscenes_synthetic.write_infos(root, written, max_sweeps,
                                          name="lyft_infos_{split}.pkl")


def write_custom_root(root, n_train, n_val, point_cloud_range, num_points=60_000,
                      num_boxes=(20, 40), seed=0):
    """The Custom layout under `root`: points/<id>.npy (x y z intensity),
    labels/<id>.txt, ImageSets/{train,val}.txt. Returns (train ids, val ids)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    for d in ("points", "labels"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ids = [f"{i:06d}" for i in range(n_train + n_val)]
    for idx in ids:
        pts, boxes, names = scene(rng, CUSTOM_DIMS, point_cloud_range, num_points,
                                  num_boxes)
        np.save(root / "points" / f"{idx}.npy", np.ascontiguousarray(pts[:, :4]))
        (root / "labels" / f"{idx}.txt").write_text("".join(
            " ".join(f"{v:.4f}" for v in b) + f" {n}\n" for b, n in zip(boxes, names)))
    _write_split_files(root, {"train": ids[:n_train], "val": ids[n_train:]})
    return ids[:n_train], ids[n_train:]


def write_pandaset_root(root, n_train, n_val, point_cloud_range, num_points=60_000,
                        num_boxes=(20, 40), seed=0):
    """Pandaset's converted layout under `root`: points/<frame>.npy (x y z
    intensity) and pandaset_infos_{train,val}.pkl. Returns {split: path}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / "points").mkdir(parents=True, exist_ok=True)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        infos = []
        for i in range(n):
            fid = f"{split}_{i:03d}"
            pts, boxes, names = scene(rng, PANDASET_DIMS, point_cloud_range, num_points,
                                      num_boxes)
            np.save(root / "points" / f"{fid}.npy", np.ascontiguousarray(pts[:, :4]))
            infos.append({"frame_id": fid,
                          "annos": {"name": names, "gt_boxes_lidar": boxes}})
        out[split] = root / f"pandaset_infos_{split}.pkl"
        with open(out[split], "wb") as f:
            pickle.dump(infos, f)
    return out


def write_argo2_root(root, n_train, n_val, point_cloud_range, num_points=100_000,
                     num_boxes=(20, 40), seed=0):
    """Argoverse 2's converted layout under `root`, as `convert_av2_sensor`
    writes it from one log per split: training/velodyne/<sample>.bin (x y z
    intensity, intensities 0-255) and argo2_infos_{train,val}.pkl with the
    cuboids' location, dimensions and yaw. Returns {split: path}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / "training" / "velodyne").mkdir(parents=True, exist_ok=True)
    out = {}
    for prefix, split, n in (("0", "train", n_train), ("1", "val", n_val)):
        infos = []
        for i in range(n):
            sample_idx = f"{prefix}000{i:03d}"
            pts, boxes, names = scene(rng, ARGO2_DIMS, point_cloud_range, num_points,
                                      num_boxes)
            pts[:, 3] *= 255.0
            np.ascontiguousarray(pts[:, :4]).tofile(
                root / "training" / "velodyne" / f"{sample_idx}.bin")
            inside = npg.points_in_boxes(pts[:, :3], boxes).sum(0).astype(np.int32)
            m = len(names)
            infos.append({
                "uuid": f"log_{split}/{315_970_000_000_000_000 + 100_000_000 * i}",
                "sample_idx": sample_idx, "frame_id": sample_idx,
                "point_cloud": {"num_features": 4,
                                "velodyne_path": f"training/velodyne/{sample_idx}.bin"},
                "image": {}, "calib": {}, "pose": {}, "sweeps": [],
                "annos": {"name": names, "truncated": np.zeros(m),
                          "occluded": np.zeros(m, np.int64), "alpha": -10 * np.ones(m),
                          "dimensions": boxes[:, 3:6].astype(np.float64),
                          "location": boxes[:, 0:3].astype(np.float64),
                          "rotation_y": boxes[:, 6].astype(np.float64),
                          "index": np.arange(m, dtype=np.int32),
                          "num_points_in_gt": inside},
            })
        out[split] = root / f"argo2_infos_{split}.pkl"
        with open(out[split], "wb") as f:
            pickle.dump(infos, f)
    return out
