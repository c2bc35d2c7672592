"""A synthetic nuScenes raw-table tree for smoke runs and tests (the nuScenes
counterpart of `kitti_synthetic`), written with numpy and json only.

`write_root` lays out what `create_nuscenes_infos` reads: a `v1.0-mini`-style
version directory of JSON tables (scene, sample, sample_data, ego_pose,
calibrated_sensor, sensor, log, category, sample_annotation) and LIDAR_TOP
clouds, key frames under samples/ and sweeps under sweeps/, 5 float32
columns (x, y, z, intensity, ring) in the sensor frame. Each scene is a run
of key frames 0.5 s apart, chained through prev/next, with 9 non-key sweeps
20 Hz apart before each key frame. The ego drives along a slow curve
(5 m/s, yaw rate 0.05 rad/s); LIDAR_TOP sits 1.84 m up, turned -90° about
z (x right, y forward), as nuScenes mounts it. Each scene holds 20-40
objects of all ten detection classes at their anchor sizes; the vehicles,
cyclists and pedestrians among them move along their heading, so every
annotation has prev/next neighbours and a defined velocity. A sweep has
`points_per_sweep` points (about 34,000 in a nuScenes 32-beam sweep):
points inside each box, then the ground out to 55 m.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from .nuscenes_tables import Quaternion

# detection class → (nuScenes category, (l, w, h), moves)
CLASSES = {
    "car": ("vehicle.car", (4.63, 1.97, 1.74), True),
    "truck": ("vehicle.truck", (6.93, 2.51, 2.84), True),
    "construction_vehicle": ("vehicle.construction", (6.37, 2.85, 3.19), False),
    "bus": ("vehicle.bus.rigid", (10.5, 2.94, 3.47), True),
    "trailer": ("vehicle.trailer", (12.29, 2.90, 3.87), False),
    "barrier": ("movable_object.barrier", (0.50, 2.53, 0.98), False),
    "motorcycle": ("vehicle.motorcycle", (2.11, 0.77, 1.47), True),
    "bicycle": ("vehicle.bicycle", (1.70, 0.60, 1.28), True),
    "pedestrian": ("human.pedestrian.adult", (0.73, 0.67, 1.77), True),
    "traffic_cone": ("movable_object.trafficcone", (0.41, 0.41, 1.07), False),
}
KEY_DT_US = 500_000     # key frames at 2 Hz
SWEEP_DT_US = 50_000    # LIDAR_TOP at 20 Hz
SWEEPS_PER_KEY = 9
EGO_SPEED = 5.0         # m/s
EGO_YAW_RATE = 0.05     # rad/s
LIDAR_HEIGHT = 1.84
LIDAR_ROT = Quaternion(axis=(0, 0, 1), angle=-np.pi / 2)


def _ego_pose(t):
    """Ego translation (3,) and yaw at t seconds into the scene."""
    yaw = EGO_YAW_RATE * t
    if EGO_YAW_RATE:
        r = EGO_SPEED / EGO_YAW_RATE
        xy = [r * np.sin(yaw), r * (1 - np.cos(yaw))]
    else:
        xy = [EGO_SPEED * t, 0.0]
    return np.array([*xy, 0.0]), yaw


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _place_objects(rng, n, names):
    """n objects (class, centre xy, yaw, speed) in the scene's start frame,
    every class of `names` at least once, with no two footprints closer than
    their radii."""
    classes = names + list(rng.choice(names, n - len(names)))
    objs = []
    for cls in classes:
        l, w, _ = CLASSES[cls][1]
        radius = 0.5 * np.hypot(l, w)
        for _ in range(200):
            xy = np.array([rng.uniform(-30, 45), rng.uniform(-35, 35)])
            if np.hypot(*xy) < 6 + radius:
                continue
            if all(np.hypot(*(xy - o["xy"])) > radius + o["radius"] + 1.0 for o in objs):
                break
        moves = CLASSES[cls][2] and rng.uniform() < 0.7
        objs.append({"cls": cls, "xy": xy, "radius": radius, "yaw": rng.uniform(-np.pi, np.pi),
                     "speed": rng.uniform(0.5, 1.5 if cls == "pedestrian" else 6.0) if moves
                     else 0.0})
    return objs


def _object_state(obj, t):
    """Global centre (3,) and yaw of an object at t seconds."""
    h = CLASSES[obj["cls"]][1][2]
    d = obj["speed"] * t * np.array([np.cos(obj["yaw"]), np.sin(obj["yaw"])])
    return np.array([*(obj["xy"] + d), h / 2]), obj["yaw"]


def _sweep_points(rng, objs, t, n_points):
    """(n_points, 5) float32 in the LIDAR_TOP frame at t seconds, and each
    object's point count."""
    ego_t, ego_yaw = _ego_pose(t)
    parts, counts = [], []
    for obj in objs:
        center, yaw = _object_state(obj, t)
        l, w, h = CLASSES[obj["cls"]][1]
        dist = np.hypot(*(center[:2] - ego_t[:2]))
        k = int(np.clip(4000.0 / max(dist, 5.0), 10, 400))
        local = rng.uniform(-0.5, 0.5, (k, 3)) * [l, w, h] * 0.98
        parts.append(local @ _rot_z(yaw).T + center)
        counts.append(k)
    n_ground = max(n_points - sum(counts), 0)
    r = rng.uniform(1.5, 55.0, n_ground)
    a = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a), rng.normal(0.0, 0.03, n_ground)], axis=1)
    glob = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))
    # global → ego (row vectors: (p - t) @ R), the ground drawn in the ego frame
    ego = np.concatenate([(glob - ego_t) @ _rot_z(ego_yaw), ground], axis=0)
    # ego → LIDAR_TOP
    lidar = (ego - [0.0, 0.0, LIDAR_HEIGHT]) @ LIDAR_ROT.rotation_matrix
    out = np.zeros((len(lidar), 5), np.float32)
    out[:, :3] = lidar
    out[:, 3] = rng.uniform(0, 100, len(lidar))
    out[:, 4] = rng.randint(0, 32, len(lidar))
    return out[:n_points], counts


def write_root(root, n_train: int = 16, n_val: int = 8, frames_per_scene: int = 4,
               points_per_sweep: int = 34000, num_boxes=(20, 40), seed: int = 0,
               version: str = "v1.0-mini", classes=None):
    """Write the tree under `root`: n_train train and n_val val key frames in
    scenes of `frames_per_scene`, objects of `classes` (detection names, keys
    of CLASSES; default all ten). Returns {"version", "train": [sample
    tokens], "val": [...], "gt": {split: annotations written}}."""
    classes = list(classes or CLASSES)
    root = Path(root)
    tdir = root / version
    tdir.mkdir(parents=True, exist_ok=True)
    for sub in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    tables = {
        "sensor": [{"token": "sen_lid", "channel": "LIDAR_TOP", "modality": "lidar"}],
        "calibrated_sensor": [{"token": "cs_lid", "sensor_token": "sen_lid",
                               "translation": [0.0, 0.0, LIDAR_HEIGHT],
                               "rotation": LIDAR_ROT.q.tolist(), "camera_intrinsic": []}],
        "log": [{"token": "log0", "logfile": "synthetic", "location": "synthetic"}],
        "category": [{"token": f"cat_{det}", "name": CLASSES[det][0]} for det in classes],
        "scene": [], "sample": [], "sample_data": [], "ego_pose": [], "sample_annotation": [],
    }
    written = {"version": version, "train": [], "val": [], "gt": {"train": 0, "val": 0}}
    scenes = []
    for split, n in (("train", n_train), ("val", n_val)):
        for start in range(0, n, frames_per_scene):
            scenes.append((split, min(frames_per_scene, n - start)))
    t0_us = 1_500_000_000_000_000
    for s, (split, n_keys) in enumerate(scenes):
        objs = _place_objects(rng, int(rng.randint(num_boxes[0], num_boxes[1] + 1)), classes)
        samples = [f"s{s}_k{k}" for k in range(n_keys)]
        tables["scene"].append({"token": f"scene{s}", "log_token": "log0",
                                "name": f"scene-{s:04d}", "nbr_samples": n_keys,
                                "first_sample_token": samples[0],
                                "last_sample_token": samples[-1]})
        n_sweeps = n_keys * (SWEEPS_PER_KEY + 1)
        sd_tokens = [f"s{s}_sd{i}" for i in range(n_sweeps)]
        scene_t0 = t0_us + s * 100_000_000
        for i in range(n_sweeps):
            key, k = (i + 1) % (SWEEPS_PER_KEY + 1) == 0, i // (SWEEPS_PER_KEY + 1)
            # the key frames sit on the 2 Hz grid, the sweeps 20 Hz before each
            ts = scene_t0 + k * KEY_DT_US - (SWEEPS_PER_KEY - i % (SWEEPS_PER_KEY + 1)) * SWEEP_DT_US
            t = (ts - scene_t0) * 1e-6
            ego_t, ego_yaw = _ego_pose(t)
            tables["ego_pose"].append({
                "token": f"{sd_tokens[i]}_pose", "timestamp": ts, "translation": ego_t.tolist(),
                "rotation": Quaternion(axis=(0, 0, 1), angle=ego_yaw).q.tolist()})
            pts, counts = _sweep_points(rng, objs, t, points_per_sweep)
            name = f"{'samples' if key else 'sweeps'}/LIDAR_TOP/{sd_tokens[i]}.pcd.bin"
            pts.tofile(root / name)
            tables["sample_data"].append({
                "token": sd_tokens[i], "sample_token": samples[k], "is_key_frame": key,
                "calibrated_sensor_token": "cs_lid", "ego_pose_token": f"{sd_tokens[i]}_pose",
                "filename": name, "fileformat": "pcd", "timestamp": ts,
                "prev": sd_tokens[i - 1] if i else "",
                "next": sd_tokens[i + 1] if i + 1 < n_sweeps else ""})
            if not key:
                continue
            tables["sample"].append({"token": samples[k], "scene_token": f"scene{s}",
                                     "timestamp": ts, "prev": samples[k - 1] if k else "",
                                     "next": samples[k + 1] if k + 1 < n_keys else ""})
            written[split].append(samples[k])
            for j, obj in enumerate(objs):
                center, yaw = _object_state(obj, t)
                cat, (l, w, h), _ = CLASSES[obj["cls"]]
                tables["sample_annotation"].append({
                    "token": f"s{s}_k{k}_a{j}", "sample_token": samples[k],
                    "instance_token": f"s{s}_i{j}", "category_token": f"cat_{obj['cls']}",
                    "translation": center.tolist(), "size": [w, l, h],
                    "rotation": Quaternion(axis=(0, 0, 1), angle=yaw).q.tolist(),
                    "num_lidar_pts": counts[j], "num_radar_pts": 0, "visibility_token": "4",
                    "attribute_tokens": [],
                    "prev": f"s{s}_k{k - 1}_a{j}" if k else "",
                    "next": f"s{s}_k{k + 1}_a{j}" if k + 1 < n_keys else ""})
            written["gt"][split] += len(objs)
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    return written


def write_infos(root, written, max_sweeps: int = 10,
                name: str = "nuscenes_infos_{max_sweeps}sweeps_{split}.pkl"):
    """create_nuscenes_infos over the tree, split by the scenes `write_root`
    wrote (`written` is its return value): `name` under `root` for each split
    (by default the names the nuScenes dataset config reads). Returns
    {split: path}."""
    from .nuscenes_dataset import create_nuscenes_infos

    infos = create_nuscenes_infos(root, written["version"], max_sweeps=max_sweeps)
    paths = {}
    for split in ("train", "val"):
        tokens = set(written[split])
        paths[split] = Path(root) / name.format(max_sweeps=max_sweeps, split=split)
        with open(paths[split], "wb") as f:
            pickle.dump([i for i in infos if i["token"] in tokens], f)
    return paths
