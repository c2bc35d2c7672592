"""nuScenes -> KITTI-format conversion, pipeline 1 of 4 (port of the JAX
package's tools/nuscenes2kitti.py, itself the reference's
tools/nuscenes2kitti.py: CAM_FRONT + LIDAR_TOP single-view export, KITTI frame
rotation, truncation by 2D-box clipping, occlusion by a depth-sorted painter's
algorithm, ego-pose txt pairs). Devkit-free: raw JSON tables and the
quaternion math of data/nuscenes_tables.py. Runs on the host only.

    python -m dfu3d_tpu_torch.tools.nuscenes2kitti --dataroot data/nuscenes \\
        --split train --image_count 28130 --nusc_kitti_dir data/nuscenes_kitti_format

Writes <nusc_kitti_dir>/<split>_<image_count>/ with label_2/, calib/,
image_2/, velodyne/, pose/ and ImageSets/<split>_<image_count>.txt. The
CAM_FRONT JPEG -> PNG step needs PIL and raises when a source image exists
and PIL does not.
"""
from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np

from ..data.nuscenes_tables import (
    Box,
    NuScenesTables,
    Quaternion,
    category_to_detection_name,
    read_nuscenes_lidar,
    transform_matrix,
)
from ..utils.common import create_logger

KITTI_CATEGORY = [
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone",
]
IMSIZE = (1600, 900)  # nuScenes CAM_FRONT (w, h)


def box_nuscenes_to_kitti(box_lidar_nusc: Box, velo_to_cam_rot: Quaternion,
                          velo_to_cam_trans, kitti_to_nu_lidar_inv: Quaternion):
    """devkit KittiDB.box_nuscenes_to_kitti semantics."""
    box = box_lidar_nusc.copy()
    box.rotate(kitti_to_nu_lidar_inv)
    box.rotate(velo_to_cam_rot)
    box.translate(velo_to_cam_trans)
    # KITTI location is the bottom center; camera y points down
    box.translate(np.array([0.0, box.wlh[2] / 2, 0.0]))
    return box


def box_to_string(name, box: Box, bbox_2d, truncation, occlusion, alpha):
    """devkit KittiDB.box_to_string layout (h, w, l ordering)."""
    v = box.rotation_matrix @ np.array([1.0, 0, 0])
    yaw = -np.arctan2(v[2], v[0])
    return (
        f"{name} {truncation:.2f} {int(occlusion):d} {alpha:.2f} "
        f"{bbox_2d[0]:.2f} {bbox_2d[1]:.2f} {bbox_2d[2]:.2f} {bbox_2d[3]:.2f} "
        f"{box.wlh[2]:.2f} {box.wlh[0]:.2f} {box.wlh[1]:.2f} "
        f"{box.center[0]:.2f} {box.center[1]:.2f} {box.center[2]:.2f} "
        f"{yaw:.2f}"
    )


def get_alpha(box_cam: Box):
    x, _, z = box_cam.center
    yaw, _, _ = box_cam.orientation.yaw_pitch_roll
    yaw = -yaw
    return yaw - np.arctan2(x, z)


def project_to_2d(box_cam: Box, p_left, height, width):
    """(reference project_to_2d:62-100): bbox + truncation, None if off-image."""
    box = box_cam.copy()
    box.translate(np.array([0.0, -box.wlh[2] / 2, 0.0]))
    corners = box.corners()  # (3, 8)
    front = corners[:, corners[2] > 0]
    if front.shape[1] == 0:
        return None, None
    proj = p_left[:3, :3] @ front
    xs = proj[0] / proj[2]
    ys = proj[1] / proj[2]
    bbox = (xs.min(), ys.min(), xs.max(), ys.max())
    inside = (0 <= bbox[1] < height and 0 < bbox[3] <= height) and (
        0 <= bbox[0] < width and 0 < bbox[2] <= width
    )
    valid = (0 <= bbox[1] < height or 0 < bbox[3] <= height) and (
        0 <= bbox[0] < width or 0 < bbox[2] <= width
    )
    if not valid:
        return None, None
    if not inside:
        clipped = [
            max(0, bbox[0]), max(0, bbox[1]), min(width, bbox[2]), min(height, bbox[3])
        ]
        truncated = 1.0 - ((clipped[2] - clipped[0]) * (clipped[3] - clipped[1])) / (
            (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
        )
        return clipped, truncated
    return list(bbox), 0.0


def write_occlusion(objs, height, width):
    """Depth-sorted painter's algorithm (reference write_occlusion:109-123)."""
    _map = np.ones((height, width), dtype=np.int16) * -1
    objs = sorted(objs, key=lambda x: x["depth"], reverse=True)
    for i, obj in enumerate(objs):
        b = obj["bbox_2d"]
        _map[int(round(b[1])) : int(round(b[3])), int(round(b[0])) : int(round(b[2]))] = i
    unique, counts = np.unique(_map, return_counts=True)
    counts = dict(zip(unique.tolist(), counts.tolist()))
    for i, obj in enumerate(objs):
        visible = counts.get(i, 0)
        area = max(
            (obj["bbox_2d"][3] - obj["bbox_2d"][1])
            * (obj["bbox_2d"][2] - obj["bbox_2d"][0]),
            1e-6,
        )
        occlusion = 1.0 - visible / area
        obj["occluded"] = int(np.clip(occlusion * 4, 0, 3))
    return objs


def jpeg_to_png(src: Path, dst: Path):
    """The camera image as a PNG. Decoding a JPEG needs PIL, which is imported
    here, only when a source image exists; without it this raises."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"nuscenes2kitti: the JPEG -> PNG step for {src} needs PIL, which "
                          "is not installed") from e
    Image.open(src).save(dst, "PNG")


def split_sample_tokens(nusc: NuScenesTables, split: str, scene_list_file=None):
    """Samples of a split. With no devkit the official 700/150 scene lists must
    come from --scene_list_file (one scene name per line); split='all' takes
    everything."""
    if split == "all" and scene_list_file is None:
        return [s["token"] for s in nusc.sample]
    if scene_list_file is None:
        raise ValueError("official splits need --scene_list_file (one scene name per line); "
                         "or use --split all")
    wanted = set(Path(scene_list_file).read_text().split())
    tokens = []
    for s in nusc.sample:
        scene = nusc.get("scene", s["scene_token"])
        if scene["name"] in wanted:
            tokens.append(s["token"])
    return tokens


def convert(dataroot, nusc_kitti_dir, split="train", image_count=28130,
            nusc_version="v1.0-trainval", cam_name="CAM_FRONT",
            lidar_name="LIDAR_TOP", shuffle=False, scene_list_file=None,
            logger=None):
    nusc = NuScenesTables(dataroot, nusc_version)
    kitti_to_nu_lidar = Quaternion(axis=(0, 0, 1), angle=np.pi / 2)
    kitti_to_nu_lidar_inv = kitti_to_nu_lidar.inverse

    sample_tokens = split_sample_tokens(nusc, split, scene_list_file)
    sample_tokens = sample_tokens[:image_count]
    if shuffle:
        random.seed(1024)
        random.shuffle(sample_tokens)

    out_split = f"{split}_{image_count}"
    root = Path(nusc_kitti_dir) / out_split
    for sub in ["label_2", "calib", "image_2", "velodyne", "pose", "ImageSets"]:
        (root / sub).mkdir(parents=True, exist_ok=True)

    split_lines = []
    for token_idx, sample_token in enumerate(sample_tokens):
        sample = nusc.get("sample", sample_token)
        cam_token = nusc.sample_data_token(sample, cam_name)
        lid_token = nusc.sample_data_token(sample, lidar_name)
        sd_cam = nusc.get("sample_data", cam_token)
        sd_lid = nusc.get("sample_data", lid_token)
        cs_cam = nusc.get("calibrated_sensor", sd_cam["calibrated_sensor_token"])
        cs_lid = nusc.get("calibrated_sensor", sd_lid["calibrated_sensor_token"])

        lid_to_ego = transform_matrix(
            cs_lid["translation"], Quaternion(wxyz=cs_lid["rotation"]), inverse=False
        )
        ego_to_cam = transform_matrix(
            cs_cam["translation"], Quaternion(wxyz=cs_cam["rotation"]), inverse=True
        )
        velo_to_cam = ego_to_cam @ lid_to_ego
        velo_to_cam_kitti = velo_to_cam @ transform_matrix(
            [0, 0, 0], kitti_to_nu_lidar, inverse=False
        )
        velo_to_cam_rot = velo_to_cam_kitti[:3, :3]
        velo_to_cam_trans = velo_to_cam_kitti[:3, 3]

        p_left = np.zeros((3, 4))
        p_left[:3, :3] = np.asarray(cs_cam["camera_intrinsic"])

        token = "%06d" % token_idx
        split_lines.append(token)

        # image (jpg → png)
        src_im = Path(dataroot) / sd_cam["filename"]
        dst_im = root / "image_2" / f"{token}.png"
        if src_im.exists() and not dst_im.exists():
            jpeg_to_png(src_im, dst_im)

        # lidar: rotate into KITTI frame, keep (x, y, z, intensity)
        pts = read_nuscenes_lidar(Path(dataroot) / sd_lid["filename"])
        rot = kitti_to_nu_lidar_inv.rotation_matrix.astype(np.float32)
        pts[:, :3] = pts[:, :3] @ rot.T
        pts.astype(np.float32).tofile(root / "velodyne" / f"{token}.bin")

        # calib
        transforms = {
            "P0": np.zeros((3, 4)), "P1": np.zeros((3, 4)), "P2": p_left,
            "P3": np.zeros((3, 4)), "R0_rect": np.eye(3),
            "Tr_velo_to_cam": np.hstack(
                [velo_to_cam_rot, velo_to_cam_trans.reshape(3, 1)]
            ),
            "Tr_imu_to_velo": np.zeros((3, 4)),
        }
        with open(root / "calib" / f"{token}.txt", "w") as f:
            for key, val in transforms.items():
                f.write(f"{key}: " + " ".join("%.12e" % v for v in val.flatten()) + "\n")

        # ego-pose pair for interpolation (reference :353-360)
        pose = nusc.get("ego_pose", sd_lid["ego_pose_token"])
        next_token = sd_lid.get("next", "")
        if next_token:
            sd_next = nusc.get("sample_data", next_token)
            cs_next = nusc.get("calibrated_sensor", sd_next["calibrated_sensor_token"])
            pose_next = nusc.get("ego_pose", sd_next["ego_pose_token"])
            fmt = lambda lst: ",".join("%.6f" % v for v in lst)
            (root / "pose" / f"{token}.txt").write_text(
                "\n".join(
                    [
                        fmt(pose["translation"] + pose["rotation"]),
                        fmt(cs_lid["translation"] + cs_lid["rotation"]),
                        fmt(pose_next["translation"] + pose_next["rotation"]),
                        fmt(cs_next["translation"] + cs_next["rotation"]),
                    ]
                )
                + "\n"
            )

        # labels
        q_velo_to_cam = Quaternion(matrix=velo_to_cam_rot)
        objs = []
        for ann in nusc.sample_annotations_of(sample_token):
            cat = nusc.get("category", ann["category_token"])["name"] if (
                "category_token" in ann
            ) else ann.get("category_name", "")
            detection_name = category_to_detection_name(cat)
            if detection_name is None or detection_name not in KITTI_CATEGORY:
                continue
            box_lidar = nusc.box_in_lidar_frame(ann, sd_lid)
            box_cam = box_nuscenes_to_kitti(
                box_lidar, q_velo_to_cam, velo_to_cam_trans, kitti_to_nu_lidar_inv
            )
            alpha = get_alpha(box_cam)
            bbox_2d, truncated = project_to_2d(box_cam, p_left, IMSIZE[1], IMSIZE[0])
            if bbox_2d is None:
                continue
            objs.append(
                {
                    "detection_name": detection_name.capitalize(),
                    "box_cam_kitti": box_cam,
                    "alpha": alpha,
                    "bbox_2d": bbox_2d,
                    "truncated": truncated,
                    "depth": float(np.linalg.norm(box_cam.center[:3])),
                }
            )
        objs = write_occlusion(objs, IMSIZE[1], IMSIZE[0])
        lines = [
            box_to_string(
                o["detection_name"], o["box_cam_kitti"], o["bbox_2d"],
                o["truncated"], o["occluded"], o["alpha"],
            )
            for o in objs
        ]
        (root / "label_2" / f"{token}.txt").write_text(
            "\n".join(lines) + ("\n" if lines else "")
        )
        if logger and (token_idx + 1) % 500 == 0:
            logger.info(f"{token_idx + 1}/{len(sample_tokens)} samples converted")

    (root / "ImageSets" / f"{out_split}.txt").write_text("\n".join(split_lines) + "\n")
    return root


def main(argv=None):
    """Convert; returns the output root."""
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch nuScenes -> KITTI")
    parser.add_argument("--dataroot", type=str, required=True)
    parser.add_argument("--nusc_kitti_dir", type=str,
                        default="./data/nuscenes_kitti_format/")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--image_count", type=int, default=28130)
    parser.add_argument("--nusc_version", type=str, default="v1.0-trainval")
    parser.add_argument("--cam_name", type=str, default="CAM_FRONT")
    parser.add_argument("--lidar_name", type=str, default="LIDAR_TOP")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--scene_list_file", type=str, default=None,
                        help="scene names of the split, one per line")
    args = parser.parse_args(argv)

    logger = create_logger()
    root = convert(
        args.dataroot, args.nusc_kitti_dir, args.split, args.image_count,
        args.nusc_version, args.cam_name, args.lidar_name, args.shuffle,
        args.scene_list_file, logger,
    )
    logger.info(f"converted to {root}")
    return root


if __name__ == "__main__":
    main()
