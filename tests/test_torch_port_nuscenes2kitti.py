"""Port parity: pipeline 1, the nuScenes -> KITTI converter, against the JAX
package's tools/nuscenes2kitti.py (imported by path), on raw-table trees
written here:

* the one-car tree of tests/test_nuscenes2kitti.py's fixture, and a richer
  one (two key frames linked by `next`, so pose/ files are written; six
  categories, one unmapped, one box behind the camera, one crossing the
  image edge, two that occlude each other): label_2, calib, velodyne, pose
  and ImageSets byte-identical between the two converters;
* the geometric round trip through the port's own calibration and label
  reader: the car comes back at its KITTI-lidar location and size;
* the port's own copy of nuscenes_tables equals the JAX one on quaternion
  round trips and box transforms (exactly: the same numpy arithmetic);
* a tree with a CAM_FRONT JPEG and no PIL raises, naming the step.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from dfu3d_tpu.data import nuscenes_tables as jtables
from dfu3d_tpu_torch.core.geometry.calibration import Calibration
from dfu3d_tpu_torch.data import kitti_io
from dfu3d_tpu_torch.data import nuscenes_tables as ttables
from dfu3d_tpu_torch.tools import nuscenes2kitti as tconv
from test_nuscenes2kitti import nusc_root  # noqa: F401  (the JAX test's fixture)

REPO = Path(__file__).resolve().parents[1]
COMPARED = ("label_2", "calib", "velodyne", "pose", "ImageSets")


def jax_converter():
    spec = importlib.util.spec_from_file_location("jax_nuscenes2kitti",
                                                  REPO / "tools" / "nuscenes2kitti.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quat(axis, angle):
    return ttables.Quaternion(axis=axis, angle=angle).q.tolist()


def richer_tree(root: Path) -> Path:
    """The fixture's tables grown to two linked key frames with six annotated
    objects each (car, truck, pedestrian, bicycle, a barrier behind the
    camera, a cone across the image edge) and one unmapped category."""
    tdir = root / "v1.0-mini"
    tables = {p.stem: json.loads(p.read_text()) for p in tdir.glob("*.json")}
    rng = np.random.RandomState(1)
    lid = root / "samples" / "LIDAR_TOP"
    for k in (1,):
        raw = np.concatenate([rng.uniform(-20, 20, (300, 3)), rng.uniform(0, 1, (300, 1)),
                              np.zeros((300, 1))], 1).astype(np.float32)
        raw.tofile(lid / f"lid{k}.pcd.bin")
    tables["ego_pose"].append({"token": "pose1", "translation": [2.0, 0.5, 0.0],
                               "rotation": _quat((0, 0, 1), 0.05)})
    tables["sample"][0]["next"] = "samp1"
    tables["sample"].append({"token": "samp1", "scene_token": "scene0", "timestamp": 500000,
                             "prev": "samp0", "next": ""})
    tables["sample_data"][0]["next"] = "sd_lid1"
    tables["sample_data"] += [
        {"token": "sd_lid1", "sample_token": "samp1", "is_key_frame": True,
         "calibrated_sensor_token": "cs_lid", "ego_pose_token": "pose1",
         "filename": "samples/LIDAR_TOP/lid1.pcd.bin", "next": ""},
        {"token": "sd_cam1", "sample_token": "samp1", "is_key_frame": True,
         "calibrated_sensor_token": "cs_cam", "ego_pose_token": "pose1",
         "filename": "samples/CAM_FRONT/cam1.jpg", "next": ""}]
    cats = {"cat_truck": "vehicle.truck", "cat_ped": "human.pedestrian.adult",
            "cat_bike": "vehicle.bicycle", "cat_bar": "movable_object.barrier",
            "cat_cone": "movable_object.trafficcone", "cat_anim": "animal"}
    tables["category"] += [{"token": t, "name": n} for t, n in cats.items()]
    objs = [("cat_car", [12.0, 1.0, 0.9], [1.9, 4.5, 1.5], 0.3),
            ("cat_truck", [25.0, -4.0, 1.5], [2.5, 8.0, 3.0], -0.2),
            ("cat_ped", [8.0, 1.2, 0.9], [0.6, 0.7, 1.8], 1.0),
            ("cat_bike", [15.0, 3.0, 0.7], [0.6, 1.7, 1.2], 2.0),
            ("cat_bar", [-6.0, 0.0, 0.5], [2.0, 0.5, 1.0], 0.0),
            ("cat_cone", [6.0, 3.8, 0.4], [0.8, 0.8, 0.8], 0.0),
            ("cat_anim", [9.0, -1.0, 0.4], [0.3, 0.6, 0.5], 0.0)]
    for s, sample in enumerate(("samp0", "samp1")):
        for i, (cat, xyz, wlh, yaw) in enumerate(objs):
            tables["sample_annotation"].append({
                "token": f"ann{s}_{i}", "sample_token": sample, "category_token": cat,
                "translation": [xyz[0] + 0.3 * s, xyz[1], xyz[2]], "size": wlh,
                "rotation": _quat((0, 0, 1), yaw + 0.1 * s)})
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    return root


def convert_both(root, tmp_path, **kw):
    jout = jax_converter().convert(root, tmp_path / "jax", split="all", image_count=10,
                                   nusc_version="v1.0-mini", **kw)
    tout = tconv.convert(root, tmp_path / "port", split="all", image_count=10,
                         nusc_version="v1.0-mini", **kw)
    return jout, tout


def assert_trees_identical(jout: Path, tout: Path):
    for sub in COMPARED:
        jfiles = sorted(p.relative_to(jout) for p in (jout / sub).rglob("*") if p.is_file())
        tfiles = sorted(p.relative_to(tout) for p in (tout / sub).rglob("*") if p.is_file())
        assert jfiles == tfiles, sub
        for rel in jfiles:
            assert (jout / rel).read_bytes() == (tout / rel).read_bytes(), rel


@pytest.mark.parametrize("tree", ["fixture", "richer"])
def test_converter_byte_identical(nusc_root, tmp_path, tree):  # noqa: F811
    root = richer_tree(nusc_root) if tree == "richer" else nusc_root
    jout, tout = convert_both(root, tmp_path)
    assert_trees_identical(jout, tout)
    if tree == "richer":
        assert len(list((tout / "pose").glob("*.txt"))) == 1   # only frame 0 has a next
        rows = [line.split() for line in (tout / "label_2" / "000000.txt").read_text()
                .splitlines()]
        names = [r[0] for r in rows]
        assert "Car" in names and "Barrier" not in names    # the barrier is behind the camera
        assert any(float(r[1]) > 0 for r in rows)            # the cone is truncated
        assert any(int(r[2]) > 0 for r in rows)              # and some box occluded


def test_roundtrip_geometry(nusc_root, tmp_path):  # noqa: F811
    out = tconv.main(["--dataroot", str(nusc_root), "--nusc_kitti_dir", str(tmp_path / "kitti"),
                      "--split", "all", "--image_count", "10", "--nusc_version", "v1.0-mini"])
    pts = np.fromfile(out / "velodyne" / "000000.bin", np.float32).reshape(-1, 4)
    assert np.allclose(pts[:, :3].mean(0), [10, 0, 1], atol=0.2)
    calib = Calibration(out / "calib" / "000000.txt")
    assert np.allclose(np.round(calib.V2C[:, :3]), [[0, -1, 0], [0, 0, -1], [1, 0, 0]])
    (o,) = kitti_io.get_objects_from_label(out / "label_2" / "000000.txt")
    assert o.cls_type == "Car"
    assert (o.l, o.w, o.h) == pytest.approx((4.0, 1.8, 1.6), abs=0.01)
    loc = calib.rect_to_lidar(o.loc[None])[0]
    loc[2] += o.h / 2
    assert np.allclose(loc, [10, 0, 1], atol=0.05), loc
    heading = -(o.ry + np.pi / 2)
    assert abs(((heading + np.pi) % (2 * np.pi)) - np.pi) < 0.02
    assert 0 <= o.box2d[0] < 800 < o.box2d[2] <= 1600
    assert (out / "ImageSets" / "all_10.txt").read_text().strip() == "000000"


def test_tables_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        axis, angle = rng.normal(size=3), rng.uniform(-np.pi, np.pi)
        jq, tq = jtables.Quaternion(axis=axis, angle=angle), ttables.Quaternion(axis=axis,
                                                                               angle=angle)
        assert np.array_equal(jq.q, tq.q)
        m = jq.rotation_matrix
        assert np.array_equal(jtables.Quaternion(matrix=m).q, ttables.Quaternion(matrix=m).q)
        assert np.array_equal(jq.yaw_pitch_roll, tq.yaw_pitch_roll)
        t = rng.normal(size=3)
        for inverse in (False, True):
            assert np.array_equal(jtables.transform_matrix(t, jq, inverse),
                                  ttables.transform_matrix(t, tq, inverse))
        jb = jtables.Box(t, [1.8, 4.0, 1.6], jq, velocity=[1.0, 2.0, 0.0])
        tb = ttables.Box(t, [1.8, 4.0, 1.6], tq, velocity=[1.0, 2.0, 0.0])
        jb.rotate(jq.inverse)
        tb.rotate(tq.inverse)
        assert np.array_equal(jb.corners(), tb.corners())
        assert np.array_equal(jb.velocity, tb.velocity)
    for cat in ("vehicle.car", "human.pedestrian.child", "animal", "vehicle.bus.bendy"):
        assert jtables.category_to_detection_name(cat) == ttables.category_to_detection_name(cat)


def test_jpeg_without_pil_raises(nusc_root, tmp_path, monkeypatch):  # noqa: F811
    cam = nusc_root / "samples" / "CAM_FRONT"
    cam.mkdir(parents=True)
    (cam / "cam0.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded before the import")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG -> PNG step"):
        tconv.convert(nusc_root, tmp_path / "port", split="all", image_count=10,
                      nusc_version="v1.0-mini")
