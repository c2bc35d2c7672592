"""Port parity: pipeline 2's CLIs end to end against the JAX CLIs, in-process
through `main(argv)`, fp32 on the CPU, on a tiny synthetic root (two
`make_scene` frames written by the port's `make_dataset`, one copy per
package):

* tools.generate_pseudo_boxes at the factory's defaults, with the JAX
  factory's RANSAC draws injected into the port: label files equal as parsed
  numbers within 1e-4, velodyne_depth npy files equal;
* tools.complete_depth with enet_ref and one reference-keyed checkpoint
  (--torch_ckpt) on both sides, and with the compact enet from one set of
  flax weights (an orbax checkpoint for JAX, the port's state_dict .pth),
  at a 64 × 128 crop: depth maps within 1e-4 of their largest value (the
  JAX CLI's nets are built in fp32 here; it builds them in bf16);
* the hand-off to pipeline 3: tools.create_infos --label_dir label_train
  counts each frame's boxes as the factory wrote them.

Run as a script, it measures the BEV recovery of the scenes' gt Cars by the
JAX factory and by the port on the CPU, on chip_smoke.py phase 8's eight
frames (seeds 0-7):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_pseudo_cli.py
"""
import importlib.util
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.models.depth_completion import ENet as JENet
from dfu3d_tpu.models.penet_ref import ENetRef as JENetRef
from dfu3d_tpu_torch import convert
from dfu3d_tpu_torch.models import depth_completion as tdc
from dfu3d_tpu_torch.pseudo import ops as tops
from dfu3d_tpu_torch.pseudo import synthetic as tsynth
from dfu3d_tpu_torch.tools import complete_depth, create_infos, generate_pseudo_boxes

from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LABEL_TOL = 1e-4
DEPTH_TOL = 1e-4
CROP = ["--height", "64", "--width", "128"]
FLAGSHIP_CFG = REPO / "tools" / "cfgs" / "kitti_models" / "centerpoint_nuscenes2kitti.yaml"


def jax_cli(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_cli(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    jax_cli(name).main()


class JaxTriples:
    """Stands in for ops.sample_ground_triples: the triples the JAX factory
    draws for each of its frames, from PRNGKey(seed) split once per frame."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, valid, iters=128, generator=None):
        self.key, sub = jax.random.split(self.key)
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e9)
        tri = jnp.stack([jax.random.categorical(k, logits, shape=(iters,))
                         for k in jax.random.split(sub, 3)], axis=-1)
        return torch.from_numpy(np.array(tri, np.int64))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("pseudo_cli")
    tsynth.make_dataset(base / "port", n_train=2, n_val=0)
    shutil.copytree(base / "port", base / "jax")
    return base / "jax", base / "port"


def parsed_labels(path):
    rows = [line.split() for line in path.read_text().splitlines() if line.strip()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows])


@pytest.fixture(scope="module")
def generated(roots):
    jax_root, port_root = roots
    mp = pytest.MonkeyPatch()
    try:
        run_jax_cli(mp, "generate_pseudo_boxes", ["--detpath", str(jax_root)])
        mp.setattr(tops, "sample_ground_triples", JaxTriples(0))
        out = generate_pseudo_boxes.main(["--detpath", str(port_root), "--device", "cpu"])
    finally:
        mp.undo()
    return out


def test_generate_pseudo_boxes_matches_jax(roots, generated):
    jax_root, port_root = roots
    assert generated["frames"] == ["000000", "000001"]
    for idx in generated["frames"]:
        names_j, rows_j = parsed_labels(jax_root / "label_train" / f"{idx}.txt")
        names_t, rows_t = parsed_labels(port_root / "label_train" / f"{idx}.txt")
        assert names_t == names_j and len(names_t) == generated["boxes"][idx] > 0
        np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=LABEL_TOL)
        np.testing.assert_array_equal(
            np.load(port_root / "velodyne_depth" / f"{idx}.npy"),
            np.load(jax_root / "velodyne_depth" / f"{idx}.npy"))


def test_pseudo_labels_hand_off_to_create_infos(roots, generated):
    """Pipeline 2 → pipeline 3: the infos of the pseudo-labels hold each
    frame's boxes as the factory wrote them."""
    _, port_root = roots
    out = create_infos.main(["--cfg_file", str(FLAGSHIP_CFG), "--data_path", str(port_root),
                             "--label_dir", "label_train", "--suffix", "_initial_pseudo_box",
                             "--splits", "train"])
    (info_path,) = out["infos"]
    assert info_path.name == "kitti_infos_train_initial_pseudo_box.pkl"
    infos = np.load(info_path, allow_pickle=True)
    counts = {info["point_cloud"]["lidar_idx"]: len(info["annos"]["name"]) for info in infos}
    assert counts == generated["boxes"]
    assert out["dbinfos"] is not None


def reference_checkpoint(path):
    from test_torch_port_depth import reference_state_dict

    torch.save({"model_state": reference_state_dict(seed=3)}, path)
    return path


def fp32_enet_ref(dtype=None):
    return JENetRef(dtype=jnp.float32)


def fp32_enet(dtype=None):
    return JENet(dtype=jnp.float32)


def assert_depth_maps_close(jax_dir, port_dir, ids):
    for idx in ids:
        want = np.load(jax_dir / f"{idx}.npy")
        got = np.load(port_dir / f"{idx}.npy")
        assert got.shape == want.shape == (352, 1216) and got.dtype == np.float32
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(got == 0, want == 0)   # outside the crop
        err = np.abs(got - want).max()
        assert err <= DEPTH_TOL * np.abs(want).max(), (idx, err)


def test_complete_depth_enet_ref_matches_jax(roots, tmp_path, monkeypatch):
    import dfu3d_tpu.models.penet_ref as jref

    jax_root, port_root = roots
    ckpt = reference_checkpoint(tmp_path / "pe.pth.tar")
    monkeypatch.setattr(jref, "ENetRef", fp32_enet_ref)
    run_jax_cli(monkeypatch, "complete_depth", ["--detpath", str(jax_root), "--model", "enet_ref",
                                                "--torch_ckpt", str(ckpt), *CROP])
    out = complete_depth.main(["--detpath", str(port_root), "--model", "enet_ref",
                               "--torch_ckpt", str(ckpt), *CROP, "--out_dir",
                               str(tmp_path / "port_depth"), "--device", "cpu",
                               "--dtype", "float32"])
    assert len(out["report"]["converted"]) == len(convert.enet_mapping())
    assert_depth_maps_close(jax_root / "depth", tmp_path / "port_depth", ["000000", "000001"])


def test_complete_depth_enet_matches_jax(roots, tmp_path, monkeypatch):
    import orbax.checkpoint as ocp

    import dfu3d_tpu.models.depth_completion as jdc
    from test_torch_port_models import numpy_variables

    jax_root, port_root = roots
    jm = jdc.ENet(dtype=jnp.float32)
    rgb, sd = np.zeros((1, 64, 128, 3), np.float32), np.zeros((1, 64, 128, 1), np.float32)
    variables = jax.device_get(numpy_variables(
        lambda: jm.init(jax.random.PRNGKey(0), rgb, sd, 600.0, 180.0, 700.0, 700.0), seed=4))
    ocp.PyTreeCheckpointer().save((tmp_path / "orbax").absolute(), variables)
    port = convert.params_from_jax(variables, tdc.ENet(device="cpu"))
    torch.save(port.state_dict(), tmp_path / "enet.pth")
    monkeypatch.setattr(jdc, "ENet", fp32_enet)
    shutil.copytree(jax_root, tmp_path / "jax_root")
    run_jax_cli(monkeypatch, "complete_depth", ["--detpath", str(tmp_path / "jax_root"), "--ckpt",
                                                str(tmp_path / "orbax"), *CROP])
    complete_depth.main(["--detpath", str(port_root), "--ckpt", str(tmp_path / "enet.pth"),
                         *CROP, "--out_dir", str(tmp_path / "port_depth"), "--device", "cpu",
                         "--dtype", "float32"])
    assert_depth_maps_close(tmp_path / "jax_root" / "depth", tmp_path / "port_depth",
                            ["000000", "000001"])


def test_clis_need_a_card(roots, monkeypatch):
    _, port_root = roots
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_pseudo_boxes.main(["--detpath", str(port_root), "--end", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        complete_depth.main(["--detpath", str(port_root), "--end", "1"])
    from dfu3d_tpu_torch import profile_pseudo

    with pytest.raises(SystemExit, match="CUDA"):
        profile_pseudo.main([])


def test_complete_depth_rejects_torch_ckpt_for_enet(roots):
    _, port_root = roots
    with pytest.raises(SystemExit):
        complete_depth.main(["--detpath", str(port_root), "--torch_ckpt", "x.pth",
                             "--device", "cpu"])


def recovery(seeds=range(8)):
    """BEV recovery (IoU ≥ 0.5) of each scene's gt Cars by the JAX factory and
    by the port on the CPU with the JAX factory's triples, on the frames
    tools.generate_pseudo_boxes sees (camera-FOV LiDAR), factory defaults."""
    from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
    from dfu3d_tpu.pseudo import factory as jfactory
    from dfu3d_tpu.pseudo import synthetic as jsynth
    from dfu3d_tpu_torch.pseudo import factory as tfactory

    jf = jfactory.PseudoBoxFactory()
    tf = tfactory.PseudoBoxFactory(device="cpu")
    draw = JaxTriples(0)
    totals = {"jax": [0, 0], "port": [0, 0]}
    for seed in seeds:
        frame, gt, _ = jsynth.make_scene(seed=seed)
        pts_rect = frame.calib.lidar_to_rect(frame.lidar[:, 0:3])
        frame.lidar = frame.lidar[JKittiDataset.get_fov_flag(pts_rect, frame.depth.shape[:2],
                                                             frame.calib)]
        valid = np.zeros(tfactory.LIDAR_CAP, bool)
        valid[:min(len(frame.lidar), tfactory.LIDAR_CAP)] = True
        triples = draw(torch.from_numpy(valid))
        for name, out in (("jax", jf.process_frame(frame)),
                          ("port", tf.process_frame(frame, triples=triples))):
            cars = out.boxes_lidar[np.array(out.names) == "Car"] if out.names else out.boxes_lidar
            rec = tsynth.bev_recovery(cars, gt)
            totals[name][0] += rec["recalled"]
            totals[name][1] += rec["gt"]
            print(f"seed {seed} {name}: {rec['recalled']} of {rec['gt']} gt Cars at BEV IoU >= 0.5,"
                  f" {len(out.names)} boxes")
    for name, (got, of) in totals.items():
        print(f"{name}: {got} of {of} = {got / of:.4f}")
    return totals


if __name__ == "__main__":
    recovery()
