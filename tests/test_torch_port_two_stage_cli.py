"""Port parity for training PV-RCNN against the JAX package (one
`make_train_step`, as tests/test_torch_port_two_stage_train.py holds the
other two detectors'), and the two-stage detectors through the CLIs and
the profiles, on the CPU:

* `tools.train` and `tools.test` on voxel_rcnn_car.yaml from a synthetic
  KITTI root, with their B1 and B2 calls;
* `zoo.kitti_batches` in train mode and the two-stage span profile of
  `profile_serve` / `profile_train`.
"""
from pathlib import Path

import numpy as np
import torch

from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.tools import create_infos, test as test_cli, train as train_cli
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import make_batch
from test_torch_port_two_stage import pair, port_batch
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_two_stage_train import KITTI_OPTIM, check_train_step


def test_pv_rcnn_train_step_matches_jax(monkeypatch):
    check_train_step("pv_rcnn", monkeypatch)


def test_tools_train_and_test_voxel_rcnn(tmp_path, monkeypatch):
    """tools.train --cfg_file cfgs/kitti_models/voxel_rcnn_car.yaml, fp32 on
    the CPU, one epoch of 1 step (2 train frames, B=2) from a synthetic KITTI
    root with its gt database (gt sampling, flip, rotation, scaling), then
    tools.test on its checkpoint over 2 val frames: a finite loss, a
    checkpoint, KITTI results; B2 runs 9 + 8 times in the train step and 9
    times per test batch, B1 twice in the step (proposal NMS, RoI targets)
    and 3 times per test batch (proposal NMS, final NMS, recall IoU). Cut to
    the CPU by --set: the range to 25.6 x 25.6 m (the grid 512 x 512 x 40 at
    the published voxels), the proposal NMS to pre 512 / post 128 in
    training and pre 256 / post 32 in test; the widths stay published."""
    check_tools_train_and_test(tmp_path, monkeypatch, "voxel_rcnn_car.yaml", 9)


def check_tools_train_and_test(tmp_path, monkeypatch, cfg_name, convs, extra_set=()):
    """tools.train and tools.test of cfgs/kitti_models/`cfg_name` as
    test_tools_train_and_test_voxel_rcnn runs them, for a model of `convs`
    sparse convs (B2 2 x convs - 1 times per train step, convs times per
    test batch); `extra_set` adds --set pairs."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel

    work = tmp_path
    (work / "cfgs").symlink_to(Path(__file__).resolve().parents[1] / "tools" / "cfgs")
    root = work / "kitti"
    kitti_synthetic.write_root(root, 2, 2, ["Car", "Pedestrian", "Cyclist"], seed=3,
                               num_points=(3000, 4000), num_boxes=(4, 7), near_cars=3)
    cfg_file = f"cfgs/kitti_models/{cfg_name}"
    monkeypatch.chdir(work)
    out = create_infos.main(["--cfg_file", cfg_file, "--data_path", str(root)])
    assert Path(out["dbinfos"]).name == "kitti_dbinfos_train.pkl"
    b1, b2 = [], []
    plain_b1, plain_b2 = iou_kernel.overlap_bev, gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(iou_kernel, "overlap_bev",
                        lambda a, b: b1.append(tuple(a.shape[:2])) or plain_b1(a, b))
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm",
                        lambda *a: b2.append(1) or plain_b2(*a))
    cuts = ["DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.POINT_CLOUD_RANGE", "[0,-12.8,-3,25.6,12.8,1]",
            "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE", "512",
            "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE", "128",
            "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE", "256",
            "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE", "32", *extra_set]
    res = train_cli.main(["--cfg_file", cfg_file, "--epochs", "1", "--batch_size", "2",
                          "--workers", "1", "--device", "cpu", "--dtype", "float32",
                          "--set", *cuts])
    (epoch,) = res["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["loss"])
    ckpt = res["ckpt_dir"] / "checkpoint_epoch_1.pth"
    assert ckpt.exists()
    assert len(b2) == 2 * convs - 1 and b1 == [(2, 512), (2, 128)]
    b1.clear(), b2.clear()
    ((_, result_dir, result),) = test_cli.main(
        ["--cfg_file", cfg_file, "--ckpt", str(ckpt), "--batch_size", "2", "--workers", "1",
         "--device", "cpu", "--dtype", "float32", "--set", *cuts])
    assert len(b2) == convs and len(b1) == 3 and b1[:2] == [(2, 256), (2, 32)]
    assert result["gt_num"] > 0 and (work / result_dir).is_dir()


def test_kitti_batches_and_two_stage_profiles(tmp_path, monkeypatch):
    """zoo.kitti_batches in train mode (gt sampling from the root's gt
    database) feeds the two-stage span profile of profile_serve (an eval
    step) and of profile_train (a train step with its optimizer) on the tiny
    Voxel R-CNN, its syncs stubbed: every span present, the B1 and B2 calls
    inside their spans, exclusive times summing to the step."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = zoo.voxel_rcnn(device="cpu")[0]
    kitti_synthetic.write_root(tmp_path, 2, 0, cfg.CLASS_NAMES, seed=4, num_points=(800, 1200),
                               num_boxes=(3, 5), near_cars=2)
    out = create_infos.main(["--cfg_file", str(zoo.KITTI_CFGS / "voxel_rcnn_car.yaml"),
                             "--data_path", str(tmp_path), "--splits", "train"])
    (batch,) = zoo.kitti_batches(cfg, tmp_path, out["infos"][0], 1, 2, training=True)
    assert batch.points.shape[0] == 2 and batch.gt_valid.sum(1).min() > 0
    _, _, model, _ = pair("voxel_rcnn")
    check_two_stage_spans(model, monkeypatch)


def check_two_stage_spans(model, monkeypatch, serve_keys=(), train_keys=()):
    """The two-stage span profile of an eval step and of a train step of
    `model` on a test batch, its syncs stubbed: every span of every
    two-stage model present (and those of `serve_keys` / `train_keys`),
    the B1 and B2 calls inside their spans, exclusive times summing to the
    step."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    jb = make_batch(np.random.RandomState(4), b=2, n=512)
    batches = [port_batch(jb)]
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    res = profile_serve.two_stage_profile(model, lambda b: profile_serve._run(step, b), batches)
    for key in ("vfe", "neighbour_tables", "sparse_convs", "sparse_convs.b2", "backbone_2d",
                "dense_head", "proposals", "proposals.b1", "roi_pool", "roi_head", "final_nms",
                "final_nms.b1", "recall_iou", "recall_iou.b1", "rest", *serve_keys):
        assert res["phase_ms"][key] > 0, key
    phase = res["phase_ms"]
    assert abs(sum(v for k, v in phase.items() if k != "step") - phase["step"]) < 1e-6
    model.train()
    tstate = create_train_state(model, CfgDict(KITTI_OPTIM), 10)
    tstep = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)
    res = profile_serve.two_stage_profile(model, lambda b: float(tstep(b)["loss"]), batches,
                                          tstate.optimizer)
    for key in ("anchor_targets", "rpn_loss", "proposals.b1", "roi_targets", "roi_targets.b1",
                "roi_pool", "roi_head", "rcnn_loss", "backward", "backward.b2",
                "clip_optimizer", *train_keys):
        assert res["phase_ms"][key] > 0, key
    assert "final_nms" not in res["phase_ms"]
