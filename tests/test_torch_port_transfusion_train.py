"""Port parity: one TransFusion-L train step against the JAX package's
`make_train_step`, and TransFusion through the CLIs and the profiles, on
the CPU, fp32:

* the train step on the shipped config's trunk (VoxelResBackBone8x with
  four CHANNELS, JAX's own modules assembled as in
  tests/test_torch_port_transfusion.py), 10 classes with the vel branch,
  the Hungarian matcher, transfusion_lidar.yaml's adam_onecycle: the loss
  and its terms within 1e-5 relative, every gradient leaf within 1e-4 of its
  largest entry (of 1e-4 of the whole gradient's where that is larger; a
  bias whose gradient is 0 in exact arithmetic, of its weight's), the
  BN statistics, B2 (through its twin) 21 times forward and 20 for dX, the
  regression branches' gradients nonzero;
* `tools.train` for 2 steps and `tools.test` of its checkpoint on a tiny
  synthetic nuScenes root, from a narrowed copy of transfusion_lidar.yaml
  (its range and voxel caps cut, the widths published);
* the TransFusion span profile of `profile_serve` / `profile_train`.
"""
import re
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_transfusion import (MAX_VOXELS, NUSC, PCR, VOXEL, ResTrunkTransFusion,
                                         jax_batch, model_pair, tf_batch, tf_cfg)
from test_torch_port_voxelnext_train import compare_train_step

REPO = Path(__file__).resolve().parents[1]
TF_CFG = REPO / "tools/cfgs/nuscenes_models/transfusion_lidar.yaml"
# biases whose gradient is 0 in exact arithmetic, held to their weight's
# largest entry: the position embeddings' first Linear feeds a train-mode
# BN, a shift of the keys leaves the softmax as it is, and norm3's output
# reaches the loss only through the branches' first Linear and train-mode BN
ZERO_BIASES = re.compile(r"dense_head\.((self|cross)_posembed\.dense_0|(self|cross)_attn\.key"
                         r"|norm3)\.bias$")


def test_train_step_matches_jax(monkeypatch):
    cfg = tf_cfg(vel=True, proposals=32, res_trunk=True)
    jmodel = ResTrunkTransFusion(JCfgDict(cfg), NUSC, JVoxelGrid.create(PCR, VOXEL),
                                 max_voxels=MAX_VOXELS)
    variables, model = model_pair(cfg, NUSC, seed=7, train=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    calls = []
    fn = gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm",
                        lambda *a: calls.append(tuple(a[3].shape)) or fn(*a))
    optim = cfg_from_yaml_file(TF_CFG, CfgDict()).OPTIMIZATION
    metrics, raw = compare_train_step(jmodel, variables, model,
                                      jax_batch(tf_batch(9, NUSC, vel=True)), optim,
                                      zero_biases=ZERO_BIASES)
    assert set(metrics) == {"loss", "tf_cls_loss", "tf_reg_loss", "tf_hm_loss", "grad_norm"}
    assert len(calls) == 21 + 20
    assert calls[21:] == [(k, co, ci) for k, ci, co in reversed(calls[1:21])]
    for branch in ("center", "height", "dim", "rot", "vel", "heatmap"):
        assert raw[f"dense_head.{branch}_out.weight"].abs().max() > 0, branch


def narrowed_config(work: Path) -> Path:
    """transfusion_lidar.yaml with its range cut to 28.8 m square (a 384 x
    384 x 40 grid at the published voxels, a 48 x 48 BEV) and its voxel
    caps to 6,000 / 8,000, written under `work`; everything else as
    shipped."""
    cfg = yaml.safe_load(TF_CFG.read_text())
    data = cfg["DATA_CONFIG"]
    data["POINT_CLOUD_RANGE"] = [-14.4, -14.4, -5.0, 14.4, 14.4, 3.0]
    (vox,) = [p for p in data["DATA_PROCESSOR"] if p["NAME"] == "transform_points_to_voxels"]
    vox["MAX_NUMBER_OF_VOXELS"] = {"train": 6000, "test": 8000}
    path = work / "cfgs" / "nuscenes_models" / "transfusion_narrow.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_tools_train_and_test_transfusion(tmp_path, monkeypatch):
    """tools.train, 1 epoch of 2 steps at B=2 (4 train frames; gt sampling
    disabled, as no nuScenes gt database exists, and the class-balanced
    resampling, which makes the epoch 20 steps), then tools.test of its
    checkpoint over 2 val frames: a finite loss, a checkpoint, results for
    each frame; B2 21 + 20 times per train step and 21 times per test
    batch, B1 never in training and once per test batch (the recall)."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel
    from dfu3d_tpu_torch.data import nuscenes_synthetic
    from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli

    root = tmp_path / "nuscenes"
    written = nuscenes_synthetic.write_root(root, n_train=4, n_val=2, frames_per_scene=2,
                                            points_per_sweep=1500, seed=5)
    nuscenes_synthetic.write_infos(root, written)
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "dataset_configs").symlink_to(REPO / "tools/cfgs/dataset_configs")
    cfg_file = str(narrowed_config(tmp_path).relative_to(tmp_path))
    monkeypatch.chdir(tmp_path)
    b1, b2 = [], []
    plain_b1, plain_b2 = iou_kernel.overlap_bev, gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(iou_kernel, "overlap_bev", lambda a, b: b1.append(1) or plain_b1(a, b))
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", lambda *a: b2.append(1) or plain_b2(*a))
    common = ["--cfg_file", cfg_file, "--batch_size", "2", "--workers", "1", "--device", "cpu",
              "--dtype", "float32", "--set", "DATA_CONFIG.DATA_PATH", str(root),
              "DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST", "gt_sampling",
              "DATA_CONFIG.BALANCED_RESAMPLING", "False"]
    res = train_cli.main(common[:-7] + ["--epochs", "1"] + common[-7:])
    (epoch,) = res["epochs"]
    assert epoch["steps"] == 2 and np.isfinite(epoch["loss"])
    ckpt = res["ckpt_dir"] / "checkpoint_epoch_1.pth"
    assert ckpt.exists()
    assert len(b2) == 41 * 2 and not b1
    b1.clear(), b2.clear()
    ((_, result_dir, result),) = test_cli.main(common[:-7] + ["--ckpt", str(ckpt)]
                                               + common[-7:])
    assert result["num_frames"] == 2 and result["eval_batches"] == 1
    assert len(b2) == 21 and len(b1) == 1
    assert result["gt_num"] > 0 and (tmp_path / result_dir).is_dir()


def test_transfusion_spans(monkeypatch):
    """The TransFusion span profile of an eval step and of a train step on
    the test model, its syncs stubbed: every span present, the B1 and B2
    calls inside their spans, exclusive times summing to the step."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.data.batch import PointBatch
    from dfu3d_tpu_torch.train.train_state import (create_train_state, make_eval_step,
                                                    make_train_step)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _, model = model_pair(tf_cfg(vel=True, proposals=32, res_trunk=True), NUSC, seed=2)
    batches = [PointBatch.from_numpy(*tf_batch(4, NUSC, vel=True))]
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    res = profile_serve.transfusion_profile(model, lambda b: profile_serve._run(step, b),
                                            batches)
    phase = res["phase_ms"]
    for key in ("voxelize", "tables", "trunk", "trunk.b2", "height_compression",
                "backbone_2d", "shared_conv_heatmap", "query_init", "self_attention",
                "cross_attention", "ffn", "branches", "decode", "recall", "recall.b1", "rest"):
        assert phase[key] > 0, key
    assert abs(sum(v for k, v in phase.items() if k != "step") - phase["step"]) < 1e-6
    model.train()
    optim = cfg_from_yaml_file(TF_CFG, CfgDict()).OPTIMIZATION
    tstate = create_train_state(model, optim, 10)
    tstep = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)
    res = profile_serve.transfusion_profile(model, lambda b: float(tstep(b)["loss"]), batches,
                                            tstate.optimizer)
    for key in ("losses.heatmap_targets", "losses.cost", "losses.hungarian", "losses",
                "backward", "backward.b2", "clip_optimizer"):
        assert res["phase_ms"][key] > 0, key
    assert res["hungarian_host_ms"] > 0 and res["hungarian_calls_per_step"] == 1
