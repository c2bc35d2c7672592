"""Data-parallel evaluation and the CLIs over two gloo ranks on the CPU
(spawned processes joined by a FileStore, no TCP port).

The cross-rank eval merge (`train.eval_utils.merge_ranks`) is held against
the one-process `eval_one_epoch`, which
tests/test_torch_port_eval.py::test_eval_one_epoch_matches_jax holds
against JAX, on an odd-sized val split (5 frames over 2 ranks): the loader
pads the order to 6 with the first frame of the order again, as JAX's
loader does (pinned against dfu3d_tpu's DataLoader), and the merge keeps
that duplicate as JAX's merge does. Kept boxes within 1e-4 (each rank's
batches hold other frames, so the summation orders differ), AP within
AP_TOL. What JAX does with the merged annos is pinned too: its KITTI
evaluator asserts one anno per gt frame, so it fails on the duplicate; and
its merge sorts by `dataset.infos`, which its KittiDataset lacks, so it
keeps the ranks' order. The port sorts by kitti_infos and takes each frame
once for the AP (ROADMAP Queue C)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from dfu3d_tpu.data.loader import DataLoader as JDataLoader
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.loader import build_dataloader
from dfu3d_tpu_torch.flagship import seeded_weights_
from dfu3d_tpu_torch.parallel.launch import run_ranks
from dfu3d_tpu_torch.tools import create_infos
from dfu3d_tpu_torch.tools.common import build_model
from dfu3d_tpu_torch.train import checkpoint
from dfu3d_tpu_torch.train.eval_utils import eval_one_epoch, first_copies
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

import torch_port_dist_cases as cases
from test_cli import _write_cfg
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

CLASSES = ["Car", "Pedestrian"]
AP_TOL = 1e-3
CPU = ["--device", "cpu", "--dtype", "float32", "--workers", "1"]


def _eval_ready(cfg_file):
    """The config with the test-time point shuffle off (np.random's global
    state differs between processes), up to 64 boxes per frame and low
    recall thresholds."""
    cfg = yaml.safe_load(Path(cfg_file).read_text())
    for p in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if p["NAME"] == "shuffle_points":
            p["SHUFFLE_ENABLED"] = {"train": True, "test": False}
    cfg["MODEL"]["DENSE_HEAD"]["POST_PROCESSING"]["NMS_CONFIG"]["NMS_POST_MAXSIZE"] = 64
    cfg["MODEL"]["POST_PROCESSING"]["RECALL_THRESH_LIST"] = [0.01, 0.1, 0.3]
    Path(cfg_file).write_text(yaml.safe_dump(cfg))
    return cfg_file


@pytest.fixture(scope="module")
def odd_root(tmp_path_factory):
    """A synthetic root with 8 train and 5 val frames and its infos, the
    tiny pillar config on it (work/cfgs/...), and seeded weights whose
    boxes are car-sized at the cars' height."""
    work = tmp_path_factory.mktemp("dist_eval")
    root = work / "root"
    kitti_synthetic.write_root(root, 8, 5, CLASSES, seed=7, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=3)
    cfg_file = _eval_ready(_write_cfg(root, work))
    create_infos.main(["--cfg_file", str(cfg_file)])
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    torch.manual_seed(0)
    model = build_model(cfg, "test", "cpu")
    seeded_weights_(model, 3)
    with torch.no_grad():
        bias = model.dense_head.fused_heads.out.bias
        om = model.dense_head.fused_heads.out_max
        names = [n for _, n, _ in model.dense_head.fused_heads.branch_specs]
        bias[names.index("center_z") * om] = -0.9
        bias[names.index("dim") * om:names.index("dim") * om + 3] = torch.log(
            torch.tensor([4.6, 1.9, 1.7]))
    return work, cfg_file, cfg, model


def test_two_rank_eval_merge_matches_one_rank(odd_root):
    work, cfg_file, cfg, model = odd_root
    state = {k: v.numpy() for k, v in model.state_dict().items()}

    ds, loader = build_dataloader(cfg.DATA_CONFIG, CLASSES, batch_size=2, workers=1,
                                  training=False)
    _, want, want_annos = eval_one_epoch(model, ds, loader, cfg, None, device="cpu")
    ranks = run_ranks(cases.eval_rank, 2, args=(str(cfg_file), state, 1),
                      threads=cases.THREADS)

    # the loader's padded shards are JAX's: 5 frames → [0, 2, 4] and [1, 3, 0]
    jds = JKittiDataset(JCfgDict(json.loads(json.dumps(cfg.DATA_CONFIG))), CLASSES,
                        training=False)
    for r, got in enumerate(ranks):
        want_idx = JDataLoader(jds, 1, shuffle=False, drop_last=False, process_index=r,
                               process_count=2)._local_indices()
        np.testing.assert_array_equal(got["indices"], want_idx)
    ids = [a["frame_id"] for a in want_annos]
    assert len(ids) == 5
    for got in ranks:   # every rank holds the merged result
        annos, result = got["annos"], got["result"]
        assert [a["frame_id"] for a in annos] == [ids[0], ids[0], *ids[1:]]
        assert result["num_frames"] == 6
        for g, w in zip(first_copies(annos), want_annos):
            assert g["frame_id"] == w["frame_id"] and len(g["name"]) == len(w["name"]) > 0
            rows_g = np.concatenate([g["boxes_lidar"], g["score"][:, None]], 1)
            rows_w = np.concatenate([w["boxes_lidar"], w["score"][:, None]], 1)
            dist = np.abs(rows_g[:, None] - rows_w[None]).max(-1)
            match = dist.argmin(0)
            assert len(set(match.tolist())) == len(match)
            assert dist[match, np.arange(len(match))].max() <= 1e-4
        ap_keys = [k for k in want if "_R40" in k]
        assert ap_keys
        for k in ap_keys:
            assert abs(result[k] - want[k]) <= AP_TOL, (k, result[k], want[k])
        # the duplicate frame counts twice in the recall counters
        assert result["gt_num"] > want["gt_num"]
        assert all(result[f"recall_rcnn_{t}"] >= want[f"recall_rcnn_{t}"]
                   for t in (0.01, 0.1, 0.3))
    assert ranks[0]["result"]["gt_num"] == ranks[1]["result"]["gt_num"]

    # JAX's side: no `infos` on its KittiDataset (its merge keeps rank
    # order), and its evaluator fails on the merged annos with the duplicate
    assert getattr(jds, "infos", None) is None
    with pytest.raises(AssertionError):
        jds.evaluation(ranks[0]["annos"], CLASSES)


def test_clis_train_and_test_over_two_ranks(odd_root, tmp_path):
    """tools.train (--batch_size 4 global, 2 per rank, --steps_per_dispatch
    2) then tools.test --eval_all on two ranks: one global step count, rank
    0's checkpoint and record, the merged eval on both ranks."""
    work, cfg_file, _, _ = odd_root
    cfg_rel = str(Path(cfg_file).relative_to(work))
    ranks = run_ranks(cases.cli_rank, 2,
                      args=(str(work), cfg_rel, ["--batch_size", "4", *CPU],
                            ["--steps_per_dispatch", "2"]),
                      threads=cases.THREADS)
    out = work / "output" / Path(cfg_rel).parent.relative_to("cfgs") / Path(cfg_rel).stem / \
        "default"
    for got in ranks:
        (stats,) = got["epochs"]
        assert stats["steps"] == 2 and all(np.isfinite(stats["losses"]))
        ((epoch, _, result),) = got["tested"]
        assert epoch == 1 and result["num_frames"] == 6
    assert ranks[0]["epochs"][0]["losses"] == ranks[1]["epochs"][0]["losses"]
    assert ranks[0]["tested"][0][2]["gt_num"] == ranks[1]["tested"][0][2]["gt_num"]
    assert (out / "ckpt" / "checkpoint_epoch_1.pth").exists()
    assert (out / "eval" / "eval_list_val.txt").read_text().split() == ["1"]
    payload, _ = checkpoint.load_checkpoint(out / "ckpt" / "checkpoint_epoch_1.pth")
    assert payload["it"] == 2
