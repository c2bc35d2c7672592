"""The port's CLIs on the CPU: create_infos → train → test, in-process
through `main(argv)`, on the tiny pillar config of tests/test_cli.py and a
synthetic KITTI root; auto-resume; the latest_model epoch; and the rule
that without `--device cpu` they need a card."""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.kitti_dataset import KittiDataset
from dfu3d_tpu_torch.tools import create_infos, test as test_cli, train as train_cli
from dfu3d_tpu_torch.tools.common import build_model
from dfu3d_tpu_torch.train import checkpoint
from dfu3d_tpu_torch.train.train_state import create_train_state
from dfu3d_tpu_torch.train.trainer import train_model
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_cli import _write_cfg
from test_e2e import _dataset_cfg

CLASSES = ["Car", "Pedestrian"]
CPU = ["--device", "cpu", "--dtype", "float32", "--workers", "2"]


def tiny_cfg(root):
    """The tiny pillar config of tests/test_cli.py on `root`, as the port
    reads it."""
    with tempfile.TemporaryDirectory() as d:
        return cfg_from_yaml_file(_write_cfg(root, Path(d)), CfgDict())


def tiny_state(root, seed=0):
    """A fresh TrainState of the tiny config's model on the CPU and the train
    split of `root` (which must hold its infos) in batches of 2, with the
    test config's augmentations."""
    torch.manual_seed(seed)
    cfg = tiny_cfg(root)
    model = build_model(cfg, "train", "cpu", train=True)
    ds = KittiDataset(CfgDict(_dataset_cfg(root)), CLASSES, training=True, root_path=root)
    np.random.seed(seed)
    frames = [ds[i] for i in range(6)]
    batches = [ds.collate_batch(frames[i:i + 2])[0] for i in range(0, 6, 2)]
    return create_train_state(model, cfg.OPTIMIZATION, 20), batches


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """create_infos → train --epochs 1 → test --eval_all, run in a fresh
    working directory holding the config as cfgs/smoke/centerpoint_smoke.yaml."""
    work = tmp_path_factory.mktemp("cli_work")
    root = work / "root"
    kitti_synthetic.write_root(root, 8, 4, CLASSES, seed=1, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    cfg_file = _write_cfg(root, work).relative_to(work)
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        infos = create_infos.main(["--cfg_file", str(cfg_file)])
        trained = train_cli.main(["--cfg_file", str(cfg_file), "--epochs", "1", *CPU])
        tested = test_cli.main(["--cfg_file", str(cfg_file), "--eval_all",
                                "--max_waiting_mins", "0", "--save_to_file", *CPU])
    finally:
        mp.undo()
    return work, root, cfg_file, infos, trained, tested


def test_create_infos_writes_infos_and_database(cli_run):
    _, root, _, infos, _, _ = cli_run
    assert [p.name for p in infos["infos"]] == ["kitti_infos_train.pkl", "kitti_infos_val.pkl"]
    assert infos["dbinfos"] == root / "kitti_dbinfos_train.pkl"
    assert len(list((root / "gt_database").glob("*.bin"))) > 20


def test_train_writes_a_checkpoint(cli_run):
    work, _, _, _, trained, _ = cli_run
    out = work / "output" / "smoke" / "centerpoint_smoke" / "default"
    assert trained["output_dir"] == Path("output/smoke/centerpoint_smoke/default")
    assert (out / "ckpt" / "checkpoint_epoch_1.pth").exists()
    (stats,) = trained["epochs"]
    assert stats["steps"] == 4 and all(np.isfinite(stats["losses"]))
    assert stats["batch_time"] >= stats["data_time"] >= 0
    assert any("data_time=" in line for line in
               next(out.glob("log_train_*.txt")).read_text().splitlines())


def test_eval_all_writes_predictions_and_ap(cli_run):
    work, _, _, _, _, tested = cli_run
    ((epoch, result_dir, result),) = tested
    assert epoch == 1 and result["num_frames"] == 4 and result["eval_batches"] == 2
    assert len(list((work / result_dir / "final_result" / "data").glob("*.txt"))) == 4
    eval_dir = work / "output" / "smoke" / "centerpoint_smoke" / "default" / "eval"
    assert (eval_dir / "eval_list_val.txt").read_text().split() == ["1"]
    log = next(eval_dir.glob("log_eval_*.txt")).read_text()
    ap = json.loads(log.split("AP_DICT ", 1)[1].splitlines()[0])
    assert {f"{c}_3d/moderate_R40" for c in CLASSES} <= set(ap)
    assert result["gt_num"] > 0 and 0 <= result["recall/rcnn_0.3"] <= 1
    # a second --eval_all finds the epoch recorded and evaluates nothing
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        assert test_cli.main(["--cfg_file", str(cli_run[2]), "--eval_all",
                              "--max_waiting_mins", "0", *CPU]) == []
        (again,) = test_cli.main(["--cfg_file", str(cli_run[2]), "--ckpt",
                                  "output/smoke/centerpoint_smoke/default/ckpt/"
                                  "checkpoint_epoch_1.pth", "--eval_tag", "again", *CPU])
    finally:
        mp.undo()
    assert again[1] == eval_dir.relative_to(work) / "epoch_1" / "val" / "again"
    assert again[2]["gt_num"] == result["gt_num"]


def test_train_auto_resumes_from_the_newest_checkpoint(cli_run):
    work, _, cfg_file, _, _, _ = cli_run
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        resumed = train_cli.main(["--cfg_file", str(cfg_file), "--epochs", "2", *CPU])
    finally:
        mp.undo()
    assert resumed["start_epoch"] == 1 and [s["epoch"] for s in resumed["epochs"]] == [1]
    payload, epoch = checkpoint.load_checkpoint(work / resumed["ckpt_dir"]
                                                / "checkpoint_epoch_2.pth")
    assert epoch == 2 and payload["it"] == 8


@pytest.mark.parametrize("cli", [train_cli, test_cli], ids=["train", "test"])
def test_clis_need_a_card_unless_asked_for_the_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg_file = _write_cfg(tmp_path / "root", tmp_path).relative_to(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--cfg_file", str(cfg_file), "--ckpt", "unused.pth"])
    assert not (tmp_path / "output").exists()


def test_latest_model_records_epoch_minus_one(cli_run, tmp_path):
    """The time-based save records epoch -1, as the JAX package's does
    (dfu3d_tpu/train/trainer.py), whatever epoch it falls in."""
    _, root, _, _, _, _ = cli_run
    state, batches = tiny_state(root)
    train_model(state, batches, 2, tmp_path, device="cpu", dtype=torch.float32, start_epoch=1,
                ckpt_save_time_interval=0)
    payload, epoch = checkpoint.load_checkpoint(tmp_path / "latest_model.pth")
    assert epoch == -1 and payload["it"] == len(batches)
    assert [e for e, _ in checkpoint.list_checkpoints(tmp_path)] == [2]
