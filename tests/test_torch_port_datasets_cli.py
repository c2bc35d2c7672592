"""The port's CLIs on the other datasets from disk, on the CPU: tools.train
for one step and tools.test of its checkpoint, in-process through
`main(argv)`, on narrowed copies of waymo_models/centerpoint.yaml and
once_models/centerpoint.yaml (a 19.2 m range, a thin 2D backbone and head)
over tiny synthetic roots in Waymo's extracted layout (the shipped
SAMPLED_INTERVAL, train 5) and ONCE's raw layout (its infos and gt database
made by `create_once_infos` and `create_groundtruth_database`, the shipped
gt sampling on)."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

from dfu3d_tpu_torch.data import lidar_synthetic
from dfu3d_tpu_torch.data.once_dataset import ONCEDataset, create_once_infos
from dfu3d_tpu_torch.tools import test as test_cli, train as train_cli
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
RANGE = [-9.6, -9.6, -2.0, 9.6, 9.6, 4.0]
CPU = ["--device", "cpu", "--dtype", "float32", "--workers", "2"]

NARROW = """_BASE_CONFIG_: {base}

DATA_CONFIG:{extra}
    DATA_PATH: {root}
    POINT_CLOUD_RANGE: {range}
    MAX_POINTS_PER_FRAME: 4096
    MAX_GT_PER_FRAME: 32
    DATA_PROCESSOR:
        - NAME: mask_points_and_boxes_outside_range
          REMOVE_OUTSIDE_BOXES: True
        - NAME: shuffle_points
          SHUFFLE_ENABLED: {{'train': True, 'test': True}}
        - NAME: transform_points_to_voxels
          VOXEL_SIZE: [0.1, 0.1, 0.15]
          MAX_POINTS_PER_VOXEL: 5
          MAX_NUMBER_OF_VOXELS: {{'train': 3000, 'test': 3000}}

MODEL:
    BACKBONE_2D:
        LAYER_NUMS: [1, 1]
        NUM_FILTERS: [16, 32]
        NUM_UPSAMPLE_FILTERS: [16, 16]
    DENSE_HEAD:
        SHARED_CONV_CHANNEL: 16
        POST_PROCESSING:
            POST_CENTER_LIMIT_RANGE: {range}
            MAX_OBJ_PER_SAMPLE: 50
            NMS_CONFIG:
                NMS_PRE_MAXSIZE: 256
                NMS_POST_MAXSIZE: 50

OPTIMIZATION:
    BATCH_SIZE_PER_GPU: 2
"""


def write_root(name, work):
    """The dataset's root under work/data/<name>: 10 + 2 Waymo frames (2
    train frames at SAMPLED_INTERVAL 5), or 2 + 2 ONCE frames with their
    infos and gt database; 3,000 points each. Returns (root, config extra
    lines)."""
    root = work / "data" / name
    if name == "waymo":
        lidar_synthetic.write_waymo_root(root, [10], [2], RANGE, num_points=3000,
                                         num_boxes=(6, 10), seed=5)
        return root, ""
    lidar_synthetic.write_once_root(root, 2, 2, RANGE, num_points=3000, num_boxes=(8, 12),
                                    seed=6)
    cfg = cfg_from_yaml_file(REPO / "tools/cfgs/once_models/centerpoint.yaml", CfgDict())
    create_once_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    ONCEDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root) \
        .create_groundtruth_database(root / "once_infos_train.pkl",
                                     used_classes=cfg.CLASS_NAMES)
    # the test mode reads INFO_PATH['test'] (ROADMAP Queue C): the val infos
    return root, ("\n    INFO_PATH: {'train': [once_infos_train.pkl], "
                  "'test': [once_infos_val.pkl]}")


@pytest.fixture(scope="module", params=["waymo", "once"])
def cli_run(request, tmp_path_factory):
    """tools.train --epochs 1 then tools.test --ckpt, run in a fresh working
    directory holding the narrowed config as cfgs/<name>_models/
    centerpoint.yaml: one step of B=2, then the 2 val frames."""
    name = request.param
    work = tmp_path_factory.mktemp(f"{name}_cli")
    root, extra = write_root(name, work)
    cfg_file = Path(f"cfgs/{name}_models/centerpoint.yaml")
    (work / cfg_file).parent.mkdir(parents=True)
    (work / cfg_file).write_text(NARROW.format(
        base=REPO / "tools" / cfg_file, root=root, range=RANGE, extra=extra))
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        common = ["--cfg_file", str(cfg_file), *CPU]
        trained = train_cli.main(common + ["--epochs", "1"])
        ckpt = trained["ckpt_dir"] / "checkpoint_epoch_1.pth"
        tested = test_cli.main(common + ["--ckpt", str(ckpt)])
    finally:
        mp.undo()
    return name, work, trained, ckpt, tested


def test_train_one_step_from_disk(cli_run):
    name, work, trained, ckpt, _ = cli_run
    (epoch,) = trained["epochs"]
    assert epoch["steps"] == 1 and all(math.isfinite(v) for v in epoch["losses"])
    assert (work / trained["ckpt_dir"]).resolve() == \
        (work / f"output/{name}_models/centerpoint/default/ckpt").resolve()
    assert (work / ckpt).exists()
    assert len(list((work / trained["output_dir"]).glob("log_train_*.txt"))) == 1


def test_test_of_the_checkpoint(cli_run):
    """tools.test reads the val split (2 frames) and logs the dataset's AP in
    an AP_DICT line: the KITTI protocol over WAYMO_TO_KITTI's names, or
    `once_eval`'s superclasses and distance tiers."""
    name, work, trained, _, tested = cli_run
    ((epoch, result_dir, result),) = tested
    assert epoch == 1 and result["num_frames"] == 2 and result["eval_batches"] == 1
    assert (work / result_dir).is_dir() and result_dir.parts[-3:] == ("epoch_1", "val", "default")
    if name == "waymo":
        key = "Car_3d/moderate_R40"
        assert {k.split("_")[0] for k in result if "_3d/" in k} == {"Car", "Pedestrian",
                                                                    "Bicycle"}
    else:
        key = "AP_mean/overall"
        assert {k for k in result if k.startswith("AP_")} == {
            f"AP_{c}/{t}" for c in ("Vehicle", "Pedestrian", "Cyclist", "mean")
            for t in ("overall", "0-30m", "30-50m", "50m-inf")}
    assert result["gt_num"] > 0 and np.isfinite(result[key])
    (log,) = (work / trained["output_dir"] / "eval").glob("log_eval_*.txt")
    line = next(x for x in log.read_text().splitlines() if "AP_DICT " in x)
    assert json.loads(line.split("AP_DICT ", 1)[1])[key] == pytest.approx(float(result[key]))
