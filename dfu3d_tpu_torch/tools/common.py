"""What the CLIs share: the config from --cfg_file and --set, the output
directory, the device and dtype, the model built from the config, and the
newest epoch's evaluation directory."""
from __future__ import annotations

import argparse
import re
from pathlib import Path

import torch

from ..core.voxel import VoxelGrid
from ..models import build_network
from ..utils.config import CfgDict, cfg_from_list, cfg_from_yaml_file

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="batch size (default: OPTIMIZATION.BATCH_SIZE_PER_GPU)")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")


def load_config(args):
    """The config of --cfg_file with TAG (the file's stem) and EXP_GROUP_PATH
    (its directories after the first), then the --set overrides."""
    cfg = cfg_from_yaml_file(args.cfg_file, CfgDict())
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(str(Path(args.cfg_file)).split("/")[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return cfg


def output_dir(cfg, extra_tag) -> Path:
    return Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / extra_tag


def build_model(cfg, mode: str, device, train: bool = False):
    """The detector of cfg.MODEL on the grid of POINT_CLOUD_RANGE and the last
    voxel processor's VOXEL_SIZE, with its voxel cap from
    MAX_NUMBER_OF_VOXELS[mode] where the config sets one (reference
    transform_points_to_voxels, data_processor.py:133)."""
    voxel_cfg = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p.NAME.startswith("transform_points_to_voxels")][-1]
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, voxel_cfg.VOXEL_SIZE)
    overrides = {}
    mv = voxel_cfg.get("MAX_NUMBER_OF_VOXELS", None)
    if mv:
        overrides["max_voxels"] = int(mv[mode] if hasattr(mv, "get") else mv)
    return build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=train,
                         **overrides)


def newest_epoch_dir(eval_dir: Path, rel: str) -> Path:
    """eval_dir/epoch_<N>/<rel> of the highest epoch number N (by number:
    epoch_12 is newer than epoch_9)."""
    found = [(int(m.group(1)), p / rel) for p in Path(eval_dir).glob("epoch_*")
             if (m := re.fullmatch(r"epoch_(-?\d+)", p.name)) and (p / rel).is_dir()]
    if not found:
        raise FileNotFoundError(f"no epoch_*/{rel} under {eval_dir}")
    return max(found)[1]
