"""Info pkls and gt database of a KITTI-format root (port of the JAX
package's tools/create_infos.py; reference: `python -m
pcdet.datasets.kitti.kitti_dataset create_kitti_infos ...`,
kitti_dataset.py:525-539).

    python -m dfu3d_tpu_torch.tools.create_infos \\
        --cfg_file tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml \\
        [--data_path DIR] [--label_dir label_train] [--suffix _initial_pseudo_box] \\
        [--splits train val] [--no_gt_database]

Writes kitti_infos_<split><suffix>.pkl per split and, with a train split,
gt_database<suffix>/ and kitti_dbinfos_train<suffix>.pkl into the data path.
Runs on the host only.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..data.kitti_dataset import KittiDataset, create_kitti_infos
from ..utils.common import create_logger
from ..utils.config import CfgDict, cfg_from_yaml_file


def main(argv=None):
    """Returns {"infos": [info pkl per split], "dbinfos": pkl or None}."""
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch info and gt database")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--label_dir", type=str, default=None)
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--splits", type=str, nargs="+", default=["train", "val"])
    parser.add_argument("--no_gt_database", action="store_true")
    args = parser.parse_args(argv)

    logger = create_logger()
    cfg = cfg_from_yaml_file(args.cfg_file, CfgDict())
    ds_cfg = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
    if args.label_dir:
        ds_cfg.LABEL_DIR = args.label_dir
    data_path = Path(args.data_path or ds_cfg.DATA_PATH)
    class_names = cfg.get("CLASS_NAMES", None) or []

    paths = create_kitti_infos(ds_cfg, class_names, data_path, data_path,
                               splits=tuple(args.splits), suffix=args.suffix, logger=logger)
    dbinfos = None
    if not args.no_gt_database and "train" in args.splits:
        ds = KittiDataset(ds_cfg, class_names, training=False, root_path=data_path,
                          logger=logger)
        ds.set_split("train")
        train_info = paths[list(args.splits).index("train")]
        dbinfos = ds.create_groundtruth_database(
            train_info, data_path, used_classes=cfg.get("CLASS_NAMES", None),
            split="train", suffix=args.suffix)
        logger.info("gt database created")
    return {"infos": paths, "dbinfos": dbinfos}


if __name__ == "__main__":
    main()
