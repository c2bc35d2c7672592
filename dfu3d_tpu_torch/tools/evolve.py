"""Dynamic self-evolution rounds (port of the JAX package's tools/evolve.py):
an explicit round loop in place of the reference's comment-toggled INFO_PATH
lines (nuscenes2kitti_dataset_centerpoint.yaml:12-19) and SCORE_THRESH
comments. Round r:

  1. train the detector on round r's infos
     (nuscenes2kitti_infos_train_28130_<round r>_pseudo_box.pkl);
  2. predict on the train split at SCORE_THRESH (--score_thresh, 0.5),
     writing KITTI label txts, for every checkpoint of the round (--eval_all);
  3. copy the newest epoch's predictions into label_<round r+1> and rebuild
     the info pkl and gt database from them (tools.create_infos --label_dir
     label_<round r+1> --suffix _<round r+1>_pseudo_box --splits train);
  4. point round r+1 at the new infos.

    python -m dfu3d_tpu_torch.tools.evolve \\
        --cfg_file cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml --rounds 2 \\
        [--score_thresh 0.5] [--epochs N] [--device cuda|cpu] [--dtype bfloat16|float32] \\
        [--set DATA_CONFIG.DATA_PATH /data/train_28130 ...]

Run from the directory that holds cfgs/ (as the train and test CLIs are):
output goes to output/<EXP_GROUP_PATH>/<cfg name>/evolve_round<r>/. --set
overrides reach every train and test run (and DATA_PATH create_infos).

Three things differ from the JAX script, each where the JAX one picks the
wrong files: the newest epoch is taken by number (the JAX script sorts the
names, so epoch_9 comes after epoch_20); the predictions are looked up under
the output directory the CLIs write (with EXP_GROUP_PATH, which the JAX
script leaves out); and the rebuilt infos are also written under the name
the next round reads (create_infos names them kitti_infos_train<suffix>.pkl).
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

from ..device import resolve_device
from . import create_infos
from . import test as test_cli
from . import train as train_cli
from .common import DTYPES, load_config, newest_epoch_dir, output_dir

ROUND_NAMES = ["initial", "refine0", "refine1", "refine2", "refine3"]


def round_info_name(round_name: str) -> str:
    """The train info pkl a round reads (the flagship dataset config's
    naming)."""
    return f"nuscenes2kitti_infos_train_28130_{round_name}_pseudo_box.pkl"


def main(argv=None):
    """Run the rounds; returns one record per round: {"round", "tag",
    "train": the train CLI's result, "predictions": [(epoch, result_dir,
    result)] of the predict pass, "label_dir", "prediction_dir", "infos",
    "seconds": the host-clock split}."""
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch self-evolution rounds")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--start_round", type=int, default=0)
    parser.add_argument("--score_thresh", type=float, default=0.5,
                        help="pseudo-box emission threshold (reference comment "
                             "'obtain pseudo boxes', centerpoint yaml:83)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the card unless 'cpu' is asked for")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="config overrides passed on to every train and test run")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    cfg = load_config(args)
    data_root = Path(cfg.DATA_CONFIG.DATA_PATH)
    device = ["--device", args.device, "--dtype", args.dtype]
    extra = list(args.set_cfgs or [])

    records = []
    for r in range(args.start_round, args.start_round + args.rounds):
        cur_name, next_name = ROUND_NAMES[r], ROUND_NAMES[r + 1]
        tag = f"evolve_round{r}"
        info_name = round_info_name(cur_name)
        if not (data_root / info_name).exists():
            raise FileNotFoundError(f"round {r} ({cur_name}) reads {data_root / info_name}, "
                                    "which does not exist")
        seconds = {}

        # 1. train on this round's infos
        t0 = time.perf_counter()
        train_argv = ["--cfg_file", args.cfg_file, "--extra_tag", tag, *device]
        if args.epochs:
            train_argv += ["--epochs", str(args.epochs)]
        trained = train_cli.main([*train_argv, "--set", "DATA_CONFIG.INFO_PATH.train",
                                  f"['{info_name}']", "DATA_CONFIG.PSEUDO_LABEL_ROUND",
                                  cur_name, *extra])
        seconds["train"] = time.perf_counter() - t0

        # 2. predict on the train split at the emission threshold
        t0 = time.perf_counter()
        predictions = test_cli.main([
            "--cfg_file", args.cfg_file, "--extra_tag", tag, "--eval_all",
            "--max_waiting_mins", "0", "--save_to_file", *device, "--set",
            "MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH", str(args.score_thresh),
            "DATA_CONFIG.DATA_SPLIT.test", "train",
            "DATA_CONFIG.INFO_PATH.test", f"['{info_name}']", *extra])
        seconds["predict"] = time.perf_counter() - t0

        # 3. the newest epoch's predictions become the next round's labels
        t0 = time.perf_counter()
        src = newest_epoch_dir(output_dir(cfg, tag) / "eval", "train/final_result/data")
        refined_label_dir = f"label_{next_name}"
        dst = data_root / refined_label_dir
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
        seconds["labels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        infos = create_infos.main(["--cfg_file", args.cfg_file, "--data_path", str(data_root),
                                   "--label_dir", refined_label_dir,
                                   "--suffix", f"_{next_name}_pseudo_box", "--splits", "train"])
        (train_info,) = infos["infos"]
        shutil.copyfile(train_info, data_root / round_info_name(next_name))
        seconds["rebuild"] = time.perf_counter() - t0
        print(f"round {r} complete → {next_name} infos ready", flush=True)
        records.append({"round": r, "tag": tag, "train": trained, "predictions": predictions,
                        "prediction_dir": src, "label_dir": dst, "infos": infos,
                        "next_info": data_root / round_info_name(next_name),
                        "seconds": seconds})
    return records


if __name__ == "__main__":
    main()
