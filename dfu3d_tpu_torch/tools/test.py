"""Evaluation CLI (port of the JAX package's tools/test.py, itself the
reference's tools/test.py:22-56 flag surface), including the checkpoint-dir
polling mode (repeat_eval_ckpt, test.py:89-135).

    python -m dfu3d_tpu_torch.tools.test --cfg_file CFG --ckpt CKPT [--save_to_file]
    python -m dfu3d_tpu_torch.tools.test --cfg_file CFG --eval_all [--max_waiting_mins 30]

Results go to output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/eval/ under the
working directory: epoch_<N>/<split>[/<eval_tag>]/, with one KITTI txt per
frame in final_result/data/ under --save_to_file; --eval_all records each
evaluated epoch in eval_list_<split>.txt and skips those already there.
--ckpt also takes a reference (OpenPCDet / DFU3D) checkpoint of the flagship,
evaluated as epoch 0.
"""
from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

from ..data.loader import build_dataloader
from ..device import resolve_device
from ..train.checkpoint import list_checkpoints, load_model_state
from ..train.eval_utils import eval_one_epoch
from ..utils.common import close_logger, create_logger
from .common import DTYPES, add_common_args, build_model, load_config, output_dir


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch evaluation")
    add_common_args(parser)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_tag", type=str, default="default")
    parser.add_argument("--eval_all", action="store_true",
                        help="poll ckpt_dir and evaluate every checkpoint")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, load_config(args)


def main(argv=None):
    """Evaluate; returns [(epoch, result_dir, result_dict)] in the order
    evaluated."""
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if not args.eval_all and args.ckpt is None:
        raise ValueError("--ckpt is required (or use --eval_all)")
    split = cfg.DATA_CONFIG.DATA_SPLIT["test"]
    out_dir = output_dir(cfg, args.extra_tag)
    eval_output_dir = out_dir / "eval"
    eval_output_dir.mkdir(parents=True, exist_ok=True)
    log_file = eval_output_dir / (
        "log_eval_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = create_logger(log_file)
    try:
        dataset, loader = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
            batch_size=args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU,
            workers=args.workers, logger=logger, training=False)
        model = build_model(cfg, "test", device)

        def evaluate(path, *tag):
            epoch, _ = load_model_state(path, model, logger)
            result_dir = eval_output_dir / f"epoch_{epoch}" / split / Path(*tag)
            result_dir.mkdir(parents=True, exist_ok=True)
            logger.info(f"*************** evaluating epoch {epoch} ({path}) ***************")
            _, result, _ = eval_one_epoch(model, dataset, loader, cfg, logger,
                                          result_dir=result_dir,
                                          save_to_file=args.save_to_file, device=device,
                                          dtype=dtype)
            return epoch, result_dir, result

        if not args.eval_all:
            return [evaluate(args.ckpt, args.eval_tag)]

        ckpt_dir = Path(args.ckpt_dir or (out_dir / "ckpt"))
        record_file = eval_output_dir / f"eval_list_{split}.txt"
        done, evaluated = [], set()
        if record_file.exists():
            evaluated = {int(x) for x in record_file.read_text().split() if x}
        wait_start = time.time()
        while True:
            todo = [(e, p) for e, p in list_checkpoints(ckpt_dir)
                    if e not in evaluated and e >= args.start_epoch]
            if not todo:
                if (time.time() - wait_start) / 60 > args.max_waiting_mins:
                    break
                time.sleep(30)
                continue
            wait_start = time.time()
            for epoch, path in todo:
                done.append(evaluate(path))
                evaluated.add(epoch)
                with open(record_file, "a") as f:
                    f.write(f"{epoch}\n")
        return done
    finally:
        close_logger(logger)


if __name__ == "__main__":
    main()
