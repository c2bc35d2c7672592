"""Training CLI (port of the JAX package's tools/train.py, itself the
reference's tools/train.py:21-65 flag surface).

    python -m dfu3d_tpu_torch.tools.train \\
        --cfg_file tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml \\
        [--epochs N] [--workers 4] [--device cuda|cpu] [--dtype bfloat16|float32] \\
        [--steps_per_dispatch K] [--set DATA_CONFIG.DATA_PATH /data/kitti ...]

On N cards, one process per card: `torchrun --nproc_per_node N -m
dfu3d_tpu_torch.tools.train ...` or one SLURM task per card
(tools/scripts/slurm_train_gpu.sh); the ranks join over NCCL
(`parallel.init_distributed`, gloo with --device cpu) and train on one
global batch (--batch_size, default BATCH_SIZE_PER_GPU × N) as the JAX
package's sharded step does. A model whose modules are not all audited for
the global batch raises at more than one rank.

The config may name CenterPoint or PointRCNN
(tools/cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml).
Output goes to output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/ under the working
directory: the log, and ckpt/ with the per-epoch checkpoints; a run resumes
from the newest checkpoint there unless --ckpt names one. --ckpt and
--pretrained_model also take a reference (OpenPCDet / DFU3D) checkpoint of
the flagship or of PointRCNN (its point and RoI heads; the backbone is
reported unconverted): its weights are overlaid onto the model and training
starts at epoch 0 with a fresh optimizer.
--num_epochs_to_eval > 0 evaluates the trained model on the test split
afterwards. Scalars go to the log (no TensorBoard). --steps_per_dispatch K
runs K updates per call of the step (the same weights as K single steps);
logging and the latest_model save round to K updates.
"""
from __future__ import annotations

import argparse
import datetime

from ..data.loader import build_dataloader
from ..device import resolve_device
from ..parallel import destroy_distributed, init_distributed, mesh
from ..train.checkpoint import load_checkpoint, load_latest, load_model_state
from ..train.eval_utils import eval_one_epoch
from ..train.train_state import create_train_state
from ..train.trainer import train_model
from ..utils.common import close_logger, create_logger, set_random_seed
from ..utils.config import log_config_to_file
from .common import DTYPES, add_common_args, build_model, load_config, output_dir, rank_batch_size


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="dfu3d_tpu_torch training")
    add_common_args(parser)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="a checkpoint (the port's or a reference one) whose model "
                             "weights initialise the model")
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true")
    parser.add_argument("--num_epochs_to_eval", type=int, default=0)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="train steps per call of the step; logging and the "
                             "latest_model save round to this many updates")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, load_config(args)


def main(argv=None):
    """Train; returns {"output_dir", "ckpt_dir", "start_epoch", "epochs": [the
    per-epoch stats of train_model], "eval": the eval result dict or None}."""
    args, cfg = parse_config(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    own_group = not mesh.is_distributed()
    rank, world = init_distributed(args.device)
    batch_size, local_batch = rank_batch_size(args, cfg, world)
    epochs = args.epochs if args.epochs is not None else cfg.OPTIMIZATION.NUM_EPOCHS

    out_dir = output_dir(cfg, args.extra_tag)
    ckpt_dir = out_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / ("log_train_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = create_logger(log_file, rank=rank)
    try:
        logger.info("**********************Start logging**********************")
        logger.info(f"device: {device}, dtype: {args.dtype}, ranks: {world}, "
                    f"global batch size: {batch_size}")
        log_config_to_file(cfg, logger=logger)
        if args.fix_random_seed:
            set_random_seed(666 + rank)

        _, train_loader = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=local_batch,
            workers=args.workers, logger=logger, training=True,
            merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
            total_epochs=epochs, process_index=rank, process_count=world)
        model = build_model(cfg, "train", device, train=True)
        if args.pretrained_model is not None:
            load_model_state(args.pretrained_model, model, logger)
            logger.info(f"initialised from {args.pretrained_model}")
        state = create_train_state(model, cfg.OPTIMIZATION, len(train_loader) * epochs)

        start_epoch = 0
        if args.ckpt is not None:
            state, start_epoch = load_checkpoint(args.ckpt, state, logger)
            logger.info(f"resumed from {args.ckpt} (epoch {start_epoch})")
        else:
            restored, epoch = load_latest(ckpt_dir, state)
            if restored is not None:
                start_epoch = epoch
                logger.info(f"auto-resumed from epoch {epoch}")
        mesh.broadcast_state_(model)   # every rank starts from rank 0's weights

        logger.info("**********************Start training**********************")
        epoch_stats = []
        train_model(state, train_loader, epochs, ckpt_dir, device=device, dtype=dtype,
                    start_epoch=start_epoch, ckpt_save_interval=args.ckpt_save_interval,
                    max_ckpt_save_num=args.max_ckpt_save_num, logger=logger, cfg=cfg,
                    merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
                    on_epoch=epoch_stats.append, steps_per_dispatch=args.steps_per_dispatch)
        logger.info("**********************Training done**********************")

        result = None
        if args.num_epochs_to_eval > 0:
            test_dataset, test_loader = build_dataloader(
                dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                batch_size=local_batch, workers=args.workers, logger=logger, training=False,
                process_index=rank, process_count=world)
            eval_dir = out_dir / "eval" / "eval_with_train"
            eval_dir.mkdir(parents=True, exist_ok=True)
            _, result, _ = eval_one_epoch(model, test_dataset, test_loader, cfg, logger,
                                          result_dir=eval_dir, device=device, dtype=dtype)
        return {"output_dir": out_dir, "ckpt_dir": ckpt_dir, "start_epoch": start_epoch,
                "epochs": epoch_stats, "eval": result}
    finally:
        close_logger(logger)
        if own_group:
            destroy_distributed()


if __name__ == "__main__":
    main()
