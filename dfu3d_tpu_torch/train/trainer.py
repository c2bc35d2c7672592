"""Training loop (port of dfu3d_tpu/train/trainer.py, itself the reference's
train_utils.train_model / train_one_epoch), over a re-iterable of batches: a
list of `PointBatch` (or of `MultimodalBatch`, the camera detectors'), or a
loader (`data.loader.DataLoader`) that yields (PointBatch, BatchMeta) pairs
each time it is iterated.

Per epoch: the loader's hooks (`set_epoch`, the disable-augmentation hook for
the last epochs from cfg.HOOK), the train step over every batch, sparse
logging (every LOG_INTERVAL updates and the first, the only points where the
host waits for the card inside the epoch), a `latest_model` save when
`ckpt_save_time_interval` seconds have passed since the last one, the
epoch's losses and times read once at its end, and a per-epoch checkpoint
with rotation. `merge_all_iters_to_one_epoch` runs all epochs as one long
epoch over the repeated dataset. It logs with the standard `logging` module
(no TensorBoard). One process and one card: no mesh, no DDP.
"""
from __future__ import annotations

import logging
import time

import torch

from ..data.batch import MultimodalBatch, PointBatch
from .checkpoint import save_checkpoint
from .train_state import TrainState, make_train_step

_LOG = logging.getLogger(__name__)
LOG_INTERVAL = 20  # updates between the host's waits for the metrics


def disable_augmentation_hook(hook_config, dataloader, total_epochs, cur_epoch, cfg, logger):
    """Turn off the configured augmentations for the last NUM_LAST_EPOCHS
    epochs (reference train_utils.py:257-272)."""
    if hook_config is None:
        return
    num_last_epochs = hook_config.NUM_LAST_EPOCHS
    if (total_epochs - num_last_epochs) <= cur_epoch:
        augmentor = dataloader.dataset.data_augmentor
        if augmentor is None:
            return
        disable = hook_config.get("DISABLE_AUG_LIST", [])
        aug_cfg = cfg.DATA_CONFIG.DATA_AUGMENTOR
        new_cfg = type(aug_cfg)(aug_cfg)
        new_cfg["DISABLE_AUG_LIST"] = list(
            set(list(aug_cfg.get("DISABLE_AUG_LIST", [])) + list(disable))
        )
        if logger:
            logger.info(f"Disable augmentations {disable} from epoch {cur_epoch}")
        augmentor.disable_augmentation(new_cfg)


def train_model(state: TrainState, batches, epochs: int, ckpt_dir, device="cuda",
                dtype=torch.bfloat16, start_epoch: int = 0, ckpt_save_interval: int = 1,
                max_ckpt_save_num: int = 30, ckpt_save_time_interval: float = 300,
                logger=None, on_step=None, cfg=None, merge_all_iters_to_one_epoch=False,
                on_epoch=None) -> TrainState:
    """Train `state` in place for epochs start_epoch .. epochs - 1 and return
    it. `on_step(it, metrics)`, if given, is called after every update with
    the update count and the step's metrics (0-dim tensors on the device);
    `on_epoch(stats)` after every epoch with {"epoch", "steps", "loss" (the
    last step's), "losses" (every step's), "data_time", "batch_time"}
    (seconds of host clock: waiting for the loader, and the whole epoch up to
    its last step's loss on the host). `cfg` (the full config) supplies
    HOOK.DisableAugmentationHook."""
    log = logger or _LOG
    step_fn = make_train_step(state.model, state.optimizer, device=device, dtype=dtype)
    if merge_all_iters_to_one_epoch and hasattr(batches, "dataset"):
        # one long epoch over total epochs × the dataset (reference
        # train_utils.py:156-162 + dataset.merge_all_iters_to_one_epoch)
        batches.dataset.merge_all_iters_to_one_epoch(merge=True, epochs=epochs)
        start_epoch, epochs = 0, 1
    hook_cfg = (cfg.get("HOOK") or {}).get("DisableAugmentationHook") if cfg else None
    last_latest_save = time.time()
    for cur_epoch in range(start_epoch, epochs):
        if hasattr(batches, "set_epoch"):
            batches.set_epoch(cur_epoch)
        disable_augmentation_hook(hook_cfg, batches, epochs, cur_epoch, cfg, log)
        data_time = batch_time = 0.0
        losses = []
        end = time.time()
        for item in batches:
            batch = item if isinstance(item, (PointBatch, MultimodalBatch)) else item[0]
            data_time += time.time() - end
            metrics = step_fn(batch)
            losses.append(metrics["loss"])
            it = state.step
            if it % LOG_INTERVAL == 0 or it == 1:
                shown = {k: float(v) for k, v in metrics.items()}
                log.info("epoch %d it %d: loss %.4f grad_norm %.3f lr %.3e", cur_epoch, it,
                         shown["loss"], shown["grad_norm"], state.optimizer.lr_fn(it))
            if on_step is not None:
                on_step(it, metrics)
            batch_time += time.time() - end
            end = time.time()
            if time.time() - last_latest_save > ckpt_save_time_interval:
                # crash-resilience save between epoch boundaries, epoch -1 as
                # in the JAX package (reference latest_model, train_utils.py:135-143)
                save_checkpoint(ckpt_dir, state, -1, max_ckpt_save_num, name="latest_model")
                last_latest_save = time.time()
        losses = torch.stack(losses).tolist() if losses else []   # waits for the card
        batch_time += time.time() - end
        stats = {"epoch": cur_epoch, "steps": len(losses),
                 "loss": losses[-1] if losses else float("nan"), "losses": losses,
                 "data_time": data_time, "batch_time": batch_time}
        log.info("epoch %d: loss=%.4f data_time=%.1fs batch_time=%.1fs (%d steps)", cur_epoch,
                 stats["loss"], data_time, batch_time, len(losses))
        if on_epoch is not None:
            on_epoch(stats)
        trained_epoch = cur_epoch + 1
        if trained_epoch % ckpt_save_interval == 0:
            path = save_checkpoint(ckpt_dir, state, trained_epoch, max_ckpt_save_num)
            log.info("checkpoint saved: %s", path)
    return state
