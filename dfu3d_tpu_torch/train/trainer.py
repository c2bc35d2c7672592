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
(no TensorBoard).

With `steps_per_dispatch` K > 1 the loop buffers K batches and runs them as
one `make_multi_train_step` call (the epoch's tail, fewer than K batches,
as single steps), logging where an update count `it` has it % 20 < K or
it <= K, as the JAX package's trainer does. In a process group (one
process per card, `parallel`) every rank runs the loop over its loader
shard; rank 0 logs and writes the checkpoints (the epoch's behind a
barrier), and the epoch's data and batch times are averaged over ranks.
"""
from __future__ import annotations

import logging
import time

import torch

from ..data.batch import MultimodalBatch, PointBatch
from ..parallel import mesh
from .checkpoint import save_checkpoint
from .train_state import TrainState, make_multi_train_step, make_train_step

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
                on_epoch=None, steps_per_dispatch: int = 1) -> TrainState:
    """Train `state` in place for epochs start_epoch .. epochs - 1 and return
    it. `on_step(it, metrics)`, if given, is called after every update (every
    K updates with `steps_per_dispatch` K) with the update count and the
    metrics (0-dim tensors on the device; "loss_steps" too after K steps);
    `on_epoch(stats)` after every epoch with {"epoch", "steps", "loss" (the
    last step's), "losses" (every step's), "data_time", "batch_time"}
    (seconds of host clock, averaged over ranks: waiting for the loader, and
    the whole epoch up to its last step's loss on the host). `cfg` (the full
    config) supplies HOOK.DisableAugmentationHook."""
    lead = mesh.rank() == 0
    log = logger or _LOG
    step_fn = make_train_step(state.model, state.optimizer, device=device, dtype=dtype)
    k = max(int(steps_per_dispatch), 1)
    multi_fn = (make_multi_train_step(state.model, state.optimizer, k, device=device, dtype=dtype)
                if k > 1 else None)
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
        disable_augmentation_hook(hook_cfg, batches, epochs, cur_epoch, cfg,
                                  log if lead else None)
        data_time = batch_time = 0.0
        losses, pending = [], []
        end = time.time()

        def after(metrics, n):
            """Log, report and save after `n` updates that gave `metrics`."""
            nonlocal end, batch_time, last_latest_save
            losses.append(metrics["loss_steps"] if n > 1 else metrics["loss"].reshape(1))
            it = state.step
            if lead and (it % LOG_INTERVAL < n or it <= n):
                shown = {key: float(v) for key, v in metrics.items() if v.dim() == 0}
                log.info("epoch %d it %d: loss %.4f grad_norm %.3f lr %.3e", cur_epoch, it,
                         shown["loss"], shown["grad_norm"], state.optimizer.lr_fn(it))
            if on_step is not None:
                on_step(it, metrics)
            batch_time += time.time() - end
            end = time.time()
            if lead and time.time() - last_latest_save > ckpt_save_time_interval:
                # crash-resilience save between epoch boundaries, epoch -1 as
                # in the JAX package (reference latest_model, train_utils.py:135-143)
                save_checkpoint(ckpt_dir, state, -1, max_ckpt_save_num, name="latest_model")
                last_latest_save = time.time()

        for item in batches:
            batch = item if isinstance(item, (PointBatch, MultimodalBatch)) else item[0]
            data_time += time.time() - end
            if multi_fn is None:
                after(step_fn(batch), 1)
                continue
            pending.append(batch)
            if len(pending) < k:
                end = time.time()
                continue
            after(multi_fn(pending), k)
            pending = []
        for batch in pending:   # the epoch's tail, shorter than K
            after(step_fn(batch), 1)
        losses = torch.cat(losses).tolist() if losses else []   # waits for the card
        batch_time += time.time() - end
        data_time, batch_time = mesh.mean_floats([data_time, batch_time])
        stats = {"epoch": cur_epoch, "steps": len(losses),
                 "loss": losses[-1] if losses else float("nan"), "losses": losses,
                 "data_time": data_time, "batch_time": batch_time}
        if lead:
            log.info("epoch %d: loss=%.4f data_time=%.1fs batch_time=%.1fs (%d steps)",
                     cur_epoch, stats["loss"], data_time, batch_time, len(losses))
        if on_epoch is not None:
            on_epoch(stats)
        trained_epoch = cur_epoch + 1
        if trained_epoch % ckpt_save_interval == 0:
            if lead:
                path = save_checkpoint(ckpt_dir, state, trained_epoch, max_ckpt_save_num)
                log.info("checkpoint saved: %s", path)
            mesh.barrier()
    return state
