"""Training loop (port of dfu3d_tpu/train/trainer.py:46-173, itself the
reference's train_utils.train_model / train_one_epoch), over any re-iterable
of `PointBatch` (a list, or a loader that yields the epoch's batches each
time it is iterated).

Per epoch: the train step over every batch; sparse logging (every
LOG_INTERVAL updates and the first, the only points where the host waits
for the card); a `latest_model` save when `ckpt_save_time_interval` seconds
have passed since the last one; a per-epoch checkpoint with rotation. It
logs with the standard `logging` module. One process and one card: no mesh,
no DDP.
"""
from __future__ import annotations

import logging
import time

import torch

from .checkpoint import save_checkpoint
from .train_state import TrainState, make_train_step

_LOG = logging.getLogger(__name__)
LOG_INTERVAL = 20  # updates between the host's waits for the metrics


def train_model(state: TrainState, batches, epochs: int, ckpt_dir, device="cuda",
                dtype=torch.bfloat16, start_epoch: int = 0, ckpt_save_interval: int = 1,
                max_ckpt_save_num: int = 30, ckpt_save_time_interval: float = 300,
                logger=None, on_step=None) -> TrainState:
    """Train `state` in place for epochs start_epoch .. epochs - 1 and return
    it. `on_step(it, metrics)`, if given, is called after every update with
    the update count and the step's metrics (0-dim tensors on the device)."""
    log = logger or _LOG
    step_fn = make_train_step(state.model, state.optimizer, device=device, dtype=dtype)
    last_latest_save = time.time()
    for cur_epoch in range(start_epoch, epochs):
        data_time = batch_time = 0.0
        last = {}
        end = time.time()
        for batch in batches:
            data_time += time.time() - end
            metrics = step_fn(batch)
            it = state.step
            if it % LOG_INTERVAL == 0 or it == 1:
                last = {k: float(v) for k, v in metrics.items()}
                log.info("epoch %d it %d: loss %.4f grad_norm %.3f lr %.3e", cur_epoch, it,
                         last["loss"], last["grad_norm"], state.optimizer.lr_fn(it))
            if on_step is not None:
                on_step(it, metrics)
            batch_time += time.time() - end
            end = time.time()
            if time.time() - last_latest_save > ckpt_save_time_interval:
                save_checkpoint(ckpt_dir, state, cur_epoch, max_ckpt_save_num,
                                name="latest_model")
                last_latest_save = time.time()
        log.info("epoch %d: loss=%.4f data_time=%.1fs batch_time=%.1fs", cur_epoch,
                 last.get("loss", float("nan")), data_time, batch_time)
        trained_epoch = cur_epoch + 1
        if trained_epoch % ckpt_save_interval == 0:
            path = save_checkpoint(ckpt_dir, state, trained_epoch, max_ckpt_save_num)
            log.info("checkpoint saved: %s", path)
    return state
