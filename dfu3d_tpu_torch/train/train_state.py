"""Train and eval steps (port of dfu3d_tpu/train/train_state.py).

The train step is the JAX package's `make_train_step`: forward and loss
under bf16 autocast (its compute dtype on the chip), the backward, the
global-norm clip and the optimizer update; BN layers update their running
statistics in the forward. bf16 needs no loss scaling, so there is no
GradScaler. Each step hands the model two generators on the device, its
`sampler` (PointRCNN's RoI subsampler) and `dropout` draws, seeded from
(17, update count) and (23, update count) as JAX folds the update count into
PRNGKey(17) and PRNGKey(23): a resumed run draws what an uninterrupted one
draws. The eval step predicts, then counts the reference's recall
(detector3d_template generate_recall_record) over the fixed-size padded
outputs.

Over several ranks (`parallel`, one process per card) each rank's batch is
its block of rows of the global batch and the step is the JAX package's
step on that global batch: the models' BN statistics and loss normalisers
are global (`parallel.mesh`), the gradients are summed over ranks before
the clip and the update, and the metrics are the global ones. Without a
process group the step is the one-process step, unchanged.
`make_multi_train_step` runs K steps per call (the train CLI's
--steps_per_dispatch).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from ..core.geometry import pairwise_iou3d
from ..device import resolve_device
from ..parallel import mesh
from .optimization import Optimizer, build_optimizer


@dataclass
class TrainState:
    """The model and its optimizer; `step` is the number of updates made."""

    model: nn.Module
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_train_state(model, optim_cfg, total_steps: int) -> TrainState:
    """The model with the optimizer OPTIMIZATION (`optim_cfg`) names, its
    schedule spread over `total_steps`."""
    return TrainState(model, build_optimizer(model.parameters(), optim_cfg, total_steps))


def _autocast(dev, dtype):
    return (torch.autocast(dev.type, dtype=dtype) if dtype != torch.float32
            else contextlib.nullcontext())


SAMPLER_SEED, DROPOUT_SEED = 17, 23


def step_seed(base: int, step: int) -> int:
    """A 64-bit seed of (base, step), splitmix64-mixed: the CPU generator
    reads only part of its seed, so every bit must depend on both."""
    mask = (1 << 64) - 1
    z = ((base << 32) + step + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def step_generator(dev, base: int, step: int) -> torch.Generator:
    """A generator on `dev` seeded from (base, step), one stream per pair."""
    return torch.Generator(device=dev).manual_seed(step_seed(base, step))


def make_train_step(model, optimizer: Optimizer, device="cuda", dtype=torch.bfloat16):
    """Returns train_step(batch) → metrics: {"loss", the model's loss terms
    (CenterPoint: "hm_loss_head_i", "loc_loss_head_i"; PointRCNN:
    "point_cls_loss", "point_reg_loss", "rcnn_cls_loss", "rcnn_reg_loss"),
    "rpn_loss", "grad_norm"}, 0-dim tensors on the device (reading one syncs
    the host). The batch is moved to `device`, where the model must live; the
    model is put in train mode and called with the step's `sampler` and
    `dropout` generators. With `dtype` torch.float32 nothing runs under
    autocast. In a process group the gradients are summed over ranks and
    the loss terms are the global ones; at a world above 1 a model with a
    module not audited for the global batch raises NotImplementedError
    (`parallel.mesh.check_global_batch`)."""
    dev = resolve_device(device)
    mesh.check_global_batch(model)

    def train_step(batch):
        if not model.training:   # a walk over every submodule: ~1 ms of host time
            model.train()
        batch = batch.to(dev)
        optimizer.zero_grad()
        count = optimizer.count
        with _autocast(dev, dtype):
            loss, tb = model(batch, sampler=step_generator(dev, SAMPLER_SEED, count),
                             dropout=step_generator(dev, DROPOUT_SEED, count))
        loss.backward()
        mesh.all_reduce_grads_(optimizer.params)
        grad_norm = optimizer.step()
        metrics = mesh.sum_scalars({"loss": loss.detach(),
                                    **{k: v.detach() for k, v in tb.items()}})
        return {**metrics, "grad_norm": grad_norm}

    return train_step


def make_multi_train_step(model, optimizer: Optimizer, steps_per_dispatch: int, device="cuda",
                          dtype=torch.bfloat16):
    """Returns multi_step(batches) → metrics for a sequence of K =
    `steps_per_dispatch` batches: K `make_train_step` updates in order (the
    same weights as K single steps), metrics of the last step plus
    "loss_steps", the K losses as a (K,) tensor (the JAX package's
    make_multi_train_step, a lax.scan over K stacked batches). Nothing in it
    waits for the card."""
    step = make_train_step(model, optimizer, device=device, dtype=dtype)
    k = int(steps_per_dispatch)

    def multi_step(batches):
        batches = list(batches)
        if len(batches) != k:
            raise ValueError(f"multi_step takes {k} batches, got {len(batches)}")
        losses = []
        for batch in batches:
            metrics = step(batch)
            losses.append(metrics["loss"])
        return {**metrics, "loss_steps": torch.stack(losses)}

    return multi_step


def make_eval_step(model, recall_thresh=None, device="cuda", dtype=torch.float32):
    """Returns eval_step(batch) → (boxes, scores, labels, valid[, recall]).

    The batch is moved to `device`, where the model must live; the model is
    put in eval mode. With `dtype` torch.bfloat16 the network runs under bf16
    autocast (the JAX package's compute dtype on the chip); decode, NMS and
    recall stay fp32. With
    `recall_thresh` (a tuple of IoU thresholds) the step also returns
    {"gt_num", "recall_rcnn_{t}"} as 0-dim int64 tensors on the device.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(batch):
        if model.training:
            model.eval()
        batch = batch.to(dev)
        with _autocast(dev, dtype):
            out = model.predict(batch)
        if recall_thresh is None:
            return out
        return (*out, recall_record(out[0], out[3], batch, recall_thresh))

    return eval_step


def recall_record(boxes, valid, batch, recall_thresh):
    """The reference's recall counters of predicted boxes (B, S, 7+) with
    their valid mask against the batch's gt: {"gt_num", "recall_rcnn_{t}"}
    as 0-dim int64 tensors on the device (one B1 launch)."""
    gv = batch.gt_valid
    iou = pairwise_iou3d(boxes[..., :7], batch.gt_boxes[..., :7])  # (B, S, M)
    iou = torch.where(valid[:, :, None] & gv[:, None, :], iou, 0.0)
    max_iou = torch.clamp(iou.amax(dim=1), min=0.0)                  # (B, M)
    recall = {"gt_num": gv.sum()}
    for t in recall_thresh:
        recall[f"recall_rcnn_{t}"] = ((max_iou > t) & gv).sum()
    return recall
