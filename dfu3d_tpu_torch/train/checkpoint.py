"""Checkpoints (port of the contract of dfu3d_tpu/train/checkpoint.py:21-108,
itself the reference's train_utils.py:199-254): per-epoch files named
`checkpoint_epoch_N.pth`, rotation keeping the newest `max_ckpt_save_num`, a
`latest_model.pth` save outside the rotation, and resume from the newest
checkpoint that loads, skipping corrupt ones.

The format is the reference's: `torch.save` of {'model_state',
'optimizer_state', 'epoch', 'it', 'version'}, tensors on the CPU. A file is
written beside its final name and renamed into place, so a save cut short
leaves no partial checkpoint under that name. A reference checkpoint (the
same format, keyed by the reference's module paths) loads through the
flagship's key mapping (train/torch_convert.py).
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from .torch_convert import is_reference_state, load_reference_state

_CKPT_RE = re.compile(r"^checkpoint_epoch_(\d+)\.pth$")
VERSION = f"dfu3d_tpu_torch+torch{torch.__version__}"


def list_checkpoints(ckpt_dir) -> list:
    """Sorted (epoch, path) pairs of the per-epoch checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    found = ((_CKPT_RE.match(p.name), p) for p in ckpt_dir.iterdir())
    return sorted((int(m.group(1)), p) for m, p in found if m)


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir, state, epoch: int, max_ckpt_save_num: int = 30,
                    name: str = None) -> Path:
    """Save `state` (a TrainState) as checkpoint_epoch_{epoch}.pth, first
    deleting the oldest so that at most max_ckpt_save_num remain; with
    `name`, as {name}.pth outside the rotation (the reference's
    latest_model)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if name is None:
        existing = list_checkpoints(ckpt_dir)
        while existing and len(existing) >= max_ckpt_save_num:
            existing.pop(0)[1].unlink(missing_ok=True)
    path = ckpt_dir / f"{name or f'checkpoint_epoch_{epoch}'}.pth"
    payload = {"model_state": _to_cpu(state.model.state_dict()),
               "optimizer_state": _to_cpu(state.optimizer.state_dict()),
               "epoch": int(epoch), "it": int(state.step), "version": VERSION}
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_model(payload, model, logger):
    """Load a read checkpoint's model weights into `model`: (epoch, the
    reference overlay's report or None)."""
    model_state = payload.get("model_state", payload)
    if is_reference_state(model_state):
        return 0, load_reference_state(model, model_state, logger)
    model.load_state_dict(model_state)
    return int(payload["epoch"]), None


def load_checkpoint(path, state=None, logger=None):
    """Load one checkpoint. With `state` (a TrainState), its model and
    optimizer are loaded in place and (state, epoch) is returned; without,
    (the saved dict, epoch).

    A reference (OpenPCDet / DFU3D) checkpoint, told apart by its
    model_state keys (train.torch_convert.is_reference_state), is overlaid
    onto the model only, through the flagship's key mapping, and its report
    logged to `logger`: its optimizer state is ignored and the epoch is 0,
    as in the JAX package (dfu3d_tpu/train/checkpoint.py:74-90). It needs
    `state`, and raises when no key converts."""
    payload = _read(path)
    if state is None:
        if is_reference_state(payload.get("model_state", payload)):
            raise ValueError(f"{path} is a reference checkpoint: it loads onto a model "
                             "(load_checkpoint(path, state) or load_model_state)")
        return payload, int(payload["epoch"])
    epoch, report = _load_model(payload, state.model, logger)
    if report is None:
        state.optimizer.load_state_dict(payload["optimizer_state"])
    return state, epoch


def load_model_state(path, model, logger=None):
    """The model weights of a checkpoint, the port's own or a reference one
    (its report logged to `logger`), loaded into `model` in place. Returns
    (epoch, the reference overlay's report or None); a reference
    checkpoint's epoch is 0."""
    return _load_model(_read(path), model, logger)


def load_latest(ckpt_dir, state=None):
    """Resume from the newest per-epoch checkpoint that loads, skipping
    corrupt ones; (None, -1) when there is none."""
    for _, path in reversed(list_checkpoints(ckpt_dir)):
        try:
            return load_checkpoint(path, state)
        except Exception:  # a corrupt or partial file: try the next older one
            continue
    return None, -1
