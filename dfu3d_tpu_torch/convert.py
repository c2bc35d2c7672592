"""Weights carried across from the JAX package.

The port's submodules carry the flax module names (vfe.pfn_0.Dense_0,
backbone_2d.block0_down.Conv_0, dense_head.fused_heads.out, ...), so a flax
variable path maps to a state_dict key one to one and only the leaf is
transformed:

    Dense kernel (in, out)          → weight (out, in)
    sparse conv kernel (K, Cin, Cout) → kernel, as is (taps in kernel_offsets
                                      order, x slowest, z fastest)
    Conv kernel HWIO (also grouped) → weight OIHW
    ConvTranspose kernel HWIO       → weight (in, out, kh, kw), flipped in
                                      both spatial dims (torch's transposed
                                      conv is the gradient of a conv; flax's
                                      is a dilated conv with the kernel as is)
    BN scale / bias / mean / var    → weight / bias / running_mean / running_var
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var"}


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def params_from_jax(variables, model=None):
    """flax {"params", "batch_stats"} tree of numpy arrays → the port's
    state_dict (CPU float32 tensors). With `model`, the dict is loaded into it
    (strictly) and the model is returned."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif mods[-1].startswith("ConvTranspose"):
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                if arr.ndim != 3:  # sparse conv kernels keep their name
                    name = "weight"
            else:
                name = _LEAF_NAMES[name]
            state[".".join([*mods, name])] = torch.from_numpy(arr.copy(order="C"))
    if model is None:
        return state
    model.load_state_dict(state)
    return model
