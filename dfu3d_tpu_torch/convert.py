"""Weights carried across from the JAX package.

The port's submodules carry the flax module names (vfe.pfn_0.Dense_0,
backbone_2d.block0_down.Conv_0, dense_head.fused_heads.out, PointRCNN's
backbone.sa_0.mlp_0.dense_0, point_head.cls_out, roi_head.sa0_bn1,
roi_head.cls_fc.fc0, the two-stage detectors' encoder.down2_refine,
pool_x_conv2.in_dense, shared_fc.fc0, iou_fc.out, cls_pred, sa_stage0.
SharedMLP_0.dense_0, vsa_fusion, kp_seg, grid_sa0, PV-RCNN++'s vp_raw and
grid_msg, PartA2's unet.up3, seg_mlp, roi_head.part0_conv, ...), so a flax variable
path maps to a state_dict key one to one and only the leaf is transformed:

    Dense kernel (in, out)          → weight (out, in)
    sparse conv kernel (K, Cin, Cout) → kernel, as is (taps in kernel_offsets
                                      order, x slowest, z fastest)
    Conv kernel HWIO (also grouped) → weight OIHW
    3D Conv kernel (kx, ky, kz, I, O) → weight (O, I, kx, ky, kz)
    ConvTranspose kernel HWIO       → weight (in, out, kh, kw), flipped in
                                      both spatial dims (torch's transposed
                                      conv is the gradient of a conv; flax's
                                      is a dilated conv with the kernel as is)
    BN scale / bias / mean / var    → weight / bias / running_mean / running_var

A 4-D kernel is a transposed conv's where the port model's module at that path
is an nn.ConvTranspose2d (with `model`), else where its flax module name
starts with "ConvTranspose" (ENetRef names its transposed convs "conv").

`enet_mapping` / `load_enet_reference` carry a reference PENet checkpoint
(tools/PENet/model.py key names) into the port's ENetRef; both are torch
modules, so each tensor keeps its layout and only its key changes.
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
    modules = dict(model.named_modules()) if model is not None else {}

    def transposed(mods):
        if model is not None:
            return isinstance(modules.get(".".join(mods)), torch.nn.ConvTranspose2d)
        return mods[-1].startswith("ConvTranspose")

    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif arr.ndim == 4 and transposed(mods):
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 5:
                    arr = arr.transpose(4, 3, 0, 1, 2)
                if arr.ndim != 3:  # sparse conv kernels keep their name
                    name = "weight"
            else:
                name = _LEAF_NAMES[name]
            state[".".join([*mods, name])] = torch.from_numpy(arr.copy(order="C"))
    if model is None:
        return state
    model.load_state_dict(state)
    return model


def enet_mapping() -> dict:
    """Port ENetRef state_dict key → reference PENet key (own copy of the
    JAX package's torch_convert.enet_mapping, train/torch_convert.py:852-897):
    conv/deconv Sequential pairs (`.0` conv, `.1` BN) and the geo-conditioned
    BasicBlockGeo encoders whose strided or widening blocks carry a conv+BN
    shortcut (`downsample.0/1`)."""
    from .models.penet_ref import DEPTH_LAYERS, RGB_LAYERS

    m = {}

    def bn(ours, ref):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            m[f"{ours}.{leaf}"] = f"{ref}.{leaf}"

    def seq(name):
        m[f"{name}.conv.weight"] = f"{name}.0.weight"
        bn(f"{name}.bn", f"{name}.1")

    def geo_block(name, has_down):
        for i in (1, 2):
            m[f"{name}.conv{i}.weight"] = f"{name}.conv{i}.weight"
            bn(f"{name}.bn{i}", f"{name}.bn{i}")
        if has_down:
            m[f"{name}.down_conv.weight"] = f"{name}.downsample.0.weight"
            bn(f"{name}.down_bn", f"{name}.downsample.1")

    seq("rgb_conv_init")
    seq("depth_conv_init")
    for prefix, layers in (("rgb_encoder_layer", RGB_LAYERS), ("depth_layer", DEPTH_LAYERS)):
        for i, (inp, out, st) in enumerate(layers, start=1):
            geo_block(f"{prefix}{i}", st != 1 or inp != out)
    for name in ([f"rgb_decoder_layer{lvl}" for lvl in (8, 6, 4, 2, 0)] + ["rgb_decoder_output"]
                 + [f"decoder_layer{j}" for j in range(1, 7)]):
        seq(name)
    return m


def load_torch_state(path) -> dict:
    """A reference torch checkpoint file → {key: tensor} of its model_state
    (or of the file itself when it is a bare state dict), as the JAX
    package's load_torch_checkpoint reads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v for k, v in ckpt.get("model_state", ckpt).items() if torch.is_tensor(v)}


def load_enet_reference(model, state) -> dict:
    """Overlay a reference PENet state dict (key → tensor) onto the port's ENetRef through
    `enet_mapping` (the JAX package's apply_mapping semantics: keys missing
    on the reference side keep their values; a shape mismatch raises).
    Returns {"converted", "missing_in_torch", "unmatched_ours"}."""
    own = model.state_dict()
    new, converted, missing = {}, [], []
    for ours, ref in enet_mapping().items():
        if ref not in state:
            missing.append(ref)
            continue
        w = state[ref]
        if tuple(w.shape) != tuple(own[ours].shape):
            raise ValueError(f"shape mismatch for {ours} <- {ref}: {tuple(w.shape)} vs "
                             f"{tuple(own[ours].shape)}")
        new[ours] = w.to(own[ours].dtype)
        converted.append(ref)
    model.load_state_dict(new, strict=False)
    return {"converted": converted, "missing_in_torch": missing,
            "unmatched_ours": sorted(set(own) - set(enet_mapping()))}
