"""Reference (OpenPCDet / DFU3D) checkpoints onto the port's flagship,
PointRCNN and the anchor detectors (own copy of the JAX package's
train/torch_convert.py: `pfn_mapping`, `centerpoint_pillar_mapping`,
`anchor_head_mapping`, `point_head_box_mapping`, `pointrcnn_head_mapping`,
`second_head_mapping`, `voxelrcnn_head_mapping`, `pvrcnn_head_mapping`,
`parta2_head_mapping` with `t_spconv_dense` and `apply_mapping`'s partial
overlay, :50-166, :300-394, :397-451, :424-505, :513-604, :959-1029).

A reference checkpoint is a `torch.save` of {'model_state', 'optimizer_state',
'epoch', 'it', 'version'} whose model_state keys are the reference's module
paths (vfe.pfn_layers.0.linear.weight, backbone_2d.blocks.0.1.weight,
dense_head.heads_list.3.hm.1.weight, ...). The mapping here reads those keys
into the port's state_dict names, so every transform is reference → port:

    PFN Linear          identity: both (out, in)
    Conv2d              identity: both OIHW
    ConvTranspose2d     identity: both (in, out, kh, kw); the JAX package
                        flips it into flax's HWIO and params_from_jax flips
                        it back
    BatchNorm           identity: weight, bias, running_mean, running_var
    fused head conv0 /  the per-tower tensors concatenated on the output
    bn0                 channels, in branch order (center, center_z, dim,
                        rot, hm) per head
    fused head out      each tower's OIHW weight (and bias) zero-padded on O
                        to the widest branch, then concatenated: the port's
                        grouped out conv
    Linear              identity: both (out, in)
    Conv1d / Conv2d k=1 (out, in, 1[, 1]) reshaped to the Linear's (out, in)
    SubMConv3d (PartA2   spconv's layout → Conv3d (out, in, kx, ky, kz)
    RoI head)            (`t_spconv_dense`)

The overlay is partial, as the reference's load_params_from_file is
(strict=False): keys of the mapping that the model lacks are skipped (the
mapping lists a deblock's Conv2d and ConvTranspose2d alternatives), keys the checkpoint lacks are reported as missing and the
model keeps its values there, and the model's keys outside the mapping are
reported as unmatched and kept. A shape mismatch raises. The model picks
its mapping (its `reference_mapping()` method): the flagship's (CenterPoint-pillar,
centerpoint_nuscenes2kitti.yaml, the JAX package's convert_state_dict
default) for CenterPoint, the point head's and the RoI head's for PointRCNN,
the pillar VFE's, the 2D backbone's and AnchorHeadSingle's for PointPillar
and SECONDNet, and those two with the RoI head's for SECONDNetIoU,
VoxelRCNN, PVRCNN and PartA2Net (PVRCNNPlusPlus has the RPN's only: the
JAX package maps no PV-RCNN++ head). The JAX package has no PointNet2MSG, sparse-backbone or
AnchorHeadMulti mapping, so neither has the port: those modules keep their
values and are reported unmatched.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, Dict, Tuple

import torch

__all__ = ["is_reference_state", "centerpoint_pillar_mapping", "pfn_mapping",
           "bev_backbone_mapping", "anchor_head_mapping", "point_head_box_mapping",
           "pointrcnn_head_mapping", "second_head_mapping", "voxelrcnn_head_mapping",
           "pvrcnn_head_mapping", "parta2_head_mapping", "t_spconv_dense", "apply_mapping",
           "load_reference_state"]

# reference module paths that no port state_dict key contains
_REFERENCE_KEY = re.compile(r"(^|\.)(pfn_layers|blocks|deblocks|heads_list|cls_layers|box_layers"
                            r"|reg_layers|xyz_up_layer|merge_down_layer|SA_modules|FP_modules"
                            r"|iou_layers|shared_fc_layer|cls_fc_layers|reg_fc_layers"
                            r"|roi_grid_pool_layers|conv_part|conv_rpn)"
                            r"\.\d")

Mapping = Dict[str, Tuple[object, Callable]]


def is_reference_state(model_state) -> bool:
    """Whether a model_state is keyed by the reference's module paths (a
    reference checkpoint) rather than by the port's (its own checkpoints);
    both are .pth files, so the keys tell them apart."""
    return any(_REFERENCE_KEY.search(k) for k in model_state)


def t_identity(w):
    return w


def t_fc(w):
    """Linear / Conv1d(k=1) / Conv2d(k=1) weight → the port's Linear (out, in)."""
    return w.reshape(w.shape[0], -1)


def t_cat(ws):
    return torch.cat(list(ws), dim=0)


def _t_fused_out(out_chs, out_max):
    def f(ws):
        return torch.cat([torch.cat([w, w.new_zeros((out_max - oc,) + tuple(w.shape[1:]))])
                          for w, oc in zip(ws, out_chs)])
    return f


def _bn(m, ours, ref):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        m[f"{ours}.{leaf}"] = (f"{ref}.{leaf}", t_identity)


def _conv(m, ours, ref, bias=False):
    m[f"{ours}.weight"] = (f"{ref}.weight", t_identity)
    if bias:
        m[f"{ours}.bias"] = (f"{ref}.bias", t_identity)


# the flagship's widths (centerpoint_nuscenes2kitti.yaml)
LAYER_NUMS = (3, 5, 5)
NUM_PFN = 2
HM_COUNTS = (1, 2, 2, 1, 2, 2)
BRANCHES = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2))


def pfn_mapping(num_pfn: int) -> Mapping:
    """PFNLayerV2 stack (dynamic_pillar_vfe.py:14-46): Linear (no bias) + BN
    per layer (the JAX package's pfn_mapping with USE_NORM)."""
    m: Mapping = {}
    for i in range(num_pfn):
        m[f"vfe.pfn_{i}.Dense_0.weight"] = (f"vfe.pfn_layers.{i}.linear.weight", t_identity)
        _bn(m, f"vfe.pfn_{i}.MaskedBatchNorm_0", f"vfe.pfn_layers.{i}.norm")
    return m


def bev_backbone_mapping(layer_nums) -> Mapping:
    """BaseBEVBackbone: reference blocks.{i} = [ZeroPad, Conv(stride), BN,
    ReLU, (Conv, BN, ReLU) × layer_nums[i]]; deblocks.{i} = [ConvT|Conv, BN,
    ReLU] (base_bev_backbone.py:26-79)."""
    m: Mapping = {}
    for i, n in enumerate(layer_nums):
        _conv(m, f"backbone_2d.block{i}_down.Conv_0", f"backbone_2d.blocks.{i}.1")
        _bn(m, f"backbone_2d.block{i}_down.BatchNorm_0", f"backbone_2d.blocks.{i}.2")
        for j in range(n):
            _conv(m, f"backbone_2d.block{i}_conv{j}.Conv_0", f"backbone_2d.blocks.{i}.{4 + 3 * j}")
            _bn(m, f"backbone_2d.block{i}_conv{j}.BatchNorm_0",
                f"backbone_2d.blocks.{i}.{5 + 3 * j}")
        # deblock: ConvTranspose for upsample stride ≥ 1, Conv for < 1
        m[f"backbone_2d.deblock{i}.ConvTranspose_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        m[f"backbone_2d.deblock{i}.Conv_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        _bn(m, f"backbone_2d.deblock{i}.BatchNorm_0", f"backbone_2d.deblocks.{i}.1")
    return m


def anchor_head_mapping(use_dir: bool = True, prefix: str = "dense_head") -> Mapping:
    """AnchorHeadSingle (anchor_head_single.py:10-74): the 1×1 conv_cls,
    conv_box and conv_dir_cls, OIHW on both sides. The per-location anchor
    order is the reference's (class-major, size-major, rotation-minor), so
    the channels line up (the JAX package's anchor_head_mapping,
    :378-394)."""
    m: Mapping = {}
    for name in ["conv_cls", "conv_box"] + (["conv_dir_cls"] if use_dir else []):
        _conv(m, f"{prefix}.{name}", f"{prefix}.{name}", bias=True)
    return m


def centerpoint_pillar_mapping() -> Mapping:
    """Port state_dict key → (reference key, or a tuple of them, transform)
    for the flagship CenterPoint-pillar (DynamicPillarVFE + BaseBEVBackbone +
    CenterHead), in the JAX package's entry order."""
    m: Mapping = {**pfn_mapping(NUM_PFN), **bev_backbone_mapping(LAYER_NUMS)}
    _conv(m, "dense_head.shared_conv.layers_0", "dense_head.shared_conv.0", bias=True)
    _bn(m, "dense_head.shared_bn", "dense_head.shared_conv.1")
    # the JAX package also maps its per-tower SeparateHead fallback; the
    # port has the fused layout only (center_head.FusedSeparateHeads)
    # fused layout (models/center_head.FusedSeparateHeads): the towers'
    # tensors concatenate along output channels in branch-spec order, out
    # convs padded to the widest branch
    specs = []
    for h, hm in enumerate(HM_COUNTS):
        for name, oc in BRANCHES + (("hm", hm),):
            specs.append((f"dense_head.heads_list.{h}.{name}", oc))
    out_chs = [oc for _, oc in specs]
    out_max = max(out_chs)
    fh = "dense_head.fused_heads"
    for ours, leaf in (("conv0.weight", "0.0.weight"), ("conv0.bias", "0.0.bias"),
                       ("bn0.weight", "0.1.weight"), ("bn0.bias", "0.1.bias"),
                       ("bn0.running_mean", "0.1.running_mean"),
                       ("bn0.running_var", "0.1.running_var")):
        m[f"{fh}.{ours}"] = (tuple(f"{p}.{leaf}" for p, _ in specs), t_cat)
    m[f"{fh}.out.weight"] = (tuple(f"{p}.1.weight" for p, _ in specs),
                             _t_fused_out(out_chs, out_max))
    m[f"{fh}.out.bias"] = (tuple(f"{p}.1.bias" for p, _ in specs),
                           _t_fused_out(out_chs, out_max))
    return m


def point_head_box_mapping(cls_fc=(256, 256), reg_fc=(256, 256), ours_prefix="point_head",
                           ref_prefix="point_head") -> Mapping:
    """PointHeadBox (point_head_box.py:13-30, point_head_template
    make_fc_layers:36-47): each stack is [Linear (no bias), BatchNorm1d,
    ReLU] per width and a biased Linear, the reference's cls_layers /
    box_layers; the port's SharedMLP dense_{i} / bn_{i} and {cls,reg}_out."""
    m: Mapping = {}
    for which, fc in (("cls", tuple(cls_fc)), ("reg", tuple(reg_fc))):
        ref_stack = f"{ref_prefix}.{'cls' if which == 'cls' else 'box'}_layers"
        for i in range(len(fc)):
            m[f"{ours_prefix}.{which}_fc.dense_{i}.weight"] = (f"{ref_stack}.{3 * i}.weight",
                                                              t_identity)
            _bn(m, f"{ours_prefix}.{which}_fc.bn_{i}", f"{ref_stack}.{3 * i + 1}")
        m[f"{ours_prefix}.{which}_out.weight"] = (f"{ref_stack}.{3 * len(fc)}.weight", t_identity)
        m[f"{ours_prefix}.{which}_out.bias"] = (f"{ref_stack}.{3 * len(fc)}.bias", t_identity)
    return m


def _fc_between(m, ours, ref, n):
    """A head's shared / cls / reg tower [Linear|Conv1d (no bias), BN, ReLU,
    Dropout between blocks] (voxelrcnn_head.py:41-83, pvrcnn_head.py:20-33)
    ↔ roi_head.FCStack fc{i} / bn{i}."""
    idx = 0
    for i in range(n):
        m[f"{ours}.fc{i}.weight"] = (f"{ref}.{idx}.weight", t_fc)
        _bn(m, f"{ours}.bn{i}", f"{ref}.{idx + 1}")
        idx += 3 if i == n - 1 else 4


def _fc_make(m, ours, ref, n):
    """make_fc_layers (roi_head_template.py:29-43: dropout after block 0, a
    biased prediction conv last) ↔ roi_head.FCStack fc{i} / bn{i} / out."""
    idx = 0
    for i in range(n):
        m[f"{ours}.fc{i}.weight"] = (f"{ref}.{idx}.weight", t_fc)
        _bn(m, f"{ours}.bn{i}", f"{ref}.{idx + 1}")
        idx += 3
        if i == 0:
            idx += 1
    m[f"{ours}.out.weight"] = (f"{ref}.{idx}.weight", t_fc)
    m[f"{ours}.out.bias"] = (f"{ref}.{idx}.bias", t_identity)


def pointrcnn_head_mapping(xyz_up=(128, 128), sa_mlps=((128, 128, 128), (128, 128, 256),
                                                       (256, 256, 512)),
                           cls_fc=(256, 256), reg_fc=(256, 256), use_bn=False,
                           ours_prefix="roi_head", ref_prefix="roi_head") -> Mapping:
    """PointRCNNHead (pointrcnn_head.py:10-65): the xyz_up and merge_down
    Conv2d(k=1) stacks (biased without USE_BN), the batch SA modules' MLPs
    (always Conv2d + BN2d, pointnet2_batch modules:90-97) and the
    make_fc_layers cls / reg stacks."""
    m: Mapping = {}
    step = 3 if use_bn else 2  # [conv, (bn,) relu] per block
    for i in range(len(xyz_up)):
        base = f"{ref_prefix}.xyz_up_layer.{step * i}"
        m[f"{ours_prefix}.xyz_up_d{i}.weight"] = (f"{base}.weight", t_fc)
        if use_bn:
            _bn(m, f"{ours_prefix}.xyz_up_bn{i}", f"{ref_prefix}.xyz_up_layer.{step * i + 1}")
        else:
            m[f"{ours_prefix}.xyz_up_d{i}.bias"] = (f"{base}.bias", t_identity)
    m[f"{ours_prefix}.merge_down_d0.weight"] = (f"{ref_prefix}.merge_down_layer.0.weight", t_fc)
    if use_bn:
        _bn(m, f"{ours_prefix}.merge_down_bn0", f"{ref_prefix}.merge_down_layer.1")
    else:
        m[f"{ours_prefix}.merge_down_d0.bias"] = (f"{ref_prefix}.merge_down_layer.0.bias",
                                                  t_identity)
    for k, mlp in enumerate(sa_mlps):
        base = f"{ref_prefix}.SA_modules.{k}.mlps.0"
        for j in range(len(mlp)):
            m[f"{ours_prefix}.sa{k}_d{j}.weight"] = (f"{base}.{3 * j}.weight", t_fc)
            _bn(m, f"{ours_prefix}.sa{k}_bn{j}", f"{base}.{3 * j + 1}")
    _fc_make(m, f"{ours_prefix}.cls_fc", f"{ref_prefix}.cls_layers", len(cls_fc))
    _fc_make(m, f"{ours_prefix}.reg_fc", f"{ref_prefix}.reg_layers", len(reg_fc))
    return m


def second_head_mapping(shared_fc: int = 2, iou_fc: int = 2, ref_prefix="roi_head") -> Mapping:
    """SECONDHead (second_head.py:10-42): the Conv1d SHARED_FC tower and the
    make_fc_layers IOU_FC stack (the RoI-align has no weights); the
    arguments are the stacks' depths."""
    m: Mapping = {}
    _fc_between(m, "shared_fc", f"{ref_prefix}.shared_fc_layer", shared_fc)
    _fc_make(m, "iou_fc", f"{ref_prefix}.iou_layers", iou_fc)
    return m


def voxelrcnn_head_mapping(shared_fc: int = 2, cls_fc: int = 2, reg_fc: int = 2,
                           pool_sources=("x_conv2", "x_conv3", "x_conv4"),
                           ref_prefix="roi_head") -> Mapping:
    """VoxelRCNNHead (voxelrcnn_head.py:8-101): per FEATURES_SOURCE stage a
    NeighborVoxelSAModuleMSG (mlps_in, mlps_pos, mlps_out: Conv + BN each,
    one scale), the Linear shared / cls / reg towers and the separate pred
    layers; the arguments are the towers' depths."""
    m: Mapping = {}
    for i, src in enumerate(pool_sources):
        base = f"{ref_prefix}.roi_grid_pool_layers.{i}"
        for ours, ref in (("in", "mlps_in"), ("pos", "mlps_pos"), ("out", "mlps_out")):
            m[f"pool_{src}.{ours}_dense.weight"] = (f"{base}.{ref}.0.0.weight", t_fc)
            _bn(m, f"pool_{src}.{ours}_bn", f"{base}.{ref}.0.1")
    _fc_between(m, "shared_fc", f"{ref_prefix}.shared_fc_layer", shared_fc)
    _fc_between(m, "cls_fc", f"{ref_prefix}.cls_fc_layers", cls_fc)
    _fc_between(m, "reg_fc", f"{ref_prefix}.reg_fc_layers", reg_fc)
    for which in ("cls", "reg"):
        m[f"{which}_pred.weight"] = (f"{ref_prefix}.{which}_pred_layer.weight", t_fc)
        m[f"{which}_pred.bias"] = (f"{ref_prefix}.{which}_pred_layer.bias", t_identity)
    return m


def pvrcnn_head_mapping(shared_fc: int = 2, cls_fc: int = 2, reg_fc: int = 2,
                        num_pool_groups: int = 2, pool_mlp_depth: int = 2,
                        ref_prefix="roi_head") -> Mapping:
    """PVRCNNHead (pvrcnn_head.py:8-63): the StackSAModuleMSG grid-pool
    groups (Conv2d + BN2d shared MLPs over [rel xyz ‖ features]), the Conv1d
    SHARED_FC tower and the make_fc_layers cls / reg stacks."""
    m: Mapping = {}
    for g in range(num_pool_groups):
        base = f"{ref_prefix}.roi_grid_pool_layer.mlps.{g}"
        for k in range(pool_mlp_depth):
            m[f"grid_sa{g}.SharedMLP_0.dense_{k}.weight"] = (f"{base}.{3 * k}.weight", t_fc)
            _bn(m, f"grid_sa{g}.SharedMLP_0.bn_{k}", f"{base}.{3 * k + 1}")
    _fc_between(m, "shared_fc", f"{ref_prefix}.shared_fc_layer", shared_fc)
    _fc_make(m, "cls_fc", f"{ref_prefix}.cls_layers", cls_fc)
    _fc_make(m, "reg_fc", f"{ref_prefix}.reg_layers", reg_fc)
    return m


def t_spconv_dense(w):
    """spconv SubMConv3d weight → the port's Conv3d weight (Cout, Cin, kx,
    ky, kz), for PartA2FCHead's submanifold blocks that the port runs as
    dense convs over the pooled grids (the JAX package's t_spconv_dense,
    which gives flax's (kx, ky, kz, Cin, Cout)). spconv 1.x stores (kz, ky,
    kx, Cin, Cout), 2.x (Cout, kz, ky, kx, Cin): three equal middle axes
    mark 2.x."""
    if w.dim() != 5:
        raise ValueError(f"not a sparse conv weight: shape {tuple(w.shape)}")
    if w.shape[1] == w.shape[2] == w.shape[3]:
        w = w.movedim(0, -1)
    return w.permute(4, 3, 2, 1, 0).contiguous()


def parta2_head_mapping(shared_fc: int = 3, cls_fc: int = 2, reg_fc: int = 2,
                        ours_prefix="roi_head", ref_prefix="roi_head") -> Mapping:
    """PartA2FCHead (partA2_head.py:15-58): the conv_part / conv_rpn
    submanifold stacks (two post_act_blocks each: conv, BN), the Conv1d
    SHARED_FC tower and the make_fc_layers cls / reg stacks; the arguments
    are the towers' depths."""
    m: Mapping = {}
    for stream, ref_name in (("part", "conv_part"), ("rpn", "conv_rpn")):
        for blk in range(2):
            base = f"{ref_prefix}.{ref_name}.{blk}.0"
            m[f"{ours_prefix}.{stream}{blk}_conv.weight"] = (f"{base}.0.weight", t_spconv_dense)
            _bn(m, f"{ours_prefix}.{stream}{blk}_bn", f"{base}.1")
    _fc_between(m, f"{ours_prefix}.shared_fc", f"{ref_prefix}.shared_fc_layer", shared_fc)
    _fc_make(m, f"{ours_prefix}.cls_fc", f"{ref_prefix}.cls_layers", cls_fc)
    _fc_make(m, f"{ours_prefix}.reg_fc", f"{ref_prefix}.reg_layers", reg_fc)
    return m


def apply_mapping(own: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
                  mapping: Mapping):
    """Overlay reference tensors onto a port state_dict. Returns (new
    state_dict, report) where the report lists "converted" and
    "missing_in_torch" reference keys (a multi-source entry is reported by
    its first key) and "unmatched_ours", the port keys outside the mapping;
    those and the keys whose source is missing keep their values."""
    new = dict(own)
    converted, missing = [], []
    for ours, (ref_key, transform) in mapping.items():
        if ours not in own:
            continue  # the mapping covers alternatives (deblock Conv vs ConvT)
        if isinstance(ref_key, tuple):
            absent = [r for r in ref_key if r not in state]
            if absent:
                missing.extend(absent)
                continue
            w = transform([state[r] for r in ref_key])
            ref_key = ref_key[0]
        elif ref_key not in state:
            missing.append(ref_key)
            continue
        else:
            w = transform(state[ref_key])
        tgt = own[ours]
        if tuple(w.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {ours} <- {ref_key}: "
                             f"{tuple(w.shape)} vs {tuple(tgt.shape)}")
        new[ours] = w.to(dtype=tgt.dtype, device=tgt.device)
        converted.append(ref_key)
    report = {"converted": converted, "missing_in_torch": missing,
              "unmatched_ours": [k for k in own if k not in mapping]}
    return new, report


def load_reference_state(model, state, logger=None) -> dict:
    """Overlay a reference model_state (key → tensor) onto `model` in place
    through the mapping its `reference_mapping()` gives. Raises when no key converts: the
    checkpoint is for another model. Logs the report's counts to `logger`
    (default: this module's), as a warning when the overlay is partial, and
    returns it."""
    new, report = apply_mapping(model.state_dict(), state, model.reference_mapping())
    if not report["converted"]:
        raise ValueError("no key of the reference checkpoint converts onto this model "
                         f"({len(state)} keys, {len(report['missing_in_torch'])} missing); "
                         "is it a checkpoint of another model?")
    model.load_state_dict(new)
    partial = report["missing_in_torch"] or report["unmatched_ours"]
    (logger or logging.getLogger(__name__)).log(
        logging.WARNING if partial else logging.INFO,
        f"reference checkpoint: {len(report['converted'])} keys converted, "
        f"{len(report['missing_in_torch'])} missing and "
        f"{len(report['unmatched_ours'])} of the model's unmatched "
        "(those keep their values)")
    return report
