"""Reference (OpenPCDet / DFU3D) checkpoints onto the port's flagship,
PointRCNN and the anchor detectors (own copy of the JAX package's
train/torch_convert.py: `pfn_mapping`, `centerpoint_pillar_mapping` with
the per-tower SeparateHead keys (`separate_heads_mapping`),
`bev_res_backbone_mapping`, `anchor_head_mapping`, `point_head_box_mapping`,
`pointrcnn_head_mapping`, `second_head_mapping`, `voxelrcnn_head_mapping`,
`pvrcnn_head_mapping`,
`parta2_head_mapping` with `t_spconv_dense`, `transfusion_head_mapping`
with `_mha` and `_ln`, `dsvt_mapping` and `dsvt_voxel_mapping`, the camera
branch's `swin_mapping` (with `_patchmerge_perm`), `lss_fpn_mapping` and
`deeplab_ddn_mapping`, and `apply_mapping`'s partial overlay, :50-166,
:167-297, :300-394, :397-451, :424-505, :513-604, :639-789, :900-957,
:959-1029).

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
    MultiheadAttention  the packed in_proj_weight (3C, C) and in_proj_bias
                        (3C,) split in three: query, key, value Linears
                        (DSVT's q, k, v)
    LayerNorm           identity: weight, bias
    Swin PatchMerging   norm and reduction: the input channels permuted
                        from the reference's Unfold order to the port's
                        [x00, x10, x01, x11] blocks

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
JAX package maps no PV-RCNN++ head), the 2D backbone's and
TransFusionHead's for TransFusion, and for a DSVT CenterPoint the VFE's PFN
layers, the DSVT trunk's, the 2D backbone's and the CenterHead's. The JAX
package has no PointNet2MSG, sparse-backbone or AnchorHeadMulti mapping, so
neither has the port: those modules keep their values and are reported
unmatched.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, Dict, Tuple

import torch

__all__ = ["is_reference_state", "centerpoint_pillar_mapping", "pfn_mapping",
           "bev_backbone_mapping", "bev_res_backbone_mapping", "separate_heads_mapping",
           "anchor_head_mapping", "point_head_box_mapping",
           "pointrcnn_head_mapping", "second_head_mapping", "voxelrcnn_head_mapping",
           "pvrcnn_head_mapping", "parta2_head_mapping", "t_spconv_dense",
           "transfusion_head_mapping", "dsvt_mapping", "dsvt_voxel_mapping", "swin_mapping",
           "lss_fpn_mapping", "deeplab_ddn_mapping", "apply_mapping", "load_reference_state"]

# reference module paths that no port state_dict key contains
_REFERENCE_KEY = re.compile(r"(^|\.)(pfn_layers|blocks|deblocks|heads_list|cls_layers|box_layers"
                            r"|reg_layers|xyz_up_layer|merge_down_layer|SA_modules|FP_modules"
                            r"|iou_layers|shared_fc_layer|cls_fc_layers|reg_fc_layers"
                            r"|roi_grid_pool_layers|conv_part|conv_rpn|heatmap_head"
                            r"|position_embedding_head)"
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


def anchor_head_mapping(use_dir: bool = True, prefix: str = "dense_head",
                        use_iou: bool = False) -> Mapping:
    """AnchorHeadSingle (anchor_head_single.py:10-74): the 1×1 conv_cls,
    conv_box and conv_dir_cls (and SECONDNetIoU's conv_iou with `use_iou`),
    OIHW on both sides. The per-location anchor
    order is the reference's (class-major, size-major, rotation-minor), so
    the channels line up (the JAX package's anchor_head_mapping,
    :378-394)."""
    m: Mapping = {}
    for name in (["conv_cls", "conv_box"] + (["conv_dir_cls"] if use_dir else [])
                 + (["conv_iou"] if use_iou else [])):
        _conv(m, f"{prefix}.{name}", f"{prefix}.{name}", bias=True)
    return m


def centerpoint_pillar_mapping() -> Mapping:
    """Port state_dict key → (reference key, or a tuple of them, transform)
    for the flagship CenterPoint-pillar (DynamicPillarVFE + BaseBEVBackbone +
    CenterHead), in the JAX package's entry order."""
    branch_specs = tuple((h, name, oc) for h, hm in enumerate(HM_COUNTS)
                         for name, oc in BRANCHES + (("hm", hm),))
    return {**pfn_mapping(NUM_PFN), **bev_backbone_mapping(LAYER_NUMS),
            **center_head_mapping(branch_specs)}


def center_head_mapping(branch_specs) -> Mapping:
    """CenterHead (center_head.py) with towers of one hidden conv: the shared
    conv and, in the port's fused layout (models/center_head.
    FusedSeparateHeads, `branch_specs` its (head, branch, out channels) in
    param order), the towers' tensors concatenated along output channels,
    the out convs padded to the widest branch."""
    m: Mapping = {}
    _conv(m, "dense_head.shared_conv.layers_0", "dense_head.shared_conv.0", bias=True)
    _bn(m, "dense_head.shared_bn", "dense_head.shared_conv.1")
    specs = [(f"dense_head.heads_list.{h}.{name}", oc) for h, name, oc in branch_specs]
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


def separate_heads_mapping(head_dicts) -> Mapping:
    """CenterHead with per-tower SeparateHeads (towers of different depths;
    `head_dicts` per head its {branch: (out_channels, num_conv)}): the
    shared conv, then per head h and branch each hidden conv + BN
    (heads_list.{h}.{branch}.{k}.0 / .1) and the out conv
    (heads_list.{h}.{branch}.{num_conv - 1}), the reference SeparateHead's
    Sequential (center_head.py:12-47; the JAX package's per-tower keys,
    :341-349, at num_conv 2)."""
    m: Mapping = {}
    _conv(m, "dense_head.shared_conv.layers_0", "dense_head.shared_conv.0", bias=True)
    _bn(m, "dense_head.shared_bn", "dense_head.shared_conv.1")
    for h, hd in enumerate(head_dicts):
        for name, (_, num_conv) in hd.items():
            ours, ref = f"dense_head.head_{h}.{name}", f"dense_head.heads_list.{h}.{name}"
            for k in range(num_conv - 1):
                _conv(m, f"{ours}_conv{k}", f"{ref}.{k}.0", bias=True)
                _bn(m, f"{ours}_bn{k}", f"{ref}.{k}.1")
            _conv(m, f"{ours}_out", f"{ref}.{num_conv - 1}", bias=True)
    return m


def _res_block(m, ours, ref, downsample=False):
    """The reference BasicBlock (base_bev_backbone.py:207-249) → ResConvBlock."""
    _conv(m, f"{ours}.Conv_0", f"{ref}.conv1")
    _bn(m, f"{ours}.BatchNorm_0", f"{ref}.bn1")
    _conv(m, f"{ours}.Conv_1", f"{ref}.conv2")
    _bn(m, f"{ours}.BatchNorm_1", f"{ref}.bn2")
    if downsample:
        _conv(m, f"{ours}.shortcut", f"{ref}.downsample_layer.0")
        _bn(m, f"{ours}.shortcut_bn", f"{ref}.downsample_layer.1")


def bev_res_backbone_mapping(layer_nums) -> Mapping:
    """BaseBEVResBackbone (base_bev_backbone.py:252-330, the JAX package's
    bev_res_backbone_mapping, :813-828): blocks.{i} = [BasicBlock with a
    downsample layer, BasicBlock × layer_nums[i]]; deblocks.{i} =
    [ConvT|Conv, BN, ReLU]."""
    m: Mapping = {}
    for i, n in enumerate(layer_nums):
        _res_block(m, f"backbone_2d.block{i}_down", f"backbone_2d.blocks.{i}.0", downsample=True)
        for j in range(n):
            _res_block(m, f"backbone_2d.block{i}_res{j}", f"backbone_2d.blocks.{i}.{j + 1}")
        m[f"backbone_2d.deblock{i}.ConvTranspose_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        m[f"backbone_2d.deblock{i}.Conv_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        _bn(m, f"backbone_2d.deblock{i}.BatchNorm_0", f"backbone_2d.deblocks.{i}.1")
    return m


def bev_v1_backbone_mapping(layer_nums) -> Mapping:
    """BaseBEVBackboneV1 (base_bev_backbone.py:115-204, the JAX package's
    bev_v1_backbone_mapping): blocks.{i} = [ZeroPad, Conv, BN, ReLU,
    (Conv, BN, ReLU) × layer_nums[i]]; deblocks.{i} = [ConvT|Conv, BN,
    ReLU]."""
    m: Mapping = {}
    for i, n in enumerate(layer_nums):
        _conv(m, f"backbone_2d.block{i}_in.Conv_0", f"backbone_2d.blocks.{i}.1")
        _bn(m, f"backbone_2d.block{i}_in.BatchNorm_0", f"backbone_2d.blocks.{i}.2")
        for j in range(n):
            _conv(m, f"backbone_2d.block{i}_conv{j}.Conv_0", f"backbone_2d.blocks.{i}.{4 + 3 * j}")
            _bn(m, f"backbone_2d.block{i}_conv{j}.BatchNorm_0",
                f"backbone_2d.blocks.{i}.{5 + 3 * j}")
        m[f"backbone_2d.deblock{i}.ConvTranspose_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        m[f"backbone_2d.deblock{i}.Conv_0.weight"] = (
            f"backbone_2d.deblocks.{i}.0.weight", t_identity)
        _bn(m, f"backbone_2d.deblock{i}.BatchNorm_0", f"backbone_2d.deblocks.{i}.1")
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


def _t_in_proj(part):
    def f(w):
        c = w.shape[0] // 3
        return w[part * c:(part + 1) * c]
    return f


def _mha(m, ours, ref):
    """torch nn.MultiheadAttention (packed in_proj) → the port's query, key,
    value and out Linears."""
    for part, name in enumerate(("query", "key", "value")):
        m[f"{ours}.{name}.weight"] = (f"{ref}.in_proj_weight", _t_in_proj(part))
        m[f"{ours}.{name}.bias"] = (f"{ref}.in_proj_bias", _t_in_proj(part))
    _conv(m, f"{ours}.out", f"{ref}.out_proj", bias=True)


def _ln(m, ours, ref):
    _conv(m, ours, ref, bias=True)


def _fc(m, ours, ref):
    """A Conv1d(k=1) with bias → the port's Linear."""
    m[f"{ours}.weight"] = (f"{ref}.weight", t_fc)
    m[f"{ours}.bias"] = (f"{ref}.bias", t_identity)


def transfusion_head_mapping(num_conv: int = 2, num_hm_conv: int = 2, use_vel: bool = False,
                             prefix: str = "dense_head") -> Mapping:
    """TransFusionHead (reference transfusion_head.py:53-123,
    transfusion_utils.py:10-101): shared_conv, heatmap_head (BasicBlock2D +
    conv), class_encoding, the decoder layer (position embeddings, the two
    attentions, norm1-3, linear1-2) and the SeparateHead_Transfusion stacks
    of Conv1d(k=1)."""
    m: Mapping = {}
    p = prefix
    _conv(m, f"{p}.shared_conv", f"{p}.shared_conv", bias=True)
    _conv(m, f"{p}.hm_conv", f"{p}.heatmap_head.0.conv", bias=True)
    _bn(m, f"{p}.hm_bn", f"{p}.heatmap_head.0.bn")
    _conv(m, f"{p}.hm_out", f"{p}.heatmap_head.1", bias=True)
    _fc(m, f"{p}.class_encoding", f"{p}.class_encoding")
    for pe in ("self_posembed", "cross_posembed"):
        base = f"{p}.decoder.{pe}.position_embedding_head"
        _fc(m, f"{p}.{pe}.dense_0", f"{base}.0")
        _bn(m, f"{p}.{pe}.bn", f"{base}.1")
        _fc(m, f"{p}.{pe}.dense_1", f"{base}.3")
    _mha(m, f"{p}.self_attn", f"{p}.decoder.self_attn")
    _mha(m, f"{p}.cross_attn", f"{p}.decoder.multihead_attn")
    for i in (1, 2, 3):
        _ln(m, f"{p}.norm{i}", f"{p}.decoder.norm{i}")
    for name in ("linear1", "linear2"):
        _conv(m, f"{p}.{name}", f"{p}.decoder.{name}", bias=True)
    branches = [(n, num_conv) for n in ("center", "height", "dim", "rot")]
    if use_vel:
        branches.append(("vel", num_conv))
    for name, nc in branches + [("heatmap", num_hm_conv)]:
        base = f"{p}.prediction_head.{name}"
        for i in range(nc - 1):
            _fc(m, f"{p}.{name}_conv{i}", f"{base}.{i}.0")
            _bn(m, f"{p}.{name}_bn{i}", f"{base}.{i}.1")
        _fc(m, f"{p}.{name}_out", f"{base}.{nc - 1}")
    return m


def _dsvt_layer(m, ours, base, pos_head):
    """One DSVT encoder layer (the JAX package's _dsvt_layer_entries): the
    window attention's packed in_proj split into q / k / v, out_proj,
    linear1 / linear2, norm1 / norm2 and the encoder layer's outer norm,
    and its PositionEmbeddingLearned (Linear, BN1d, ReLU, Linear)."""
    attn = f"{base}.win_attn.self_attn"
    for part, name in enumerate(("q", "k", "v")):
        m[f"{ours}.{name}.weight"] = (f"{attn}.in_proj_weight", _t_in_proj(part))
        m[f"{ours}.{name}.bias"] = (f"{attn}.in_proj_bias", _t_in_proj(part))
    _conv(m, f"{ours}.proj", f"{attn}.out_proj", bias=True)
    _conv(m, f"{ours}.ffn1", f"{base}.win_attn.linear1", bias=True)
    _conv(m, f"{ours}.ffn2", f"{base}.win_attn.linear2", bias=True)
    _ln(m, f"{ours}.ln1", f"{base}.win_attn.norm1")
    _ln(m, f"{ours}.ln2", f"{base}.win_attn.norm2")
    _ln(m, f"{ours}.ln3", f"{base}.norm")
    _conv(m, f"{ours}_pos_fc1", f"{pos_head}.0", bias=True)
    _bn(m, f"{ours}_pos_bn", f"{pos_head}.1")
    _conv(m, f"{ours}_pos_fc2", f"{pos_head}.3", bias=True)


def dsvt_mapping(num_blocks: int = 4, prefix: str = "backbone_3d") -> Mapping:
    """The pillar DSVT (reference dsvt.py, one stage): per block its two
    encoder layers (stage_0.{blk}.encoder_list.{li}), their position
    embeddings (input_layer.posembed_layers.0.{blk}.{li}) and
    residual_norm_stage_0.{blk}."""
    m: Mapping = {}
    p = prefix
    for blk in range(num_blocks):
        for li in range(2):
            _dsvt_layer(m, f"{p}.block{blk}_{li}", f"{p}.stage_0.{blk}.encoder_list.{li}",
                        f"{p}.input_layer.posembed_layers.0.{blk}.{li}.position_embedding_head")
        _ln(m, f"{p}.res_norm{blk}", f"{p}.residual_norm_stage_0.{blk}")
    return m


def dsvt_voxel_mapping(set_info=((48, 1),) * 4, prefix: str = "backbone_3d") -> Mapping:
    """The multi-stage DSVT (dsvt_voxel.yaml): per stage its blocks as in
    `dsvt_mapping` and, between stages, Stage_ReductionAtt_Block
    (stage_{s}_reduction: the packed in_proj, out_proj, norm and the raw
    pos_embedding)."""
    m: Mapping = {}
    p = prefix
    for s, (_, num_blocks) in enumerate(set_info):
        for blk in range(num_blocks):
            for li in range(2):
                _dsvt_layer(m, f"{p}.stage{s}_block{blk}_{li}",
                            f"{p}.stage_{s}.{blk}.encoder_list.{li}",
                            f"{p}.input_layer.posembed_layers.{s}.{blk}.{li}"
                            ".position_embedding_head")
            _ln(m, f"{p}.stage{s}_res_norm{blk}", f"{p}.residual_norm_stage_{s}.{blk}")
        if s < len(set_info) - 1:
            ours, ref = f"{p}.stage{s}_reduction", f"{p}.stage_{s}_reduction"
            for part, name in enumerate(("q", "k", "v")):
                m[f"{ours}.{name}.weight"] = (f"{ref}.self_attn.in_proj_weight", _t_in_proj(part))
                m[f"{ours}.{name}.bias"] = (f"{ref}.self_attn.in_proj_bias", _t_in_proj(part))
            _conv(m, f"{ours}.proj", f"{ref}.self_attn.out_proj", bias=True)
            _ln(m, f"{ours}.norm", f"{ref}.norm")
            m[f"{ours}.pos_embedding"] = (f"{ref}.pos_embedding", t_identity)
    return m


def _patchmerge_perm(c4: int) -> torch.Tensor:
    """The reference PatchMerging's input order (nn.Unfold: channel-major,
    index c · 4 + kh · 2 + kw) read in the port's ([x00, x10, x01, x11]
    blocks of C): port[o] = reference[perm[o]]."""
    c = c4 // 4
    kidx = (0, 2, 1, 3)   # block g → kh · 2 + kw
    return torch.tensor([ci * 4 + kidx[g] for g in range(4) for ci in range(c)])


def t_merge_norm(w):
    return w[_patchmerge_perm(w.shape[0])]


def t_merge_reduction(w):
    """Reference Linear (2C, 4C) → the port's, its input columns permuted."""
    return w[:, _patchmerge_perm(w.shape[1])]


def swin_mapping(depths=(2, 2, 6, 2), out_indices=(1, 2, 3),
                 prefix: str = "image_backbone") -> Mapping:
    """SwinTransformer (the reference's mmdet layout, backbones_image/
    swin.py): patch_embed.projection / norm, per block norm1 / norm2, the
    window attention's relative_position_bias_table, qkv and proj
    (attn.w_msa), the FFN (ffn.layers.0.0, ffn.layers.1), the stages'
    norm{i}, and PatchMerging (downsample.norm / reduction) with its input
    order permuted (`_patchmerge_perm`)."""
    m: Mapping = {}
    p = prefix
    _conv(m, f"{p}.patch_embed", f"{p}.patch_embed.projection", bias=True)
    _ln(m, f"{p}.patch_norm", f"{p}.patch_embed.norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            blk, ref = f"{p}.stage{i}_block{j}", f"{p}.stages.{i}.blocks.{j}"
            _ln(m, f"{blk}.norm1", f"{ref}.norm1")
            _ln(m, f"{blk}.norm2", f"{ref}.norm2")
            m[f"{blk}.attn.relative_position_bias_table"] = (
                f"{ref}.attn.w_msa.relative_position_bias_table", t_identity)
            _conv(m, f"{blk}.attn.qkv", f"{ref}.attn.w_msa.qkv", bias=True)
            _conv(m, f"{blk}.attn.proj", f"{ref}.attn.w_msa.proj", bias=True)
            _conv(m, f"{blk}.mlp_fc1", f"{ref}.ffn.layers.0.0", bias=True)
            _conv(m, f"{blk}.mlp_fc2", f"{ref}.ffn.layers.1", bias=True)
        if i in out_indices:
            _ln(m, f"{p}.out_norm{i}", f"{p}.norm{i}")
        if i < len(depths) - 1:
            ref = f"{p}.stages.{i}.downsample"
            m[f"{p}.merge{i}.norm.weight"] = (f"{ref}.norm.weight", t_merge_norm)
            m[f"{p}.merge{i}.norm.bias"] = (f"{ref}.norm.bias", t_merge_norm)
            m[f"{p}.merge{i}.reduction.weight"] = (f"{ref}.reduction.weight", t_merge_reduction)
    return m


def lss_fpn_mapping(num_levels: int = 3, prefix: str = "image_neck") -> Mapping:
    """GeneralizedLSSFPN (generalized_lss.py): lateral_convs / fpn_convs,
    each a conv + BN, for the num_levels - 1 processed levels."""
    m: Mapping = {}
    for i in range(num_levels - 1):
        _conv(m, f"{prefix}.lateral{i}", f"{prefix}.lateral_convs.{i}.conv")
        _bn(m, f"{prefix}.lateral_bn{i}", f"{prefix}.lateral_convs.{i}.bn")
        _conv(m, f"{prefix}.fpn{i}", f"{prefix}.fpn_convs.{i}.conv")
        _bn(m, f"{prefix}.fpn_bn{i}", f"{prefix}.fpn_convs.{i}.bn")
    return m


def deeplab_ddn_mapping(layers=(3, 4, 23, 3), prefix: str = "", torch_prefix: str = "") -> Mapping:
    """DDNDeepLabV3 from torchvision's deeplabv3_resnet50 / 101 layout
    (backbone.conv1 / bn1 / layer{L}.{i}, classifier.0 the ASPP,
    classifier.1 / 2 the head's conv and BN, classifier.4 the logits);
    `prefix` the port's module path ("ddn." in CaDDN), `torch_prefix` the
    reference's ("vfe.ffn.ddn.model." in a CaDDN checkpoint)."""
    m: Mapping = {}
    op, tp = prefix, torch_prefix
    _conv(m, f"{op}conv1", f"{tp}backbone.conv1")
    _bn(m, f"{op}bn1", f"{tp}backbone.bn1")
    for li, n in enumerate(layers, start=1):
        for i in range(n):
            blk, ref = f"{op}layer{li}_{i}", f"{tp}backbone.layer{li}.{i}"
            for c in ("conv1", "conv2", "conv3"):
                _conv(m, f"{blk}.{c}", f"{ref}.{c}")
            for b in ("bn1", "bn2", "bn3"):
                _bn(m, f"{blk}.{b}", f"{ref}.{b}")
            if i == 0:   # every torchvision layer's first block downsamples
                _conv(m, f"{blk}.down_conv", f"{ref}.downsample.0")
                _bn(m, f"{blk}.down_bn", f"{ref}.downsample.1")
    aspp, ref = f"{op}aspp", f"{tp}classifier.0"
    for j in range(4):
        _conv(m, f"{aspp}.aspp_conv{j}", f"{ref}.convs.{j}.0")
        _bn(m, f"{aspp}.aspp_bn{j}", f"{ref}.convs.{j}.1")
    _conv(m, f"{aspp}.aspp_pool_conv", f"{ref}.convs.4.1")
    _bn(m, f"{aspp}.aspp_pool_bn", f"{ref}.convs.4.2")
    _conv(m, f"{aspp}.aspp_project", f"{ref}.project.0")
    _bn(m, f"{aspp}.aspp_project_bn", f"{ref}.project.1")
    _conv(m, f"{op}head_conv", f"{tp}classifier.1")
    _bn(m, f"{op}head_bn", f"{tp}classifier.2")
    _conv(m, f"{op}head_out", f"{tp}classifier.4", bias=True)
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
