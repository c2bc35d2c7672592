"""The flagship configuration, CenterPoint-pillar on
tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml, as
`__graft_entry__._flagship` builds it for the JAX package: full widths on the
config's 256 × 512 BEV grid, or on a 64 × 128 grid with `tiny=True`."""
from __future__ import annotations

import math
import re
from pathlib import Path

import torch

from .core.voxel import VoxelGrid
from .models import build_network
from .utils.config import CfgDict, cfg_from_yaml_file

FLAGSHIP_CFG = (Path(__file__).resolve().parents[1]
                / "tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml")
TINY_RANGE = [0.0, -12.8, -5.0, 12.8, 12.8, 3.0]
VOXEL_SIZE = [0.2, 0.2, 8.0]
# seeded_weights_ gains, by state_dict key (keys a model lacks are unused)
GAINS = {"vfe.pfn_0.Dense_0.weight": 1 / math.sqrt(170.0),
         "dense_head.fused_heads.out.weight": 0.4,
         "backbone_3d.conv_input.SubMConv3d_0.kernel": 4.0,
         "dense_head.conv_box.weight": 0.1,
         "roi_head.jointembed.fc3.weight": 0.1}
# biases that do not start at 0, by state_dict key
BIASES = {"dense_head.conv_iou.bias": 1.0}
# and by pattern: the per-group output layers of VoxelNeXt and of
# CenterHead's per-tower SeparateHeads, the heat map's and the box
# regressions' (not the IoU branch's); TransFusion's box regressions
PATTERN_GAINS = ((re.compile(r"head_\d+\.hm_out\.weight$"), 0.1),
                 (re.compile(r"head_\d+\.(center|center_z|dim|rot|vel)_out\.weight$"), 0.01),
                 (re.compile(r"dense_head\.(center|height|dim|rot|vel)_out\.weight$"), 0.1))


def _gain(key):
    return GAINS.get(key) or next((g for pat, g in PATTERN_GAINS if pat.search(key)), 1.0)


def flagship(tiny: bool = False, device="cuda", train: bool = False):
    """Returns (cfg, grid, model), in train mode with `train`; the model's
    weights are PyTorch's defaults."""
    cfg = cfg_from_yaml_file(FLAGSHIP_CFG, CfgDict())
    if tiny:
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(TINY_RANGE)
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, VOXEL_SIZE)
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=train)
    return cfg, grid, model


def seeded_weights_(model, seed: int):
    """Random weights for benchmarks, from a seeded torch.Generator: He-normal
    kernels, zero biases, BN at identity. The first PFN layer is scaled for
    inputs in metres (mean square ≈ 170 per channel at a 50 m extent) and the
    head's fused out conv by 0.4, so the logits stay O(1); the heat-map bias is 0,
    so the top-K scores sit far above SCORE_THRESH 0.1 instead of at
    sigmoid(-2.19) ≈ 0.1006 where float noise would flip them. Sparse conv
    kernels (K, Cin, Cout) have fan-in K · Cin; on the benchmark's uniform
    points a voxel has about one live tap of 27, so the voxel model's
    conv_input is scaled up by 4, which brings its kept scores to about the
    pillar model's (median ≈ 0.57) without saturating them. AnchorHeadSingle's
    box conv (the KITTI anchor RPNs) is scaled by 0.1, as the CPU parity tests
    set it: at full scale its codes decode to boxes e^10 times an anchor's
    size, tens of metres off, and gt made of such proposals
    (`zoo.proposal_gt`) put the RPN's box loss at 1e7 and beyond.
    VoxelNeXt's output layers are scaled too, and CenterHead's per-tower
    ones (head_{h}.{branch}_out) alike, the box regressions' by 0.01 and the
    heat map's by 0.1: at full scale the exp of their dims decodes
    boxes kilometres wide, whose overlaps fp32 cannot hold (the kernel and
    its twin then differ by 1e6 m²), and at 0.1 to 0.03 the boxes from 31
    sparse convs still carry 1e-4 of fp32 rounding between two summation
    orders; the heat-map logits stay below saturation. The IoU branch keeps
    its He scale: its tanh near 0 would rectify every score below
    SCORE_THRESH. TransFusion's box regressions are scaled by 0.1: at full
    scale their dims run up to the clip, exp(5) ≈ 148 m, where the
    relative rounding of two summation orders, times the exp, nears the
    1e-4 m to which the fp32 checks hold the boxes. MPPNet's joint
    regression's out layer is scaled by 0.1 for the same reason (its codes
    decode to sizes e^code times the RoI's). MPPNet's group tokens,
    zeros at init (as the JAX package and the reference make them), are
    drawn N(0, 1): a zero token gives the first encoder layer's query
    projection a gradient of exactly 0. The anchor head's IoU output
    (USE_IOU_HEAD) starts at a bias of 1: on the BEV cells without points
    its logit is the bias, and at 0 the rectified score
    score^0.32 · max(tanh(logit), 1e-4)^0.68 puts every anchor below
    SCORE_THRESH, so the NMS would have no candidate."""
    gen = torch.Generator().manual_seed(seed)
    state = model.state_dict()
    for key, v in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel" and v.dim() == 3:
            std = math.sqrt(2.0 / (v.shape[0] * v.shape[1])) * _gain(key)
            state[key] = torch.randn(v.shape, generator=gen) * std
        elif leaf == "weight" and v.dim() >= 2:
            fan_in = v.shape[0] if "ConvTranspose" in key else v[0].numel()
            std = math.sqrt(2.0 / fan_in) * _gain(key)
            state[key] = torch.randn(v.shape, generator=gen) * std
        elif leaf == "bias":
            state[key] = torch.full_like(v, BIASES.get(key, 0.0))
        elif leaf == "token":
            state[key] = torch.randn(v.shape, generator=gen)
    model.load_state_dict(state)


@torch.no_grad()
def calibrate_bn_(model, batch):
    """Every BN layer's running mean set to its batch mean on `batch` and
    its running variance to the batch variance floored at 1 (one train-mode
    pass of `model.features`, each layer seeing the normalised output of
    the layers before it), then eval mode. Seeded weights leave BN at
    identity, which in eval mode normalises nothing: on nuScenes points
    (intensities up to 255) VoxelNeXt's regressions then reach 1e3 and
    their exp overflows. The floor keeps a near-constant channel from
    scaling up what lies within rounding: with its own variance (down to
    eps) every such layer multiplies the fp32 difference of two summation
    orders by up to eps^-1/2, and PillarNet's dense stages chain a dozen.
    The weights are not changed."""
    bns = [m for m in model.modules() if hasattr(m, "keep") and hasattr(m, "running_mean")]
    keeps = [m.keep for m in bns]
    for m in bns:
        m.keep = 0.0
    try:
        model.train()
        model.features(batch.to(next(model.parameters()).device))
    finally:
        for m, k in zip(bns, keeps):
            m.keep = k
            m.running_var.clamp_(min=1.0)
        model.eval()
