"""The flagship configuration, CenterPoint-pillar on
tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml, as
`__graft_entry__._flagship` builds it for the JAX package: full widths on the
config's 256 × 512 BEV grid, or on a 64 × 128 grid with `tiny=True`."""
from __future__ import annotations

import math
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
         "dense_head.conv_box.weight": 0.1}


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
    head's out conv by 0.4, so the logits stay O(1); the heat-map bias is 0,
    so the top-K scores sit far above SCORE_THRESH 0.1 instead of at
    sigmoid(-2.19) ≈ 0.1006 where float noise would flip them. Sparse conv
    kernels (K, Cin, Cout) have fan-in K · Cin; on the benchmark's uniform
    points a voxel has about one live tap of 27, so the voxel model's
    conv_input is scaled up by 4, which brings its kept scores to about the
    pillar model's (median ≈ 0.57) without saturating them. AnchorHeadSingle's
    box conv (the KITTI anchor RPNs) is scaled by 0.1, as the CPU parity tests
    set it: at full scale its codes decode to boxes e^10 times an anchor's
    size, tens of metres off, and gt made of such proposals
    (`zoo.proposal_gt`) put the RPN's box loss at 1e7 and beyond."""
    gen = torch.Generator().manual_seed(seed)
    state = model.state_dict()
    for key, v in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel" and v.dim() == 3:
            std = math.sqrt(2.0 / (v.shape[0] * v.shape[1])) * GAINS.get(key, 1.0)
            state[key] = torch.randn(v.shape, generator=gen) * std
        elif leaf == "weight" and v.dim() >= 2:
            fan_in = v.shape[0] if "ConvTranspose" in key else v[0].numel()
            std = math.sqrt(2.0 / fan_in) * GAINS.get(key, 1.0)
            state[key] = torch.randn(v.shape, generator=gen) * std
        elif leaf == "bias":
            state[key] = torch.zeros_like(v)
    model.load_state_dict(state)
