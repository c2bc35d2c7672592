"""The RoI head template (port of dfu3d_tpu/models/roi_head.py, itself the
reference's roi_heads/roi_head_template.py and
target_assigner/proposal_target_layer.py):

- `resolve_nms_cfg`          — NMS_CONFIG.TRAIN/TEST, or the flat legacy keys;
- `proposal_layer`           — class-agnostic proposal NMS (roi_head_template.py:45-102);
- `assign_roi_targets`       — the proposal target layer: per-class max-IoU gt
  matching, fg / hard-bg / easy-bg subsampling to ROI_PER_IMAGE, soft or hard
  class labels, and the canonical transform of the matched gt
  (`canonicalize_gt_of_rois`);
- `roi_head_loss`            — BCE (or CE) on the class labels, canonical
  smooth-L1 against RoI-sized anchors and the corner loss
  (roi_head_template.py:136-231);
- `generate_predicted_boxes` — the canonical decode (roi_head_template.py:233-261);
- `final_nms`                — post-processing NMS over the refined boxes;
- `dense_grid_points` / `global_grid_points` — the RoI grid points in the
  reference's order (x slowest, z fastest);
- `FCStack`                  — make_fc_layers (roi_head_template.py:29-43,
  `make_fc_stack`: dropout after block 0 and a biased pred layer) and the
  per-head shared_fc_layer (`shared_fc_stack`: dropout between blocks, no
  pred layer);
- `NeighborVoxelSA`          — Voxel R-CNN's grid pooling from one voxel
  stage (voxel_pool_modules.NeighborVoxelSAModuleMSG, single scale).

Both NMS steps and the RoI targets' 3D IoU take every frame of the batch at
once, so each is one launch of the overlap kernel (B1): (B, N, N) through
`nms_bev`, (B, R, G) through `pairwise_iou3d`.

The subsampler's random draws are an argument: (B, 2, P) uniforms in
[0, 1), one pair of vectors per frame, where JAX draws them from its key
(threefry cannot be reproduced in torch). Sorts are stable throughout, as
jnp.argsort is: their keys tie by the hundred.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.geometry.boxes import boxes_to_corners_3d, rotate_points_along_z
from ..core.geometry.iou import pairwise_iou3d
from ..core.geometry.nms import nms_bev
from .anchor_head import decode_boxes, encode_boxes
from ..core import pointnet2 as P
from .backbone_2d import BatchNorm
from .losses import bce_with_logits
from .vfe import MaskedBatchNorm

PI = 3.141592653589793


def resolve_nms_cfg(roi_cfg, train: bool) -> dict:
    """NMS_CONFIG.TRAIN/TEST (the reference schema), else the flat keys
    NMS_PRE_MAXSIZE / NMS_POST_MAXSIZE / NMS_THRESH of the RoI head."""
    nc = roi_cfg.get("NMS_CONFIG", None)
    if nc is not None and ("TRAIN" in nc or "TEST" in nc):
        phase = nc["TRAIN" if train else "TEST"]
        return dict(pre_max=int(phase.get("NMS_PRE_MAXSIZE", 1024)),
                    post_max=int(phase.get("NMS_POST_MAXSIZE", 128)),
                    thresh=float(phase.get("NMS_THRESH", 0.7)),
                    score_thresh=phase.get("SCORE_THRESH", None))
    return dict(pre_max=int(roi_cfg.get("NMS_PRE_MAXSIZE", 1024)),
                post_max=int(roi_cfg.get("NMS_POST_MAXSIZE",
                                         roi_cfg.get("NMS_POST_MAXSIZE_TEST", 100))),
                thresh=float(roi_cfg.get("NMS_THRESH", 0.7)),
                score_thresh=None)


def dense_grid_points(rois, grid_size: int):
    """rois (..., 7+) → (..., G³, 3) local grid points, x slowest and z
    fastest (get_dense_grid_points, pvrcnn_head.py:123-132: ones(g, g,
    g).nonzero(), then (idx + 0.5) / g · size - size / 2)."""
    g = grid_size
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3).float()
    sizes = rois[..., None, 3:6]
    return (idx + 0.5) / g * sizes - sizes / 2.0


def global_grid_points(rois, grid_size: int):
    """The local grid turned by each RoI's heading and moved to its centre
    (get_global_grid_points_of_roi, pvrcnn_head.py:111-121)."""
    local = dense_grid_points(rois, grid_size)
    return rotate_points_along_z(local, rois[..., 6]) + rois[..., None, 0:3]


def _take(x, sel):
    """x (B, N, ...) rows at sel (B, K) → (B, K, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, sel]


def proposal_layer(batch_boxes, batch_cls, nms_cfg):
    """Decoded first-stage boxes → RoIs.

    batch_boxes (B, N, 7+), batch_cls (B, N, num_class) scores → rois
    (B, P, 7+), roi_scores (B, P), roi_labels (B, P) in 1..K (argmax + 1),
    roi_valid (B, P) bool, P = post_max. Empty slots are zero, as the
    reference's new_zeros buffers."""
    batch_boxes, batch_cls = batch_boxes.detach(), batch_cls.detach()
    scores, labels = batch_cls.max(dim=-1)
    labels = labels + 1
    if nms_cfg.get("score_thresh") is not None:
        scores = torch.where(scores >= nms_cfg["score_thresh"], scores, float("-inf"))
    sel, keep = nms_bev(batch_boxes, scores, nms_cfg["thresh"],
                        pre_max=min(nms_cfg["pre_max"], batch_boxes.shape[1]),
                        post_max=nms_cfg["post_max"])
    rois = torch.where(keep[..., None], _take(batch_boxes, sel), 0.0)
    roi_scores = torch.where(keep, torch.gather(scores, 1, sel), 0.0)
    roi_labels = torch.where(keep, torch.gather(labels, 1, sel), 0)
    return rois, roi_scores, roi_labels, keep


DEFAULT_TARGET_CONFIG = {
    "BOX_CODER": "ResidualCoder",
    "ROI_PER_IMAGE": 128,
    "FG_RATIO": 0.5,
    "SAMPLE_ROI_BY_EACH_CLASS": True,
    "CLS_SCORE_TYPE": "roi_iou",
    "CLS_FG_THRESH": 0.75,
    "CLS_BG_THRESH": 0.25,
    "CLS_BG_THRESH_LO": 0.1,
    "HARD_BG_RATIO": 0.8,
    "REG_FG_THRESH": 0.55,
}

DEFAULT_LOSS_CONFIG = {
    "CLS_LOSS": "BinaryCrossEntropy",
    "REG_LOSS": "smooth-l1",
    "CORNER_LOSS_REGULARIZATION": True,
    "LOSS_WEIGHTS": {
        "rcnn_cls_weight": 1.0,
        "rcnn_reg_weight": 1.0,
        "rcnn_corner_weight": 1.0,
        "code_weights": [1.0] * 7,
    },
}


def roi_head_target_cfg(rh_cfg) -> dict:
    """TARGET_CONFIG with the reference voxel_rcnn_car.yaml defaults filled."""
    out = dict(DEFAULT_TARGET_CONFIG)
    out.update(dict(rh_cfg.get("TARGET_CONFIG", {})))
    return out


def roi_head_loss_cfg(rh_cfg) -> dict:
    """LOSS_CONFIG with the defaults filled, LOSS_WEIGHTS key by key."""
    out = dict(DEFAULT_LOSS_CONFIG)
    given = dict(rh_cfg.get("LOSS_CONFIG", {}))
    lw = dict(out["LOSS_WEIGHTS"])
    lw.update(dict(given.pop("LOSS_WEIGHTS", {})))
    out.update(given)
    out["LOSS_WEIGHTS"] = lw
    return out


def draw_roi_uniforms(generator, shape, device):
    """The proposal target layer's draws, (B, 2, P) uniforms in [0, 1), from
    `generator` (a generator seeded 0 when None, as JAX's PRNGKey(0) when
    no "sampler" rng is given)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, device=device)


def _rank(key):
    """Rank of each entry of (..., n) under a stable ascending sort."""
    order = torch.argsort(key, dim=-1, stable=True)
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels, gt_valid):
    """Per RoI, the largest 3D IoU with a valid gt of its class and that gt's
    index, the first on ties (proposal_target_layer.py:194-228): rois
    (B, R, 7+), roi_labels (B, R), gt_boxes (B, G, 7+), gt_labels and gt_valid
    (B, G) → (B, R) fp32, (B, R) int64. A RoI whose class has no valid gt gets
    0 and 0, as the reference's zeroed buffers."""
    iou = pairwise_iou3d(rois[..., :7], gt_boxes[..., :7])     # (B, R, G), one B1 launch
    mask = (roi_labels[..., :, None] == gt_labels[..., None, :]) & gt_valid[..., None, :]
    max_overlaps = torch.where(mask, iou, 0.0).amax(dim=-1)
    assignment = torch.argmax(torch.where(mask, iou, -1.0), dim=-1)
    return max_overlaps, torch.where(mask.any(dim=-1), assignment, 0)


def _subsample_rois(uniforms, max_overlaps, tcfg):
    """Fixed-size fg / hard-bg / easy-bg sampling (proposal_target_layer.py:
    117-162): uniforms (B, 2, n), max_overlaps (B, n) → (B, M) indices into
    the RoI axis, M = ROI_PER_IMAGE. The first uniform vector ranks the fg,
    the second the bg; the fp32 keys are JAX's, ties included."""
    n = max_overlaps.shape[-1]
    m = int(tcfg["ROI_PER_IMAGE"])
    fg_per_image = int(round(float(tcfg["FG_RATIO"]) * m))
    fg_thresh = min(float(tcfg["REG_FG_THRESH"]), float(tcfg["CLS_FG_THRESH"]))
    lo = float(tcfg["CLS_BG_THRESH_LO"])
    hard_ratio = float(tcfg["HARD_BG_RATIO"])

    is_fg = max_overlaps >= fg_thresh
    is_easy = max_overlaps < lo
    is_hard = (max_overlaps < float(tcfg["REG_FG_THRESH"])) & ~is_easy & ~is_fg
    u, u2 = uniforms[:, 0], uniforms[:, 1]
    inf = torch.tensor(float("inf"), device=u.device)
    big = torch.tensor(1e9, dtype=torch.float32, device=u.device)

    fg_rank = _rank(torch.where(is_fg, u, inf))
    sel_fg = is_fg & (fg_rank < fg_per_image)
    # bg priority: hard and easy interleaved at HARD_BG_RATIO by scaled rank
    hard_rank = _rank(torch.where(is_hard, u2, inf)).float()
    easy_rank = _rank(torch.where(is_easy, u2, inf)).float()
    bg_key = torch.where(is_hard, (hard_rank + 0.5) / max(hard_ratio, 1e-3),
                         torch.where(is_easy, (easy_rank + 0.5) / max(1.0 - hard_ratio, 1e-3),
                                     big))
    # selected fg first, then bg, then the fg beyond FG_RATIO (last resort)
    fg_rank = fg_rank.float()
    order_key = torch.where(sel_fg, fg_rank - 2.0 * big,
                            torch.where(is_fg, 2.0 * big + fg_rank, bg_key))
    order = torch.argsort(order_key, dim=-1, stable=True)

    n_avail = sel_fg.sum(-1) + is_hard.sum(-1) + is_easy.sum(-1)
    # wrap-around refill emulates the reference's sampling with replacement
    # when one side runs out (proposal_target_layer.py:143-155)
    pos = torch.arange(m, device=u.device).expand(max_overlaps.shape[0], m)
    pos = torch.where(pos < n_avail[:, None], pos,
                      torch.remainder(pos, torch.clamp(n_avail, min=1)[:, None]))
    return torch.gather(order, -1, pos)


def assign_roi_targets(uniforms, rois, roi_labels, roi_scores, gt_boxes, gt_valid, tcfg):
    """Sample ROI_PER_IMAGE RoIs of the proposals and build their targets.

    uniforms (B, 2, P) in [0, 1); rois (B, P, 7+), roi_labels (B, P) in 1..K,
    roi_scores (B, P); gt_boxes (B, G, 8+) with the class id last, gt_valid
    (B, G); tcfg from `roi_head_target_cfg`. Returns the reference's
    targets dict: rois (B, M, 7), roi_labels, roi_scores, gt_iou_of_rois,
    gt_of_rois (canonical, (B, M, 8)), gt_of_rois_src, reg_valid_mask,
    rcnn_cls_labels and sampled_idx (B, M) into the proposal axis. No
    gradient flows into any of them."""
    with torch.no_grad():
        gt_labels = gt_boxes[..., -1].to(torch.int64)
        if tcfg.get("SAMPLE_ROI_BY_EACH_CLASS", False):
            overlaps, assignment = max_iou_with_same_class(rois, roi_labels, gt_boxes,
                                                           gt_labels, gt_valid)
        else:
            iou = torch.where(gt_valid[..., None, :],
                              pairwise_iou3d(rois[..., :7], gt_boxes[..., :7]), 0.0)
            overlaps = iou.amax(dim=-1)
            assignment = torch.argmax(torch.where(gt_valid[..., None, :], iou, -1.0), dim=-1)
        sampled = _subsample_rois(uniforms, overlaps, tcfg)
        gt_of = torch.cat([gt_boxes[..., :7], gt_labels[..., None].to(gt_boxes.dtype)], dim=-1)
        s_rois = _take(rois, sampled)[..., :7]
        s_ious = torch.gather(overlaps, 1, sampled)
        gt_of_rois = _take(gt_of, torch.gather(assignment, 1, sampled))

        reg_valid_mask = (s_ious > float(tcfg["REG_FG_THRESH"])).to(torch.int32)
        cls_type = tcfg.get("CLS_SCORE_TYPE", "roi_iou")
        fg_t, bg_t = float(tcfg["CLS_FG_THRESH"]), float(tcfg["CLS_BG_THRESH"])
        if cls_type == "cls":
            cls_labels = (s_ious > fg_t).float()
            cls_labels = torch.where((s_ious > bg_t) & (s_ious < fg_t), -1.0, cls_labels)
        elif cls_type == "roi_iou":
            soft = (s_ious - bg_t) / (fg_t - bg_t)
            cls_labels = torch.where(s_ious > fg_t, 1.0, torch.where(s_ious < bg_t, 0.0, soft))
        else:
            raise NotImplementedError(cls_type)
        return {"rois": s_rois, "roi_labels": torch.gather(roi_labels, 1, sampled),
                "roi_scores": torch.gather(roi_scores, 1, sampled), "gt_iou_of_rois": s_ious,
                "gt_of_rois": canonicalize_gt_of_rois(s_rois, gt_of_rois),
                "gt_of_rois_src": gt_of_rois, "reg_valid_mask": reg_valid_mask,
                "rcnn_cls_labels": cls_labels, "sampled_idx": sampled}


def canonicalize_gt_of_rois(rois, gt_of_rois):
    """The gt in its RoI's frame, its heading flipped by π where it faces
    away and put into [-π/2, π/2] (roi_head_template.py assign_targets:
    113-132). Columns past 7 (the class id) pass through. The floor-mod is
    torch.remainder, as JAX's %."""
    roi_ry = torch.remainder(rois[..., 6], 2 * PI)
    ct = torch.cat([gt_of_rois[..., 0:3] - rois[..., 0:3], gt_of_rois[..., 3:6],
                    (gt_of_rois[..., 6] - roi_ry)[..., None], gt_of_rois[..., 7:]], dim=-1)
    ct = rotate_points_along_z(ct[..., None, :], -roi_ry)[..., 0, :]
    heading = torch.remainder(ct[..., 6], 2 * PI)
    opposite = (heading > PI * 0.5) & (heading < PI * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + PI, 2 * PI), heading)
    heading = torch.where(heading > PI, heading - 2 * PI, heading)
    heading = torch.clamp(heading, -PI / 2, PI / 2)
    return torch.cat([ct[..., :6], heading[..., None], ct[..., 7:]], dim=-1)


def _smooth_l1(diff, beta: float):
    n = diff.abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def _norm(x):
    """The Euclidean norm over the last axis as jnp.linalg.norm sums it."""
    return torch.sqrt((x * x).sum(dim=-1))


def get_corner_loss_lidar(pred_boxes, gt_boxes):
    """(N, 7) × (N, 7) → (N,): the mean over the 8 corners of the smooth-L1
    (β 1) of each corner's distance, to the gt or to the gt turned by π,
    whichever is nearer (loss_utils.py:211-234)."""
    pc = boxes_to_corners_3d(pred_boxes)
    gc = boxes_to_corners_3d(gt_boxes)
    flipped = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + PI, gt_boxes[:, 7:]], dim=-1)
    gcf = boxes_to_corners_3d(flipped)
    dist = torch.minimum(_norm(pc - gc), _norm(pc - gcf))
    return _smooth_l1(dist, 1.0).mean(dim=1)


def roi_cls_loss(rcnn_cls, rcnn_cls_labels, loss_cfg):
    """get_box_cls_layer_loss (roi_head_template.py:200-218): BCE on the
    (soft) labels, or CE, over the RoIs whose label is >= 0."""
    lw = float(loss_cfg["LOSS_WEIGHTS"]["rcnn_cls_weight"])
    kind = loss_cfg.get("CLS_LOSS", "BinaryCrossEntropy")
    labels = rcnn_cls_labels.reshape(-1)
    mask = (labels >= 0).float()
    if kind == "BinaryCrossEntropy":
        per = bce_with_logits(rcnn_cls.reshape(-1), labels)
    elif kind == "CrossEntropy":
        logits = rcnn_cls.reshape(labels.shape[0], -1)
        # JAX's gather clamps an index past the last class to it
        lab = torch.clamp(labels.to(torch.int64), 0, logits.shape[1] - 1)
        per = -torch.log_softmax(logits, dim=-1).gather(1, lab[:, None])[:, 0]
    else:
        raise NotImplementedError(kind)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0) * lw


def roi_reg_loss(rcnn_reg, targets, loss_cfg):
    """get_box_reg_layer_loss (roi_head_template.py:136-198): smooth-L1 (β
    1/9) of the canonical residuals against zero-centred RoI-sized anchors,
    and with CORNER_LOSS_REGULARIZATION the corner loss of the decoded box,
    over the RoIs of reg_valid_mask. Returns (loss, tb).

    The other RoIs enter as a unit box with a zero residual; the reference,
    which indexes the fg RoIs, never reads them. An untrained RPN can
    propose background RoIs so large that their corner distances overflow
    fp32, and the JAX package's mask product (inf · 0) then makes the loss
    and every gradient NaN. Where those terms are finite, the two agree:
    they count 0 and pass no gradient."""
    lw = loss_cfg["LOSS_WEIGHTS"]
    code_w = torch.as_tensor(lw["code_weights"], dtype=torch.float32, device=rcnn_reg.device)
    fg_rows = (targets["reg_valid_mask"].reshape(-1) > 0)[:, None]
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0], device=rcnn_reg.device)
    rois = targets["rois"].reshape(-1, targets["rois"].shape[-1])[:, :7]
    rois = torch.where(fg_rows, rois, unit)
    gt_ct = torch.where(fg_rows, targets["gt_of_rois"][..., :7].reshape(-1, 7), unit)
    gt_src = torch.where(fg_rows, targets["gt_of_rois_src"][..., :7].reshape(-1, 7), unit)
    reg = torch.where(fg_rows, rcnn_reg.reshape(-1, rcnn_reg.shape[-1])[:, :7], 0.0)
    fg = fg_rows[:, 0].float()
    fg_sum = torch.clamp(fg.sum(), min=1.0)

    zeros = torch.zeros_like(rois[:, :3])
    rois_anchor = torch.cat([zeros, rois[:, 3:6], zeros[:, :1]], dim=-1)
    per = _smooth_l1((encode_boxes(gt_ct, rois_anchor) - reg) * code_w, 1.0 / 9.0)
    loss = (per.sum(dim=-1) * fg).sum() / fg_sum * float(lw["rcnn_reg_weight"])
    tb = {"rcnn_loss_reg": loss}
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        boxes = decode_boxes(reg, torch.cat([zeros, rois[:, 3:7]], dim=-1))
        boxes = rotate_points_along_z(boxes[:, None, :], rois[:, 6])[:, 0, :]
        boxes = torch.cat([boxes[:, 0:3] + rois[:, 0:3], boxes[:, 3:]], dim=-1)
        corner = get_corner_loss_lidar(boxes[:, :7], gt_src)
        corner = (corner * fg).sum() / fg_sum * float(lw["rcnn_corner_weight"])
        loss = loss + corner
        tb["rcnn_loss_corner"] = corner
    tb["rcnn_loss_reg_total"] = loss
    return loss, tb


def roi_head_loss(rcnn_cls, rcnn_reg, targets, loss_cfg):
    """get_loss (roi_head_template.py:220-231): (total, tb)."""
    cls_loss = roi_cls_loss(rcnn_cls, targets["rcnn_cls_labels"], loss_cfg)
    reg_loss, tb = roi_reg_loss(rcnn_reg, targets, loss_cfg)
    tb["rcnn_loss_cls"] = cls_loss
    total = cls_loss + reg_loss
    tb["rcnn_loss"] = total
    return total, tb


def generate_predicted_boxes(rois, box_preds):
    """rois (B, N, 7+), box_preds (B, N, code) → (B, N, 7): decoded in the
    RoI's frame, rotated by its heading, shifted to its centre."""
    roi_ry = rois[..., 6]
    roi_xyz = rois[..., 0:3]
    local_rois = torch.cat([torch.zeros_like(roi_xyz), rois[..., 3:7]], dim=-1)
    boxes = decode_boxes(box_preds[..., :7], local_rois)
    boxes = rotate_points_along_z(boxes[..., None, :], roi_ry)[..., 0, :]
    return torch.cat([boxes[..., 0:3] + roi_xyz, boxes[..., 3:]], dim=-1)


def fallback_post_processing(pp_cfg, num_rois: int) -> dict:
    """POST_PROCESSING with an NMS_CONFIG. When the config has none (DFU3D's
    pointrcnn_nuscenes2kitti.yaml), the NMS settings are those the JAX
    package's PointRCNN.predict falls back to when POST_PROCESSING is
    missing altogether (pre 1024, post = the RoI count, IoU 0.1), and the
    config's SCORE_THRESH stays; the JAX package's final_nms raises
    KeyError there instead."""
    if pp_cfg is not None and "NMS_CONFIG" in pp_cfg:
        return pp_cfg
    return {"SCORE_THRESH": float((pp_cfg or {}).get("SCORE_THRESH", 0.1)),
            "NMS_CONFIG": {"NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": num_rois,
                           "NMS_THRESH": 0.1}}


def final_nms(boxes, scores, labels, valid, pp_cfg):
    """Class-agnostic NMS over the refined boxes (the default path of
    detector3d_template.post_processing). Returns (boxes, scores, labels,
    keep), each (B, post_max, ...); scores are 0 in empty slots."""
    nms_cfg = pp_cfg["NMS_CONFIG"]
    score_thresh = float(pp_cfg.get("SCORE_THRESH", 0.1))
    live = valid & (scores >= score_thresh)
    sel, keep = nms_bev(boxes, torch.where(live, scores, 0.0), float(nms_cfg["NMS_THRESH"]),
                        pre_max=min(int(nms_cfg["NMS_PRE_MAXSIZE"]), boxes.shape[1]),
                        post_max=int(nms_cfg["NMS_POST_MAXSIZE"]), valid=live)
    return (_take(boxes, sel), torch.where(keep, torch.gather(scores, 1, sel), 0.0),
            torch.gather(labels, 1, sel), keep)


def dropout_keep(generator, shape, keep_prob: float, device):
    """The kept units of one dropout layer: a uniform draw from `generator`
    below `keep_prob`, as flax's bernoulli keeps them."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


class FCStack(nn.Module):
    """[Dense (no bias) + BN1d + ReLU]* and an optional final biased Dense
    (the JAX FCStack; BN at torch's defaults, eps 1e-5, keep 0.9). In
    training, with a `dropout` generator and dp_ratio > 0, inverted dropout
    follows each block of `dropout_after`: flax's nn.Dropout, a unit kept
    where `dropout_keep` holds and scaled by 1 / (1 - p). Without a
    generator it is the identity, as JAX's FCStack is without a "dropout"
    rng. `make_fc_stack` and `shared_fc_stack` build the two layouts."""

    def __init__(self, in_channels: int, fc_list: Sequence[int], out_channels=None,
                 dp_ratio: float = 0.0, dropout_after: Sequence[int] = (0,)):
        super().__init__()
        self.num = len(fc_list)
        self.dp_ratio = float(dp_ratio)
        self.dropout_after = tuple(int(i) for i in dropout_after)
        for i, c in enumerate(fc_list):
            self.add_module(f"fc{i}", nn.Linear(in_channels, int(c), bias=False))
            self.add_module(f"bn{i}", BatchNorm(int(c), eps=1e-5, keep=0.9))
            in_channels = int(c)
        self.out_channels = in_channels if out_channels is None else int(out_channels)
        self.out = nn.Linear(in_channels, out_channels) if out_channels is not None else None

    def forward(self, x, dropout: torch.Generator | None = None):
        for i in range(self.num):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
            if (i in self.dropout_after and self.dp_ratio > 0 and self.training
                    and dropout is not None):
                keep_prob = 1.0 - self.dp_ratio
                keep = dropout_keep(dropout, x.shape, keep_prob, x.device)
                x = torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
        return self.out(x) if self.out is not None else x


def make_fc_stack(in_channels: int, fc_list, out_channels: int, dp_ratio: float) -> FCStack:
    """The reference's make_fc_layers: dropout after block 0 only, then the
    biased pred layer."""
    return FCStack(in_channels, fc_list, out_channels, dp_ratio, dropout_after=(0,))


def shared_fc_stack(in_channels: int, fc_list, dp_ratio: float) -> FCStack:
    """A head's shared_fc_layer: dropout between blocks, none after the
    last, no pred layer."""
    return FCStack(in_channels, fc_list, None, dp_ratio,
                   dropout_after=tuple(range(len(fc_list) - 1)))


class NeighborVoxelSA(nn.Module):
    """Single-scale NeighborVoxelSAModuleMSG (voxel_pool_modules.py:8-127),
    as the JAX package builds it (roi_head.py NeighborVoxelSA): per grid
    point, up to `nsample` voxel centres within `radius` (the ball query
    that stands in for the reference's QUERY_RANGES window, which holds the
    ball at the shipped configs), then in_dense + in_bn over the voxels (no
    ReLU), pos_dense + pos_bn over the relative positions (no ReLU), the sum
    through a ReLU, a max (or mean) over the neighbours, out_dense + out_bn
    + ReLU. An empty ball's features and positions are zeroed before the
    position MLP, as `grouped_features[empty_ball_mask] = 0`. The three BNs
    are masked (eps 1e-5, keep 0.9): voxels by their validity, grid points
    by theirs. The max is torch.amax: tied maxima share the gradient, as
    JAX's reduce_max shares it (an empty slot repeats the first hit, so
    ties are the rule)."""

    def __init__(self, in_channels: int, mlp_spec: Sequence[int], radius: float, nsample: int,
                 pool_method: str = "max_pool"):
        super().__init__()
        c_mid, c_out = int(mlp_spec[0]), int(mlp_spec[1])
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.pool_method = pool_method
        self.out_channels = c_out
        self.in_dense = nn.Linear(in_channels, c_mid, bias=False)
        self.in_bn = MaskedBatchNorm(c_mid, eps=1e-5, keep=0.9)
        self.pos_dense = nn.Linear(3, c_mid, bias=False)
        self.pos_bn = MaskedBatchNorm(c_mid, eps=1e-5, keep=0.9)
        self.out_dense = nn.Linear(c_mid, c_out, bias=False)
        self.out_bn = MaskedBatchNorm(c_out, eps=1e-5, keep=0.9)

    def query(self, grid_xyz, grid_valid, vox_xyz, vox_valid):
        """(idx (B, M, nsample), has (B, M)) of the ball query."""
        return P.ball_query(self.radius, self.nsample, vox_xyz, vox_valid, grid_xyz, grid_valid)

    def forward(self, grid_xyz, grid_valid, vox_xyz, vox_feats, vox_valid):
        """grid_xyz (B, M, 3), grid_valid (B, M), vox_xyz (B, N, 3), vox_feats
        (B, N, C), vox_valid (B, N) → (B, M, C_out)."""
        f = self.in_bn(self.in_dense(vox_feats), vox_valid)
        idx, has = self.query(grid_xyz, grid_valid, vox_xyz, vox_valid)
        empty = ~has[..., None, None]
        gf = P.group_points(f, idx).masked_fill(empty, 0)
        gx = (P.group_points(vox_xyz.float(), idx) - grid_xyz[:, :, None, :]).masked_fill(empty, 0)
        pos = self.pos_dense(gx)
        pos = self.pos_bn(pos, grid_valid[..., None].expand(pos.shape[:-1]))
        h = torch.relu(gf + pos)
        h = h.amax(dim=2) if self.pool_method == "max_pool" else h.mean(dim=2)
        return torch.relu(self.out_bn(self.out_dense(h), grid_valid))


class RoIStage:
    """What SECOND-IoU, Voxel R-CNN and PV-RCNN share on top of an anchor
    RPN (`AnchorDetectorBase`): the proposal NMS of each phase, the
    proposal target layer and the RoI loss configs."""

    def _setup_roi_stage(self, rh):
        self.proposal_nms = resolve_nms_cfg(rh, False)
        self.train_proposal_nms = resolve_nms_cfg(rh, True)
        self.target_cfg = roi_head_target_cfg(rh)
        self.loss_cfg = roi_head_loss_cfg(rh)

    def proposals(self, preds, train: bool):
        """The RPN's decoded boxes through `proposal_layer`: (rois, scores,
        labels, valid), fp32."""
        with torch.autocast(preds["cls_preds"].device.type, enabled=False):
            boxes, cls_scores = self.decode({k: v.float() for k, v in preds.items()})
            return proposal_layer(boxes, cls_scores,
                                  self.train_proposal_nms if train else self.proposal_nms)

    def sample_rois(self, preds, batch, sampler=None):
        """Training's proposals and their targets (`assign_roi_targets`),
        the (B, 2, P) uniforms drawn from `sampler`."""
        rois, roi_scores, roi_labels, _ = self.proposals(preds, True)
        roi_uniforms = draw_roi_uniforms(sampler, (rois.shape[0], 2, rois.shape[1]), rois.device)
        with torch.autocast(rois.device.type, enabled=False):
            return assign_roi_targets(roi_uniforms, rois, roi_labels, roi_scores,
                                      batch.gt_boxes, batch.gt_valid, self.target_cfg)

    def roi_loss(self, rcnn_cls, rcnn_reg, tgt):
        """`roi_head_loss` in fp32: (loss, tb)."""
        with torch.autocast(rcnn_cls.device.type, enabled=False):
            return roi_head_loss(rcnn_cls.float(), rcnn_reg.float(), tgt, self.loss_cfg)
