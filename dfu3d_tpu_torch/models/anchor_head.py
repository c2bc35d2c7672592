"""Anchor-based dense heads (port of dfu3d_tpu/models/anchor_head.py): the
anchor generator, the residual coder (which PointRCNN's RoI head also
decodes with), the axis-aligned target assigner (on the snapped BEV IoU, or
with MATCH_HEIGHT on the rotated 3D IoU through kernel B1),
AnchorHeadSingle (with SECONDNetIoU's conv_iou under USE_IOU_HEAD) and
AnchorHeadMulti, their loss (and the IoU head's) and their decode.

Reference: pcdet/models/dense_heads/anchor_head_single.py,
anchor_head_multi.py and anchor_head_template.py,
target_assigner/axis_aligned_target_assigner.py and anchor_generator.py,
utils/box_coder_utils.ResidualCoder.

Heads take and give the JAX layout, (B, H, W, C); anchors are class-major
per location. Target assignment is JAX's masked form over the fixed
(anchors, gt slots) IoU matrix, batched over frames: its labels equal JAX's
exactly (first-index argmax, and the force-match's float equality against
each gt's best IoU).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry.boxes import (
    boxes3d_lidar_to_aligned_bev_boxes,
    boxes_iou_normal,
    limit_period,
)
from ..core.geometry.iou import aligned_iou3d
from . import losses

CLS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
FOREIGN_LOGIT = -10.0  # AnchorHeadMulti: a class outside an anchor's group


def generate_anchors(anchor_generator_cfgs, grid_size, point_cloud_range, anchor_ndim: int = 7):
    """Per-class anchor grids (reference AnchorGenerator.generate_anchors),
    host numpy as in the JAX package.

    Returns a list of (nz, ny, nx, num_sizes, num_rots, 7) float32 arrays, one
    per class config, and the list of per-location anchor counts."""
    all_anchors, num_anchors_per_location = [], []
    pcr = np.asarray(point_cloud_range, np.float64)
    for cfg in anchor_generator_cfgs:
        sizes = np.asarray(cfg["anchor_sizes"], np.float64)            # (S, 3) l w h
        rotations = np.asarray(cfg["anchor_rotations"], np.float64)    # (R,)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float64)  # (Hz,)
        stride = cfg.get("feature_map_stride", 1)
        nx = grid_size[0] // stride
        ny = grid_size[1] // stride
        if cfg.get("align_center", False):
            x_stride = (pcr[3] - pcr[0]) / nx
            y_stride = (pcr[4] - pcr[1]) / ny
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (pcr[3] - pcr[0]) / (nx - 1)
            y_stride = (pcr[4] - pcr[1]) / (ny - 1)
            x_offset = y_offset = 0.0
        x_shifts = pcr[0] + x_offset + np.arange(nx) * x_stride
        y_shifts = pcr[1] + y_offset + np.arange(ny) * y_stride
        nz, s, r = len(heights), len(sizes), len(rotations)
        zz, yy, xx = np.meshgrid(heights, y_shifts, x_shifts, indexing="ij")
        centers = np.stack([xx, yy, zz], axis=-1)  # (nz, ny, nx, 3)
        anchors = np.zeros((nz, ny, nx, s, r, anchor_ndim), np.float32)
        anchors[..., 0:3] = centers[:, :, :, None, None, :]
        anchors[..., 3:6] = sizes[None, None, None, :, None, :]
        anchors[..., 6] = rotations[None, None, None, None, :]
        anchors[..., 2] += anchors[..., 5] / 2  # bottom → centre z
        all_anchors.append(anchors)
        num_anchors_per_location.append(s * r * nz)
    return all_anchors, num_anchors_per_location


def encode_boxes(boxes, anchors):
    """(…, 7) gt boxes against (…, 7) anchors → (…, 7) residual targets."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    dxa = torch.clamp(anchors[..., 3], min=1e-5)
    dya = torch.clamp(anchors[..., 4], min=1e-5)
    dza = torch.clamp(anchors[..., 5], min=1e-5)
    ra = anchors[..., 6]
    xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dxg = torch.clamp(boxes[..., 3], min=1e-5)
    dyg = torch.clamp(boxes[..., 4], min=1e-5)
    dzg = torch.clamp(boxes[..., 5], min=1e-5)
    rg = boxes[..., 6]
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                        torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                        rg - ra], dim=-1)


def decode_boxes(encodings, anchors):
    """(…, 7) residuals on (…, 7) anchors → (…, 7) boxes."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
    ra = anchors[..., 6]
    xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
    dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]
    rt = encodings[..., 6]
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                        torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
                        rt + ra], dim=-1)


class AnchorTargets(NamedTuple):
    box_cls_labels: torch.Tensor   # (B, A) int64, -1 = don't care
    box_reg_targets: torch.Tensor  # (B, A, 7)
    reg_weights: torch.Tensor      # (B, A)


def _nearest_bev_iou(anchors_bev, gt):
    """Axis-aligned BEV IoU of snapped anchor boxes (A, 4) against gt
    (B, M, 7+) → (B, A, M) (JAX's _nearest_bev_iou, vmapped over frames)."""
    b, m = gt.shape[:2]
    gt_bev = boxes3d_lidar_to_aligned_bev_boxes(gt.reshape(b * m, -1)).reshape(b, m, 4)
    return boxes_iou_normal(anchors_bev[None], gt_bev)


def assign_targets_single_class(anchors, gt_boxes, gt_mask, gt_classes, matched_threshold,
                                unmatched_threshold, anchors_bev=None, iou=None):
    """One class's anchors (A, 7) against every frame's gt (B, M, 7), masked
    to that class by gt_mask (B, M) (assign_targets_single,
    axis_aligned_target_assigner.py:132-214, JAX's masked form): returns
    labels (B, A) int64, regression targets (B, A, 7) and weights (B, A).
    The overlaps are the snapped BEV IoU (`anchors_bev` the anchors' snapped
    BEV boxes when the caller has them), or `iou` (B, A, M) when the caller
    gives them (MATCH_HEIGHT: `pairwise_iou3d`, JAX anchor_head.py:159-161).
    The force-match compares each overlap for equality with its gt's
    largest, both read from the one `iou` tensor."""
    if iou is None:
        if anchors_bev is None:
            anchors_bev = boxes3d_lidar_to_aligned_bev_boxes(anchors)
        iou = _nearest_bev_iou(anchors_bev, gt_boxes[..., :7])
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    any_gt = gt_mask.any(dim=1, keepdim=True)                       # (B, 1)
    anchor_to_gt_max = iou.amax(dim=2)                              # (B, A)
    # the first maximal index, as jnp.argmax (max(dim)'s index may be any)
    anchor_to_gt_argmax = torch.argmax(iou, dim=2)
    gt_to_anchor_max = iou.amax(dim=1)                              # (B, M)
    gt_to_anchor_max = torch.where(gt_mask & (gt_to_anchor_max > 0), gt_to_anchor_max, -1.0)
    # force-match: the anchors that reach a gt's best overlap
    force = ((iou == gt_to_anchor_max[:, None, :]) & (gt_to_anchor_max[:, None, :] > 0)).any(dim=2)

    matched_cls = torch.gather(gt_classes, 1, anchor_to_gt_argmax).long()
    labels = torch.full_like(anchor_to_gt_argmax, -1)
    labels = torch.where(anchor_to_gt_max < unmatched_threshold, 0, labels)
    labels = torch.where(anchor_to_gt_max >= matched_threshold, matched_cls, labels)
    labels = torch.where(force, matched_cls, labels)
    labels = torch.where(any_gt, labels, 0)

    fg = labels > 0
    matched_boxes = torch.gather(gt_boxes[..., :7], 1,
                                 anchor_to_gt_argmax[..., None].expand(-1, -1, 7))
    targets = encode_boxes(matched_boxes, anchors[None])
    targets = torch.where(fg[..., None], targets, 0.0)
    return labels, targets, fg.float()


def _conv1x1(cin, cout, bias_value=None):
    conv = nn.Conv2d(cin, cout, 1)
    if bias_value is not None:
        nn.init.constant_(conv.bias, bias_value)
    return conv


def _nhwc(conv, x_nchw):
    return conv(x_nchw).permute(0, 2, 3, 1)


class AnchorHeadSingle(nn.Module):
    """1×1 conv heads over BEV features (anchor_head_single.py:10-74):
    conv_cls, conv_box and conv_dir_cls, and with `use_iou_head` (USE_IOU_HEAD,
    the SECONDNetIoU variant, detectors/second_net_iou.py) conv_iou, one IoU
    logit per anchor."""

    def __init__(self, in_channels: int, num_class: int, num_anchors_per_location: int,
                 use_direction_classifier: bool = True, num_dir_bins: int = 2,
                 use_iou_head: bool = False):
        super().__init__()
        a = num_anchors_per_location
        self.use_direction_classifier = use_direction_classifier
        self.use_iou_head = use_iou_head
        self.conv_cls = _conv1x1(in_channels, a * num_class, CLS_PRIOR_BIAS)
        self.conv_box = _conv1x1(in_channels, a * 7)
        if use_direction_classifier:
            self.conv_dir_cls = _conv1x1(in_channels, a * num_dir_bins)
        if use_iou_head:
            self.conv_iou = _conv1x1(in_channels, a)

    def forward(self, spatial_features_2d):
        """(B, H, W, C) → {"cls_preds", "box_preds"[, "dir_cls_preds"]
        [, "iou_preds"]}, each (B, H, W, A·k) fp32."""
        x = spatial_features_2d.permute(0, 3, 1, 2)
        out = {"cls_preds": _nhwc(self.conv_cls, x).float(),
               "box_preds": _nhwc(self.conv_box, x).float()}
        if self.use_direction_classifier:
            out["dir_cls_preds"] = _nhwc(self.conv_dir_cls, x).float()
        if self.use_iou_head:
            out["iou_preds"] = _nhwc(self.conv_iou, x).float()
        return out


class AnchorHeadMulti(nn.Module):
    """Grouped multi-head anchor head (reference anchor_head_multi.py, JAX's
    AnchorHeadMulti): a shared 3×3 conv + ReLU, then per class group 1×1
    head{g}_cls / _box / _dir convs. The outputs take AnchorHeadSingle's flat
    class-major layout; an anchor's logits for the classes outside its group
    are the constant FOREIGN_LOGIT (no gradient).

    `class_groups`: per group, its class indices (covering 0..num_class-1);
    `anchors_per_loc_each_class`: each class's anchors per location."""

    def __init__(self, in_channels: int, num_class: int, class_groups: Sequence[Sequence[int]],
                 anchors_per_loc_each_class: Sequence[int], shared_conv_channels: int = 64,
                 use_direction_classifier: bool = True, num_dir_bins: int = 2):
        super().__init__()
        self.num_class = num_class
        self.class_groups = tuple(tuple(g) for g in class_groups)
        self.a_cls = tuple(anchors_per_loc_each_class)
        self.use_direction_classifier = use_direction_classifier
        self.num_dir_bins = num_dir_bins
        self.shared_conv_channels = shared_conv_channels
        cin = in_channels
        if shared_conv_channels:
            self.shared_conv = nn.Conv2d(in_channels, shared_conv_channels, 3, padding=1)
            cin = shared_conv_channels
        # each class's group and its first anchor slot within the group
        self._slot = {}
        for g, group in enumerate(self.class_groups):
            a_g = sum(self.a_cls[c] for c in group)
            self.add_module(f"head{g}_cls", _conv1x1(cin, a_g * len(group), CLS_PRIOR_BIAS))
            self.add_module(f"head{g}_box", _conv1x1(cin, a_g * 7))
            if use_direction_classifier:
                self.add_module(f"head{g}_dir", _conv1x1(cin, a_g * num_dir_bins))
            base = 0
            for ci, c in enumerate(group):
                self._slot[c] = (g, ci, base)
                base += self.a_cls[c]

    def forward(self, spatial_features_2d):
        x = spatial_features_2d.permute(0, 3, 1, 2)
        if self.shared_conv_channels:
            x = F.relu(self.shared_conv(x))
        b, _, h, w = x.shape
        outs = []
        for g, group in enumerate(self.class_groups):
            a_g = sum(self.a_cls[c] for c in group)
            o = {"cls": _nhwc(getattr(self, f"head{g}_cls"), x).reshape(b, h, w, a_g, len(group)),
                 "box": _nhwc(getattr(self, f"head{g}_box"), x).reshape(b, h, w, a_g, 7)}
            if self.use_direction_classifier:
                o["dir"] = _nhwc(getattr(self, f"head{g}_dir"), x).reshape(
                    b, h, w, a_g, self.num_dir_bins)
            outs.append(o)
        cls_parts, box_parts, dir_parts = [], [], []
        for c in range(self.num_class):
            g, ci, base = self._slot[c]
            sl = slice(base, base + self.a_cls[c])
            logits = outs[g]["cls"][:, :, :, sl, ci:ci + 1]
            foreign = torch.full((b, h, w, self.a_cls[c], 1), FOREIGN_LOGIT, dtype=logits.dtype,
                                 device=logits.device)
            cls_parts.append(torch.cat([foreign.expand(-1, -1, -1, -1, c), logits,
                                        foreign.expand(-1, -1, -1, -1, self.num_class - c - 1)],
                                       dim=-1))
            box_parts.append(outs[g]["box"][:, :, :, sl])
            if self.use_direction_classifier:
                dir_parts.append(outs[g]["dir"][:, :, :, sl])
        out = {"cls_preds": torch.cat(cls_parts, dim=3).reshape(b, h, w, -1).float(),
               "box_preds": torch.cat(box_parts, dim=3).reshape(b, h, w, -1).float()}
        if self.use_direction_classifier:
            out["dir_cls_preds"] = torch.cat(dir_parts, dim=3).reshape(b, h, w, -1).float()
        return out


def add_sin_difference(boxes1, boxes2, dim: int = 6):
    """The angle channel as sin(a)·cos(b) against cos(a)·sin(b)
    (anchor_head_template.add_sin_difference)."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def _floor_mod(x, y: float):
    """jnp.remainder for y > 0: the exact fmod, moved into [0, y)."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def get_direction_target(anchors, reg_targets, dir_offset: float = 0.78539, num_bins: int = 2):
    """Direction bin of each anchor's target heading
    (anchor_head_template.get_direction_target)."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = _floor_mod(rot_gt - dir_offset, 2 * np.pi)
    return torch.clamp(torch.floor(offset_rot / (2 * np.pi / num_bins)).long(), 0, num_bins - 1)


def anchor_head_loss(preds, targets: AnchorTargets, anchors_flat, num_class: int, loss_weights,
                     dir_offset: float = 0.78539, num_dir_bins: int = 2):
    """The sigmoid focal classification loss, the smooth-L1 box loss on the
    sin difference and the direction cross entropy
    (anchor_head_template.get_cls_layer_loss + get_box_reg_layer_loss).
    Returns (total, {"rpn_loss_cls", "rpn_loss_loc"[, "rpn_loss_dir"],
    "rpn_loss"})."""
    b = preds["cls_preds"].shape[0]
    cls_preds = preds["cls_preds"].reshape(b, -1, num_class)
    box_preds = preds["box_preds"].reshape(b, -1, 7)
    labels = targets.box_cls_labels

    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = (negatives.float() + positives.float()) * cared.float()
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).float(), min=1.0)
    cls_weights = cls_weights / pos_norm
    reg_weights = positives.float() / pos_norm

    one_hot = F.one_hot(torch.where(cared, labels, 0), num_class + 1).float()[..., 1:]
    cls_loss = (losses.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum() / b
                * loss_weights["cls_weight"])
    box_preds_sin, targets_sin = add_sin_difference(box_preds, targets.box_reg_targets)
    loc_loss = (losses.weighted_smooth_l1(box_preds_sin, targets_sin, reg_weights,
                                          code_weights=loss_weights.get("code_weights")).sum()
                / b * loss_weights["loc_weight"])
    total = cls_loss + loc_loss
    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    if "dir_cls_preds" in preds:
        dir_targets = get_direction_target(anchors_flat[None], targets.box_reg_targets,
                                           dir_offset, num_dir_bins)
        dir_logits = preds["dir_cls_preds"].reshape(b, -1, num_dir_bins)
        weights = positives.float()
        weights = weights / torch.clamp(weights.sum(dim=1, keepdim=True), min=1.0)
        dir_onehot = F.one_hot(dir_targets, num_dir_bins).float()
        dir_loss = (losses.weighted_cross_entropy(dir_logits, dir_onehot, weights).sum() / b
                    * loss_weights.get("dir_weight", 0.2))
        total = total + dir_loss
        tb["rpn_loss_dir"] = dir_loss
    tb["rpn_loss"] = total
    return total, tb


def iou_head_loss(preds, targets: AnchorTargets, anchors_flat):
    """The IoU head's L1 loss (JAX pointpillar.py:154-178, second_net_iou
    semantics): per anchor |tanh(iou logit) - the 3D IoU of its decoded box
    (detached) with its decoded target|, over the positive anchors, each
    frame's weights 1 / its positives, summed and divided by B."""
    b = preds["iou_preds"].shape[0]
    iou_p = preds["iou_preds"].reshape(b, -1)
    boxes = decode_boxes(preds["box_preds"].reshape(b, -1, 7), anchors_flat[None])
    matched = decode_boxes(targets.box_reg_targets, anchors_flat[None])
    actual = aligned_iou3d(boxes.detach().reshape(-1, 7), matched.reshape(-1, 7)).view(b, -1)
    w = (targets.box_cls_labels > 0).float()
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return (torch.abs(torch.tanh(iou_p) - actual) * w).sum() / b


def rectify_scores(max_scores, iou_preds, rectifier: float):
    """score^(1-w) · max(clip(tanh(iou logit), 0, 1), 1e-4)^w (JAX
    pointpillar.py:198-205, IOU_RECTIFIER w)."""
    iou = torch.clamp(torch.tanh(iou_preds.reshape(max_scores.shape)), 0.0, 1.0)
    return torch.pow(max_scores, 1 - rectifier) * torch.pow(torch.clamp(iou, min=1e-4), rectifier)


def decode_anchor_predictions(preds, anchors_flat, num_class: int, dir_offset: float = 0.78539,
                              dir_limit_offset: float = 0.0, num_dir_bins: int = 2):
    """Decoded boxes (B, A, 7) and class scores (B, A, num_class)
    (anchor_head_template.generate_predicted_boxes)."""
    b = preds["cls_preds"].shape[0]
    cls_preds = preds["cls_preds"].reshape(b, -1, num_class)
    box_preds = preds["box_preds"].reshape(b, -1, 7)
    boxes = decode_boxes(box_preds, anchors_flat[None])
    if "dir_cls_preds" in preds:
        dir_labels = torch.argmax(preds["dir_cls_preds"].reshape(b, -1, num_dir_bins), dim=-1)
        period = 2 * np.pi / num_dir_bins
        dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit_offset, period)
        rot = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], rot[..., None]], dim=-1)
    return boxes, torch.sigmoid(cls_preds)
