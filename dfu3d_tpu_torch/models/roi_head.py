"""The serving part of the RoI head template (port of
dfu3d_tpu/models/roi_head.py, itself the reference's
roi_heads/roi_head_template.py):

- `resolve_nms_cfg`          — NMS_CONFIG.TRAIN/TEST, or the flat legacy keys;
- `proposal_layer`           — class-agnostic proposal NMS (roi_head_template.py:45-102);
- `generate_predicted_boxes` — the canonical decode (roi_head_template.py:233-261);
- `final_nms`                — post-processing NMS over the refined boxes;
- `FCStack`                  — make_fc_layers (roi_head_template.py:29-43).

Both NMS steps take every frame of the batch at once, so each is one launch
of the overlap kernel (B1) over (B, N, N) through `nms_bev`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.geometry.boxes import rotate_points_along_z
from ..core.geometry.nms import nms_bev
from .anchor_head import decode_boxes
from .backbone_2d import BatchNorm


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


class FCStack(nn.Module):
    """[Dense (no bias) + BN1d + ReLU]* and an optional final biased Dense
    (the JAX FCStack; BN at torch's defaults, eps 1e-5, keep 0.9). Dropout
    only acts in training, which this slice does not port."""

    def __init__(self, in_channels: int, fc_list: Sequence[int], out_channels=None):
        super().__init__()
        self.num = len(fc_list)
        for i, c in enumerate(fc_list):
            self.add_module(f"fc{i}", nn.Linear(in_channels, int(c), bias=False))
            self.add_module(f"bn{i}", BatchNorm(int(c), eps=1e-5, keep=0.9))
            in_channels = int(c)
        self.out = nn.Linear(in_channels, out_channels) if out_channels is not None else None

    def forward(self, x):
        for i in range(self.num):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return self.out(x) if self.out is not None else x
