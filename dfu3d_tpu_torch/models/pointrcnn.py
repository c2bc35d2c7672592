"""PointRCNN (port of dfu3d_tpu/models/pointrcnn.py; the reference's
detectors/pointrcnn.py), serving and training:

    PointNet2MSG → PointHeadBox (per-point classes and boxes,
    PointResidualCoder) → proposal NMS → RoI point pooling with the
    canonical transform → PointRCNNHead (xyz_up, merge_down, the SA chain,
    CLS_FC / REG_FC) → decode → final NMS                     (`predict`)

    ... PointHeadBox → point targets, focal + smooth-L1 losses → proposal
    NMS → proposal target layer (3D IoU, fg / hard-bg / easy-bg sampling)
    → RoI pooling → PointRCNNHead → BCE + canonical smooth-L1 + corner
    loss                                                       (`forward`)

Submodules carry the flax names (backbone, point_head.cls_fc.dense_0,
roi_head.xyz_up_d0, roi_head.sa0_bn1, roi_head.cls_fc.fc0, ...), so
`convert.params_from_jax` maps the JAX model's variables one to one.
What JAX detaches, and only that, is detached here: the first-stage
outputs fed to the proposal layer and the class score in the pooled
prefix; the pooled backbone features carry the RoI head's gradient back
into PointNet2MSG.
"""
from __future__ import annotations

import logging
from typing import Sequence

import torch
from torch import nn

from ..core import pointnet2 as P
from ..core.geometry.boxes import enlarge_box3d, points_in_boxes, rotate_points_along_z
from ..parallel import mesh
from ..train import torch_convert
from . import roi_head
from .roi_head import draw_roi_uniforms
from .losses import sigmoid_focal_loss, weighted_smooth_l1
from .pointnet2_backbone import PointNet2MSG, SharedMLP, masked_max
from .vfe import MaskedBatchNorm

DEFAULT_MEAN_SIZE = (3.9, 1.6, 1.56)


def _anchor_sizes(classes, mean_sizes, device):
    ms = torch.as_tensor(mean_sizes, dtype=torch.float32, device=device)
    anchor = ms[torch.clamp(classes - 1, 0, ms.shape[0] - 1)]
    return anchor[..., 0], anchor[..., 1], anchor[..., 2]


def point_encode(gt_boxes, points, gt_classes, mean_sizes):
    """PointResidualCoder encode (box_coder_utils.py:144-222), the inverse of
    `point_decode`: (…, 7) gt at (…, 3) points with (…,) 1-based classes →
    (…, 8) residuals (sizes floored at 1e-5, the heading as cos, sin)."""
    dxa, dya, dza = _anchor_sizes(gt_classes, mean_sizes, gt_boxes.device)
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([(gt_boxes[..., 0] - points[..., 0]) / diagonal,
                        (gt_boxes[..., 1] - points[..., 1]) / diagonal,
                        (gt_boxes[..., 2] - points[..., 2]) / dza,
                        torch.log(torch.clamp(gt_boxes[..., 3], min=1e-5) / dxa),
                        torch.log(torch.clamp(gt_boxes[..., 4], min=1e-5) / dya),
                        torch.log(torch.clamp(gt_boxes[..., 5], min=1e-5) / dza),
                        torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], dim=-1)


def point_decode(encodings, points, pred_classes, mean_sizes):
    """PointResidualCoder decode (box_coder_utils.py:144-222): (…, 8) codes
    at (…, 3) points with (…,) 1-based classes → (…, 7) boxes; the heading
    is atan2(sin, cos)."""
    dxa, dya, dza = _anchor_sizes(pred_classes, mean_sizes, encodings.device)
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    rg = torch.atan2(encodings[..., 7], encodings[..., 6])
    return torch.stack([encodings[..., 0] * diagonal + points[..., 0],
                        encodings[..., 1] * diagonal + points[..., 1],
                        encodings[..., 2] * dza + points[..., 2],
                        torch.exp(encodings[..., 3]) * dxa,
                        torch.exp(encodings[..., 4]) * dya,
                        torch.exp(encodings[..., 5]) * dza,
                        rg], dim=-1)


def assign_point_targets(points_xyz, points_valid, gt_boxes, gt_valid,
                         extra_width=(0.2, 0.2, 0.2)):
    """Per-point class labels and matched gt (point_head_box.py + the point
    head template): points_xyz (B, N, 3), points_valid (B, N), gt_boxes
    (B, G, 8) with the class id last, gt_valid (B, G) → labels (B, N) int64,
    matched (B, N, 8). Labels: c >= 1 inside a valid box of class c, the
    first such box by index (JAX's argmax over bools); -1 inside a box
    enlarged by `extra_width` but in none, or an invalid point; 0 otherwise.
    The width is JAX's default (the config's GT_EXTRA_WIDTH is not read
    there either)."""
    inside = points_in_boxes(points_xyz, gt_boxes[..., :7]) & gt_valid[:, None, :]
    inside_ext = (points_in_boxes(points_xyz, enlarge_box3d(gt_boxes[..., :7], extra_width))
                  & gt_valid[:, None, :])
    box_idx = torch.argmax(inside.to(torch.int32), dim=-1)   # the first True
    any_in, any_ext = inside.any(dim=-1), inside_ext.any(dim=-1)
    matched = roi_head._take(gt_boxes, box_idx)
    labels = torch.where(any_in, matched[..., -1].to(torch.int64), 0)
    labels = torch.where(any_ext & ~any_in, -1, labels)
    return torch.where(points_valid, labels, -1), matched


class PointHeadBox(nn.Module):
    """Per-point class logits and 8 box codes (reference PointHeadBox)."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, num_class: int, cls_fc: Sequence[int],
                 reg_fc: Sequence[int]):
        super().__init__()
        self.cls_fc = SharedMLP(in_channels, cls_fc)
        self.cls_out = nn.Linear(self.cls_fc.out_channels, num_class)
        self.reg_fc = SharedMLP(in_channels, reg_fc)
        self.reg_out = nn.Linear(self.reg_fc.out_channels, 8)

    def forward(self, point_features, valid):
        cls = self.cls_out(self.cls_fc(point_features, valid)).float()
        box = self.reg_out(self.reg_fc(point_features, valid)).float()
        return cls, box


def pool_roi_points(points_xyz, point_feats, points_valid, rois, roi_valid,
                    num_samples: int, extra: float = 1.0):
    """The first `num_samples` valid points inside each RoI enlarged by
    `extra` (added to dx, dy, dz), in the RoI's canonical frame.

    points_xyz (B, N, 3), point_feats (B, N, C), points_valid (B, N), rois
    (B, R, 7+), roi_valid (B, R) → local xyz (B, R, S, 3), features
    (B, R, S, C), sample_valid (B, R, S). Slot s holds the point of 1-based
    rank s + 1 among the RoI's points; later points are dropped and empty
    slots read point 0 (replaces roipoint_pool3d)."""
    enlarged = enlarge_box3d(rois[..., :7], (extra, extra, extra))
    inside = points_in_boxes(points_xyz, enlarged)  # (B, N, R)
    inside = inside & points_valid[:, :, None] & roi_valid[:, None, :]
    rank = torch.cumsum(inside.transpose(1, 2), dim=-1, dtype=torch.int32)  # (B, R, N)
    counts = rank[..., -1]
    want = torch.arange(1, num_samples + 1, dtype=torch.int32, device=rank.device)
    pos = torch.searchsorted(rank, want.expand(*rank.shape[:-1], num_samples).contiguous())
    sample_valid = torch.arange(num_samples, device=rank.device) < counts[..., None]
    idx = torch.where(sample_valid, pos, 0)  # (B, R, S)
    b, r = idx.shape[:2]
    xyz = P.group_points(points_xyz, idx.reshape(b, -1)).reshape(b, r, num_samples, -1)
    feats = P.group_points(point_feats, idx.reshape(b, -1)).reshape(b, r, num_samples, -1)
    local = xyz - rois[:, :, None, 0:3]
    local = rotate_points_along_z(local, -rois[..., 6])
    return local, feats, sample_valid


class PointRCNNRoIHead(nn.Module):
    """The reference-exact PointRCNNHead encoder (pointrcnn_head.py:10-65,
    131-168): xyz_up over the 5 prefix channels (canonical xyz, score,
    depth), merge_down over [xyz features ‖ point features], the
    single-scale SA chain (FPS + ball query + shared MLP + masked max; an
    npoint of -1 groups all points into one vector), then the CLS_FC /
    REG_FC stacks. xyz_up and merge_down follow USE_BN (False: biased Dense
    + ReLU); the SA stacks always use BN, as the reference's batch SA
    modules do."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, num_samples: int, xyz_up, sa_npoints, sa_radii,
                 sa_nsamples, sa_mlps, cls_fc, reg_fc, use_bn: bool, dp_ratio: float = 0.0):
        super().__init__()
        self.num_samples = int(num_samples)
        self.use_bn = bool(use_bn)
        self.sa_npoints = tuple(int(n) for n in sa_npoints)
        self.sa_radii = tuple(float(r) for r in sa_radii)
        self.sa_nsamples = tuple(int(n) for n in sa_nsamples)
        self.widths = {}
        self._make_stack("xyz_up", 5, xyz_up, self.use_bn)
        self._make_stack("merge_down", int(xyz_up[-1]) + in_channels, (xyz_up[-1],), self.use_bn)
        c = int(xyz_up[-1])
        for li, mlp in enumerate(sa_mlps):
            self._make_stack(f"sa{li}", c + 3, mlp, True)
            c = int(mlp[-1])
        self.cls_fc = roi_head.FCStack(c, cls_fc, 1, dp_ratio)
        self.reg_fc = roi_head.FCStack(c, reg_fc, 7, dp_ratio)

    def _make_stack(self, name, in_channels, widths, bn):
        self.widths[name] = (tuple(int(w) for w in widths), bn)
        for i, w in enumerate(widths):
            self.add_module(f"{name}_d{i}", nn.Linear(in_channels, int(w), bias=not bn))
            if bn:
                self.add_module(f"{name}_bn{i}", MaskedBatchNorm(int(w), eps=1e-5, keep=0.9))
            in_channels = int(w)

    def _mlp(self, name, x, mask):
        widths, bn = self.widths[name]
        for i in range(len(widths)):
            x = getattr(self, f"{name}_d{i}")(x)
            if bn:
                x = getattr(self, f"{name}_bn{i}")(x, mask.expand(x.shape[:-1]))
            x = torch.relu(x)
        return x

    def forward(self, local_xyz, prefix, feats, sample_valid, dropout=None):
        """local_xyz (M, S, 3) canonical, prefix (M, S, 2) [score, depth],
        feats (M, S, C), sample_valid (M, S) → cls (M,), reg (M, 7), fp32.
        `dropout`, a generator, drives the FC stacks' dropout in training."""
        xyz_f = self._mlp("xyz_up", torch.cat([local_xyz, prefix], -1), sample_valid)
        h = self._mlp("merge_down", torch.cat([xyz_f, feats.to(xyz_f.dtype)], -1), sample_valid)
        xyz, v = local_xyz, sample_valid
        for li, npoint in enumerate(self.sa_npoints):
            if npoint > 0:
                idx = P.farthest_point_sample(xyz, v, npoint)
                qv = torch.gather(v, 1, idx)
                q = P.group_points(xyz, idx)
                gi, has = P.ball_query(self.sa_radii[li], self.sa_nsamples[li], xyz, v, q, qv)
                gx = P.group_points(xyz, gi) - q[:, :, None, :]
                g = torch.cat([gx, P.group_points(h, gi).to(gx.dtype)], -1)
                m = (has & qv)[..., None]
                h = masked_max(self._mlp(f"sa{li}", g, m), m[..., None], dim=2)
                xyz, v = q, qv
            else:  # group all
                g = torch.cat([xyz, h.to(xyz.dtype)], -1)
                h = masked_max(self._mlp(f"sa{li}", g, v), v[..., None], dim=1)
        return (self.cls_fc(h, dropout)[..., 0].float(), self.reg_fc(h, dropout).float())


class PointRCNN(nn.Module):
    """Two-stage point-based detector (reference detectors/pointrcnn.py):
    `predict` serves, `forward` computes the training loss."""

    GLOBAL_BATCH = True

    def __init__(self, model_cfg, class_names, num_point_features: int = 4):
        super().__init__()
        cfg = model_cfg
        self.class_names = tuple(class_names)
        bb = cfg.BACKBONE_3D
        if bb.NAME != "PointNet2MSG":
            raise NotImplementedError(f"BACKBONE_3D {bb.NAME} is not ported")
        sa = bb.SA_CONFIG
        self.backbone = PointNet2MSG(
            npoints=tuple(sa.NPOINTS), radii=tuple(tuple(r) for r in sa.RADIUS),
            nsamples=tuple(tuple(s) for s in sa.NSAMPLE),
            mlps=tuple(tuple(tuple(m) for m in lvl) for lvl in sa.MLPS),
            fp_mlps=tuple(tuple(m) for m in bb.FP_MLPS), num_point_features=num_point_features)
        ph = cfg.POINT_HEAD
        if ph.NAME != "PointHeadBox":
            raise NotImplementedError(f"POINT_HEAD {ph.NAME} is not ported")
        self.point_head = PointHeadBox(self.backbone.out_channels, len(self.class_names),
                                       tuple(ph.CLS_FC), tuple(ph.REG_FC))
        self.mean_sizes = tuple(tuple(float(v) for v in m) for m in
                                ph.TARGET_CONFIG.BOX_CODER_CONFIG.get(
                                    "mean_size", [DEFAULT_MEAN_SIZE] * len(self.class_names)))
        rh = cfg.ROI_HEAD
        if rh.NAME != "PointRCNNHead":
            raise NotImplementedError(f"ROI_HEAD {rh.NAME} is not ported")
        pool_cfg = rh.get("ROI_POINT_POOL", {})
        self.depth_normalizer = float(pool_cfg.get("DEPTH_NORMALIZER", 70.0))
        # enlarge_box3d adds the extra width on each side
        self.pool_extra = 2.0 * float(max(pool_cfg.get("POOL_EXTRA_WIDTH", (0.0, 0.0, 0.0))))
        sa = rh.get("SA_CONFIG", {})
        self.roi_head = PointRCNNRoIHead(
            in_channels=self.backbone.out_channels,
            num_samples=int(pool_cfg.get("NUM_SAMPLED_POINTS", rh.get("ROI_POINT_SAMPLES", 512))),
            xyz_up=tuple(rh.get("XYZ_UP_LAYER", (128, 128))),
            sa_npoints=tuple(sa.get("NPOINTS", (128, 32, -1))),
            sa_radii=tuple(sa.get("RADIUS", (0.2, 0.4, 100.0))),
            sa_nsamples=tuple(sa.get("NSAMPLE", (16, 16, 16))),
            sa_mlps=tuple(tuple(m) for m in sa.get(
                "MLPS", ((128, 128, 128), (128, 128, 256), (256, 256, 512)))),
            cls_fc=tuple(rh.get("CLS_FC", (256, 256))), reg_fc=tuple(rh.get("REG_FC", (256, 256))),
            use_bn=bool(rh.get("USE_BN", False)), dp_ratio=float(rh.get("DP_RATIO", 0.0)))
        # serving's proposal NMS (its post size is the RoI count) and training's
        self.proposal_nms = roi_head.resolve_nms_cfg(rh, False)
        self.train_proposal_nms = roi_head.resolve_nms_cfg(rh, True)
        self.target_cfg = roi_head.roi_head_target_cfg(rh)
        self.loss_cfg = roi_head.roi_head_loss_cfg(rh)
        pp = cfg.get("POST_PROCESSING", None)
        self.post_processing = roi_head.fallback_post_processing(
            pp, self.proposal_nms["post_max"])
        if pp is not None and "NMS_CONFIG" not in pp:
            logging.getLogger("dfu3d_tpu_torch").warning(
                "POST_PROCESSING has no NMS_CONFIG: the final NMS falls back to %s",
                self.post_processing)

    def stage1(self, batch):
        feats = self.backbone(batch.points, batch.points_valid)
        cls_logits, box_codes = self.point_head(feats, batch.points_valid)
        return feats, cls_logits, box_codes

    def proposals(self, batch, cls_logits, box_codes, nms_cfg):
        """proposal_layer over the decoded point boxes (roi_head_template.py:45-102)."""
        pred_cls = torch.argmax(cls_logits, dim=-1) + 1
        boxes = point_decode(box_codes, batch.points[..., :3].float(), pred_cls, self.mean_sizes)
        cls_scores = torch.where(batch.points_valid[..., None], torch.sigmoid(cls_logits), 0.0)
        return roi_head.proposal_layer(boxes, cls_scores, nms_cfg)

    def pool_rois(self, batch, feats, cls_logits, rois, roi_valid):
        """roipool3d (pointrcnn_head.py:88-129): [max class score, depth /
        DEPTH_NORMALIZER - 0.5, backbone features] per pooled point, xyz in
        the RoI's canonical frame; the score is detached. Returns (local
        xyz, prefix, features, valid), each flattened to (B·R, S, ...)."""
        pts = batch.points[..., :3].float()
        score = torch.sigmoid(cls_logits).amax(dim=-1).detach()
        depth = torch.sqrt(pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1]
                           + pts[..., 2] * pts[..., 2]) / self.depth_normalizer - 0.5
        pf = torch.cat([score[..., None], depth[..., None], feats.to(score.dtype)], dim=-1)
        local, pooled, sample_valid = pool_roi_points(
            pts, pf, batch.points_valid, rois, roi_valid, self.roi_head.num_samples,
            extra=self.pool_extra)
        b, r, s = sample_valid.shape
        return (local.reshape(b * r, s, 3), pooled[..., :2].reshape(b * r, s, 2),
                pooled[..., 2:].reshape(b * r, s, -1), sample_valid.reshape(b * r, s))

    def forward(self, batch, sampler=None, dropout=None, roi_uniforms=None):
        """Train: (loss, {point_cls_loss, point_reg_loss, rcnn_cls_loss,
        rcnn_reg_loss, rpn_loss}) as JAX's PointRCNN.__call__(train=True).
        `sampler` and `dropout` are generators on the batch's device: the
        proposal target layer's (B, 2, P) uniforms come from `sampler` unless
        `roi_uniforms` gives them; `dropout` drives the RoI head's FC
        dropout. BN layers use batch statistics and update their running
        ones when the module is in train mode. Targets and losses are fp32.
        Over several ranks the batch is this rank's rows of the global
        batch: the losses are its share of the global ones and the draws its
        rows of the global draws."""
        feats, cls_logits, box_codes = self.stage1(batch)
        pts = batch.points[..., :3].float()
        b = pts.shape[0]
        with torch.autocast(pts.device.type, enabled=False):
            # stage 1: PointHeadBox, focal cls + smooth-L1 reg on the fg points
            labels, matched = assign_point_targets(pts, batch.points_valid, batch.gt_boxes,
                                                   batch.gt_valid)
            cared, pos = labels >= 0, labels > 0
            cls_weights = cared.float() / torch.clamp(pos.sum(1, keepdim=True), min=1.0)
            one_hot = torch.nn.functional.one_hot(torch.where(cared, labels, 0),
                                                  len(self.class_names) + 1)[..., 1:]
            # a mean over the global batch: this rank's sum over its frames
            b_global = b * mesh.world()
            cls_loss = sigmoid_focal_loss(cls_logits, one_hot, cls_weights).sum() / b_global
            reg_targets = point_encode(matched[..., :7], pts, matched[..., -1].to(torch.int64),
                                       self.mean_sizes)
            reg_weights = pos.float()
            reg_weights = reg_weights / torch.clamp(reg_weights.sum(1, keepdim=True), min=1.0)
            reg_loss = weighted_smooth_l1(box_codes, reg_targets, reg_weights).sum() / b_global

            # stage 2: proposal layer → proposal target layer → PointRCNNHead
            rois, roi_scores, roi_labels, _ = self.proposals(
                batch, cls_logits.detach(), box_codes.detach(), self.train_proposal_nms)
            if roi_uniforms is None:
                roi_uniforms = draw_roi_uniforms(sampler, (b, 2, rois.shape[1]), pts.device)
            tgt = roi_head.assign_roi_targets(roi_uniforms, rois, roi_labels, roi_scores,
                                              batch.gt_boxes, batch.gt_valid, self.target_cfg)
        m = tgt["rois"].shape[1]
        # every sampled slot is a RoI, a zeroed padding proposal included
        roi_valid = torch.ones((b, m), dtype=torch.bool, device=pts.device)
        local, prefix, roi_feats, sample_valid = self.pool_rois(batch, feats, cls_logits,
                                                                tgt["rois"], roi_valid)
        rcnn_cls, rcnn_reg = self.roi_head(local, prefix, roi_feats, sample_valid, dropout)
        with torch.autocast(pts.device.type, enabled=False):
            rcnn_loss, rtb = roi_head.roi_head_loss(rcnn_cls.reshape(b, m),
                                                    rcnn_reg.reshape(b, m, 7), tgt, self.loss_cfg)
            total = cls_loss + reg_loss + rcnn_loss
        return total, {"point_cls_loss": cls_loss, "point_reg_loss": reg_loss,
                       "rcnn_cls_loss": rtb["rcnn_loss_cls"],
                       "rcnn_reg_loss": rtb["rcnn_loss_reg_total"], "rpn_loss": total}

    def reference_mapping(self):
        """The reference-key mapping of a checkpoint (train/torch_convert):
        the point head's and the RoI head's at this model's widths. The JAX
        package has none for PointNet2MSG, so the backbone stays unmapped."""
        ph, rh = self.point_head, self.roi_head
        widths = {name: rh.widths[name][0] for name in rh.widths}
        return {**torch_convert.point_head_box_mapping(ph.cls_fc.channels, ph.reg_fc.channels),
                **torch_convert.pointrcnn_head_mapping(
                    xyz_up=widths["xyz_up"],
                    sa_mlps=[widths[f"sa{k}"] for k in range(len(rh.sa_npoints))],
                    cls_fc=[getattr(rh.cls_fc, f"fc{i}").out_features
                            for i in range(rh.cls_fc.num)],
                    reg_fc=[getattr(rh.reg_fc, f"fc{i}").out_features
                            for i in range(rh.reg_fc.num)],
                    use_bn=rh.use_bn)}

    def predict(self, batch):
        """Eval: (boxes (B, P, 7), scores (B, P), labels (B, P), valid (B, P))."""
        feats, cls_logits, box_codes = self.stage1(batch)
        rois, _, roi_labels, roi_valid = self.proposals(batch, cls_logits, box_codes,
                                                        self.proposal_nms)
        b, r = rois.shape[:2]
        local, prefix, roi_feats, sample_valid = self.pool_rois(batch, feats, cls_logits, rois,
                                                                roi_valid)
        rcnn_cls, rcnn_reg = self.roi_head(local, prefix, roi_feats, sample_valid)
        refined = roi_head.generate_predicted_boxes(rois[..., :7], rcnn_reg.reshape(b, r, 7))
        scores = torch.where(roi_valid, torch.sigmoid(rcnn_cls.reshape(b, r)), 0.0)
        return roi_head.final_nms(refined, scores, roi_labels, roi_valid, self.post_processing)
