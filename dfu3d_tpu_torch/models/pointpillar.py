"""Anchor detectors: PointPillar and SECONDNet (port of
dfu3d_tpu/models/pointpillar.py).

    PointPillar: DynPillarVFE → BaseBEVBackbone → anchor head
    SECONDNet:   MeanVFE → VoxelBackBone8x → height_compression →
                 BaseBEVBackbone → anchor head

The anchor head is AnchorHeadSingle or AnchorHeadMulti (DENSE_HEAD.NAME).
`AnchorDetectorBase` holds the anchors, the per-class target assignment,
the loss (`forward`) and the class-agnostic decode + NMS (`predict`; one
overlap-kernel launch per batch). MULTI_CLASSES_NMS is not read, as in the
JAX package. Submodule names follow the flax tree (vfe, backbone_3d,
backbone_2d, dense_head).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.geometry.boxes import boxes3d_lidar_to_aligned_bev_boxes
from ..core.geometry.nms import nms_bev
from ..core.voxel import VoxelGrid
from ..core.voxel.sparse_ops import SparseGrid
from ..train import torch_convert
from .anchor_head import (
    AnchorHeadMulti,
    AnchorHeadSingle,
    AnchorTargets,
    anchor_head_loss,
    assign_targets_single_class,
    decode_anchor_predictions,
    generate_anchors,
)
from .backbone_2d import BaseBEVBackbone
from .sparse_backbone import height_compression
from .vfe import DynPillarVFE, MeanVFE

SECOND_CHANNELS = (16, 16, 32, 64, 64)  # the JAX SECONDNet's VoxelBackBone8x default


class AnchorDetectorBase(nn.Module):
    """The anchor-head assembly shared by PointPillar and SECONDNet; a
    subclass builds its trunk, then calls `_setup_head(bev_channels)`, and
    defines `features(batch)` → the head's predictions."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid):
        super().__init__()
        self.model_cfg = model_cfg
        self.class_names = list(class_names)
        self.grid = grid

    def _setup_head(self, bev_channels: int):
        cfg = self.model_cfg
        bb = cfg.BACKBONE_2D
        if bb.NAME != "BaseBEVBackbone":
            raise NotImplementedError(f"BACKBONE_2D {bb.NAME} is not ported")
        self.backbone_2d = BaseBEVBackbone(
            in_channels=bev_channels,
            layer_nums=tuple(bb.LAYER_NUMS), layer_strides=tuple(bb.LAYER_STRIDES),
            num_filters=tuple(bb.NUM_FILTERS), upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
            num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS))
        dh = cfg.DENSE_HEAD
        if dh.get("TARGET_ASSIGNER_CONFIG", {}).get("MATCH_HEIGHT", False):
            raise NotImplementedError("MATCH_HEIGHT (3D IoU target assignment) is not ported")
        self.anchor_cfgs = [dict(c) for c in dh.ANCHOR_GENERATOR_CONFIG]
        anchors, counts = generate_anchors(self.anchor_cfgs, self.grid.grid_size,
                                           self.grid.point_cloud_range)
        self.per_class_shapes = [a.shape[:3] for a in anchors]   # (nz, ny, nx)
        self.per_loc_counts = list(counts)
        flat = np.concatenate([a.reshape(a.shape[0], a.shape[1], a.shape[2], -1, 7)
                               for a in anchors], axis=3).reshape(-1, 7)
        # constants that follow the module's device, outside the state_dict
        self.register_buffer("anchors_flat", torch.from_numpy(flat), persistent=False)
        for ci, a in enumerate(anchors):
            a = torch.from_numpy(a.reshape(-1, 7))
            self.register_buffer(f"anchors_{ci}", a, persistent=False)
            self.register_buffer(f"anchors_bev_{ci}", boxes3d_lidar_to_aligned_bev_boxes(a),
                                 persistent=False)
        num_class = len(self.class_names)
        use_dir = dh.get("USE_DIRECTION_CLASSIFIER", True)
        num_dir_bins = dh.get("NUM_DIR_BINS", 2)
        name = dh.get("NAME", "AnchorHeadSingle")
        if name == "AnchorHeadMulti":
            groups_cfg = dh.get("RPN_HEAD_CFGS", None)
            if groups_cfg:
                groups = [[self.class_names.index(n) for n in g["HEAD_CLS_NAME"]]
                          for g in groups_cfg]
            else:
                groups = [[i] for i in range(num_class)]
            self.dense_head = AnchorHeadMulti(
                self.backbone_2d.out_channels, num_class, groups, counts,
                shared_conv_channels=dh.get("SHARED_CONV_NUM_FILTER", 64),
                use_direction_classifier=use_dir, num_dir_bins=num_dir_bins)
        elif name == "AnchorHeadSingle":
            if dh.get("USE_IOU_HEAD", False):
                raise NotImplementedError("USE_IOU_HEAD (SECONDNetIoU) is not ported yet")
            self.dense_head = AnchorHeadSingle(
                self.backbone_2d.out_channels, num_class, sum(counts),
                use_direction_classifier=use_dir, num_dir_bins=num_dir_bins)
        else:
            raise NotImplementedError(f"DENSE_HEAD {name} is not ported")

    def assign_targets(self, gt_boxes, gt_valid) -> AnchorTargets:
        """Per class, its anchors against the frames' gt of that class, in the
        global class-major per-location layout: labels (B, A), targets
        (B, A, 7), weights (B, A)."""
        b = gt_boxes.shape[0]
        gt = gt_boxes.float()
        classes = gt[..., -1]
        labels, targets, weights = [], [], []
        for ci, acfg in enumerate(self.anchor_cfgs):
            cls_id = self.class_names.index(acfg["class_name"]) + 1
            mask = gt_valid & (classes.int() == cls_id)
            lab, tgt, wgt = assign_targets_single_class(
                getattr(self, f"anchors_{ci}"), gt[..., :7], mask, classes,
                acfg["matched_threshold"], acfg["unmatched_threshold"],
                anchors_bev=getattr(self, f"anchors_bev_{ci}"))
            _, ny, nx = self.per_class_shapes[ci]
            per_loc = self.per_loc_counts[ci]
            labels.append(lab.reshape(-1, ny, nx, per_loc))
            targets.append(tgt.reshape(-1, ny, nx, per_loc, 7))
            weights.append(wgt.reshape(-1, ny, nx, per_loc))
        return AnchorTargets(torch.cat(labels, dim=3).reshape(b, -1),
                             torch.cat(targets, dim=3).reshape(b, -1, 7),
                             torch.cat(weights, dim=3).reshape(b, -1))

    def rpn_loss(self, preds, batch):
        """The head's loss on its predictions: (total, {rpn_loss_cls,
        rpn_loss_loc, rpn_loss_dir, rpn_loss})."""
        targets = self.assign_targets(batch.gt_boxes, batch.gt_valid)
        dh = self.model_cfg.DENSE_HEAD
        lw = dh.LOSS_CONFIG.LOSS_WEIGHTS
        return anchor_head_loss(
            preds, targets, self.anchors_flat, len(self.class_names),
            {"cls_weight": lw["cls_weight"], "loc_weight": lw["loc_weight"],
             "dir_weight": lw.get("dir_weight", 0.2),
             "code_weights": lw.get("code_weights", None)},
            dir_offset=dh.get("DIR_OFFSET", 0.78539), num_dir_bins=dh.get("NUM_DIR_BINS", 2))

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss}).
        The train step's `sampler` and `dropout` generators are not used."""
        return self.rpn_loss(self.features(batch), batch)

    def decode(self, preds):
        """Decoded boxes (B, A, 7) and class scores (B, A, num_class)."""
        dh = self.model_cfg.DENSE_HEAD
        return decode_anchor_predictions(
            preds, self.anchors_flat, len(self.class_names),
            dir_offset=dh.get("DIR_OFFSET", 0.78539), num_dir_bins=dh.get("NUM_DIR_BINS", 2))

    def predict(self, batch):
        """Eval: decode, then class-agnostic rotated NMS per frame, all frames
        in one batched `nms_bev` (detector3d_template.post_processing's
        default path). Returns (boxes (B, S, 7), scores (B, S), labels (B, S)
        1-based, valid (B, S)), S = NMS_POST_MAXSIZE."""
        boxes, cls_scores = self.decode(self.features(batch))
        pp = self.model_cfg.POST_PROCESSING
        nms_cfg = pp.NMS_CONFIG
        max_scores = cls_scores.amax(dim=-1)
        labels = torch.argmax(cls_scores, dim=-1) + 1   # the first maximal class, as JAX
        sel, keep = nms_bev(boxes, max_scores, float(nms_cfg.NMS_THRESH),
                            pre_max=int(nms_cfg.NMS_PRE_MAXSIZE),
                            post_max=int(nms_cfg.NMS_POST_MAXSIZE),
                            valid=max_scores >= float(pp.get("SCORE_THRESH", 0.1)))
        sel_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 7))
        return (sel_boxes, torch.where(keep, torch.gather(max_scores, 1, sel), 0.0),
                torch.where(keep, torch.gather(labels, 1, sel), 0), keep)

    def reference_mapping(self):
        """The reference-key mapping of a checkpoint (train/torch_convert):
        the 2D backbone's and, for AnchorHeadSingle, the head's; the pillar
        VFE's too (PointPillar). The JAX package maps neither the sparse
        backbone nor AnchorHeadMulti: those stay unmapped."""
        m = torch_convert.bev_backbone_mapping(self.backbone_2d.layer_nums)
        if isinstance(self.dense_head, AnchorHeadSingle):
            m.update(torch_convert.anchor_head_mapping(
                use_dir=self.dense_head.use_direction_classifier))
        return m


class PointPillar(AnchorDetectorBase):
    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_pillars: int = 32768):
        super().__init__(model_cfg, class_names, grid)
        vfe_cfg = model_cfg.VFE
        if vfe_cfg.NAME not in ("DynPillarVFE", "PillarVFE", "DynamicPillarVFE"):
            raise NotImplementedError(f"VFE {vfe_cfg.NAME} is not ported")
        self.vfe = DynPillarVFE(
            num_filters=tuple(vfe_cfg.NUM_FILTERS), grid=grid,
            num_point_features=num_point_features, use_norm=vfe_cfg.get("USE_NORM", True),
            use_absolute_xyz=vfe_cfg.get("USE_ABSLOTE_XYZ", True),
            with_distance=vfe_cfg.get("WITH_DISTANCE", False), max_pillars=max_pillars)
        self._setup_head(vfe_cfg.NUM_FILTERS[-1])

    def features(self, batch):
        return self.dense_head(self.backbone_2d(self.vfe(batch.points, batch.points_valid)))

    def reference_mapping(self):
        return {**torch_convert.pfn_mapping(len(self.vfe.num_filters)),
                **super().reference_mapping()}


class SECONDNet(AnchorDetectorBase):
    """MeanVFE (on-device voxelization, `max_voxels` per frame; the JAX
    class's default is 16000, the configs' 60,000 reaches it through the
    CLIs) → VoxelBackBone8x → height_compression → BEV backbone → head."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid)
        from .detectors import backbone_8x

        bb3d = model_cfg.get("BACKBONE_3D", {})
        if bb3d.get("NAME", "VoxelBackBone8x") != "VoxelBackBone8x":
            raise NotImplementedError(f"BACKBONE_3D {bb3d.NAME} with SECONDNet is not ported")
        if model_cfg.VFE.NAME != "MeanVFE":
            raise NotImplementedError(f"VFE {model_cfg.VFE.NAME} with SECONDNet is not ported")
        self.vfe = MeanVFE(grid, max_voxels)
        self.backbone_3d = backbone_8x(bb3d)(
            SparseGrid(*grid.grid_size), voxel_cap=max_voxels, in_channels=num_point_features,
            channels=tuple(bb3d.get("CHANNELS", SECOND_CHANNELS)),
            out_channels=bb3d.get("OUT_CHANNELS", 128))
        self._setup_head(self.backbone_3d.out_grid.nz * bb3d.get("OUT_CHANNELS", 128))

    def spatial_features(self, batch):
        feats, vox = self.vfe(batch.points, batch.points_valid)
        # the strided convs' transpose tables serve the backward only
        levels = self.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                       transpose=self.training)
        st = self.backbone_3d(feats, levels)
        return self.backbone_2d(height_compression(st).to(st.features.dtype))

    def features(self, batch):
        return self.dense_head(self.spatial_features(batch))
