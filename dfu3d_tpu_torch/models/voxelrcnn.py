"""Voxel R-CNN (port of dfu3d_tpu/models/voxelrcnn.py, the non-focal path;
the reference's detectors/voxel_rcnn.py and roi_heads/voxelrcnn_head.py):

    MeanVFE → SparseEncoder (stages at strides 1, 2, 4, 8) →
    height_compression → BaseBEVBackbone → anchor RPN → proposal NMS →
    per RoI a G³ grid, each grid point pooled from the FEATURES_SOURCE
    stages by NeighborVoxelSA → grid-major flatten → SHARED_FC → CLS_FC /
    REG_FC → cls_pred / reg_pred → canonical decode → final NMS

Training adds the anchor loss, the proposal target layer and the RoI
losses. The JAX package builds SparseEncoder here where the configs name
VoxelBackBone8x, and the port keeps its trunk. Module names follow the flax
tree (encoder, pool_x_conv2, shared_fc, cls_fc, reg_fc, cls_pred, reg_pred,
backbone_2d, dense_head). The focal backbone (VoxelBackBone8xFocal) and the
legacy compact RoI schema (POOL_STAGES, POOL_RADII, GRID_MLP) are not
ported and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.voxel import VoxelGrid
from ..core.voxel.sparse_ops import SparseGrid
from ..train import torch_convert
from . import roi_head
from .pointpillar import AnchorDetectorBase
from .sparse_backbone import SparseEncoder, height_compression, voxel_centers_of
from .vfe import MeanVFE

ENCODER_CHANNELS = (16, 16, 32, 64, 64)   # the JAX SparseEncoder's default
STAGE_STRIDES = (1, 2, 4, 8)
STAGE_INDEX = {"x_conv1": 0, "x_conv2": 1, "x_conv3": 2, "x_conv4": 3}


class VoxelTwoStage(roi_head.RoIStage, AnchorDetectorBase):
    """What Voxel R-CNN and PV-RCNN share: MeanVFE, SparseEncoder, the BEV
    backbone and anchor RPN over its height-compressed output, and the RoI
    stage configs."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid)
        bb3d = model_cfg.get("BACKBONE_3D", {})
        if bb3d.get("NAME", "VoxelBackBone8x") != "VoxelBackBone8x":
            raise NotImplementedError(f"BACKBONE_3D {bb3d.NAME} with {model_cfg.NAME} is not "
                                      "ported (the focal backbone among them)")
        self.vfe = MeanVFE(grid, max_voxels)
        self.stage_channels = tuple(bb3d.get("CHANNELS", ENCODER_CHANNELS))[1:]
        out_channels = bb3d.get("OUT_CHANNELS", 128)
        self.encoder = SparseEncoder(SparseGrid(*grid.grid_size), max_voxels, num_point_features,
                                     tuple(bb3d.get("CHANNELS", ENCODER_CHANNELS)), out_channels)
        self.bev_channels = self.encoder.out_grid.nz * out_channels
        self._setup_head(self.bev_channels)
        self._setup_roi_stage(model_cfg.get("ROI_HEAD", {}))

    def backbone(self, batch):
        """(RPN predictions, BEV map (B, ny, nx, C), stages [s1, s2, s4, s8])."""
        feats, vox = self.vfe(batch.points, batch.points_valid)
        # the strided convs' transpose tables serve the backward only
        levels = self.encoder.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                   transpose=self.training)
        bev_st, stages = self.encoder(feats, levels)
        bev = height_compression(bev_st).to(bev_st.features.dtype)
        return self.dense_head(self.backbone_2d(bev)), bev, stages

    def features(self, batch):
        return self.backbone(batch)[0]

    def stage_centers(self, stages, s: int):
        return voxel_centers_of(stages[s], self.grid.point_cloud_range, self.grid.voxel_size,
                                STAGE_STRIDES[s])

    def grid_points(self, rois, roi_valid):
        """The RoIs' G³ grid points flattened per frame, (B, R·G³, 3), and
        their validity."""
        g3 = self.roi_grid ** 3
        pts = roi_head.global_grid_points(rois[..., :7], self.roi_grid)
        b, r = pts.shape[:2]
        return pts.reshape(b, r * g3, 3), roi_valid.repeat_interleave(g3, dim=1)

    def roi_sources(self, batch, bev, stages, rois, roi_valid):
        """What the RoI head pools from, given the RoIs it will pool: here
        the encoder's stages."""
        return stages

    def source_loss(self, batch, sources):
        """A loss on the pooled sources beyond the RPN's and the RoI head's:
        (loss, tb entries); none here."""
        return 0.0, {}

    def refine(self, sources, rois, roi_valid, dropout=None):
        """(rcnn_cls (B, R), rcnn_reg (B, R, 7)), fp32."""
        raise NotImplementedError

    def forward(self, batch, sampler=None, dropout=None):
        preds, bev, stages = self.backbone(batch)
        total, tb = self.rpn_loss(preds, batch)
        tgt = self.sample_rois(preds, batch, sampler)
        b, m = tgt["rois"].shape[:2]
        # every sampled slot is a RoI, a zeroed padding proposal included
        roi_valid = torch.ones((b, m), dtype=torch.bool, device=tgt["rois"].device)
        sources = self.roi_sources(batch, bev, stages, tgt["rois"], roi_valid)
        extra, extra_tb = self.source_loss(batch, sources)
        rcnn_cls, rcnn_reg = self.refine(sources, tgt["rois"], roi_valid, dropout)
        rcnn_loss, rtb = self.roi_loss(rcnn_cls, rcnn_reg, tgt)
        total = total + extra + rcnn_loss
        tb.update(extra_tb)
        tb.update({"rcnn_cls_loss": rtb["rcnn_loss_cls"],
                   "rcnn_reg_loss": rtb["rcnn_loss_reg_total"]})
        return total, tb

    def predict(self, batch):
        """Eval: (boxes (B, S, 7), scores, labels, valid), S = the final
        NMS's post size."""
        preds, bev, stages = self.backbone(batch)
        rois, _, roi_labels, roi_valid = self.proposals(preds, False)
        sources = self.roi_sources(batch, bev, stages, rois, roi_valid)
        rcnn_cls, rcnn_reg = self.refine(sources, rois, roi_valid)
        refined = roi_head.generate_predicted_boxes(rois[..., :7], rcnn_reg)
        scores = torch.where(roi_valid, torch.sigmoid(rcnn_cls), 0.0)
        return roi_head.final_nms(refined, scores, roi_labels, roi_valid,
                                  self.model_cfg.POST_PROCESSING)


class VoxelRCNN(VoxelTwoStage):
    """Voxel R-CNN with the reference ROI_GRID_POOL schema
    (voxel_rcnn_car.yaml): one NeighborVoxelSA per FEATURES_SOURCE stage."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features, max_voxels)
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_GRID_POOL", None)
        if pool_cfg is None:
            raise NotImplementedError("the legacy compact RoI schema (POOL_STAGES, POOL_RADII, "
                                      "GRID_MLP) is not ported; ROI_GRID_POOL is")
        self.roi_grid = int(pool_cfg.get("GRID_SIZE", 6))
        self.pool_sources = tuple(pool_cfg["FEATURES_SOURCE"])
        layers = pool_cfg["POOL_LAYERS"]
        width = 0
        for src in self.pool_sources:
            lc = layers[src]
            pool = roi_head.NeighborVoxelSA(
                self.stage_channels[STAGE_INDEX[src]], tuple(lc["MLPS"][0]),
                float(lc["POOL_RADIUS"][0]), int(lc["NSAMPLE"][0]),
                lc.get("POOL_METHOD", "max_pool"))
            self.add_module(f"pool_{src}", pool)
            width += pool.out_channels
        dp = float(rh.get("DP_RATIO", 0.3))
        self.shared_fc = roi_head.shared_fc_stack(
            self.roi_grid ** 3 * width, tuple(rh.get("SHARED_FC", rh.get("FC", (256, 256)))), dp)
        c = self.shared_fc.out_channels
        self.cls_fc = roi_head.shared_fc_stack(c, tuple(rh.get("CLS_FC", (256, 256))), dp)
        self.reg_fc = roi_head.shared_fc_stack(c, tuple(rh.get("REG_FC", (256, 256))), dp)
        self.cls_pred = nn.Linear(self.cls_fc.out_channels, 1)
        self.reg_pred = nn.Linear(self.reg_fc.out_channels, 7)

    def refine(self, stages, rois, roi_valid, dropout=None):
        """roi_grid_pool (voxelrcnn_head.py:106-191), the grid-major flatten
        of `pooled_features.view(N, -1)` (:232-238), the FC towers."""
        pts, valid = self.grid_points(rois, roi_valid)
        parts = []
        for src in self.pool_sources:
            s = STAGE_INDEX[src]
            st = stages[s]
            parts.append(getattr(self, f"pool_{src}")(pts, valid, self.stage_centers(stages, s),
                                                      st.features.float(), st.valid))
        b, r = rois.shape[:2]
        pooled = torch.cat(parts, dim=-1).reshape(b * r, -1)
        h = self.shared_fc(pooled, dropout)
        cls = self.cls_pred(self.cls_fc(h, dropout))
        reg = self.reg_pred(self.reg_fc(h, dropout))
        return cls.reshape(b, r).float(), reg.reshape(b, r, 7).float()

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        rcnn_cls_loss, rcnn_reg_loss, loss_box_of_pts}) as JAX's
        VoxelRCNN.__call__ (loss_box_of_pts, the focal layers' loss, is 0
        here). `sampler` draws the proposal target layer's uniforms;
        `dropout` drives the FC dropout."""
        total, tb = super().forward(batch, sampler, dropout)
        tb["loss_box_of_pts"] = torch.zeros((), device=total.device)
        return total, tb

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) and VoxelRCNNHead's (pool
        layers, FC towers, pred layers); the sparse backbone stays
        unmapped."""
        return {**super().reference_mapping(),
                **torch_convert.voxelrcnn_head_mapping(
                    self.shared_fc.num, self.cls_fc.num, self.reg_fc.num, self.pool_sources)}
