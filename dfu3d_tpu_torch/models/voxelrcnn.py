"""Voxel R-CNN (port of dfu3d_tpu/models/voxelrcnn.py; the reference's
detectors/voxel_rcnn.py and roi_heads/voxelrcnn_head.py):

    MeanVFE → SparseEncoder, or VoxelBackBone8xFocal (stages at strides 1,
    2, 4, 8) → height_compression → BaseBEVBackbone → anchor RPN →
    proposal NMS → per RoI a G³ grid, each grid point pooled from the
    FEATURES_SOURCE stages by NeighborVoxelSA → grid-major flatten →
    SHARED_FC → CLS_FC / REG_FC → cls_pred / reg_pred → canonical decode →
    final NMS

Training adds the anchor loss, the proposal target layer and the RoI
losses, and with the focal trunk its focal layers' loss (loss_box_of_pts).
The JAX package builds SparseEncoder here where the configs name
VoxelBackBone8x, and the port keeps its trunk. The focal trunk with
USE_IMG (voxel_rcnn_focal.yaml, voxel_rcnn_car_focal_multimodal.yaml)
reads a `MultimodalBatch`: its first focal layer's importance conv takes
the first camera's image features at each voxel. Module names follow the
flax tree (encoder, img_c1, img_c2, pool_x_conv2 or, in the legacy
compact RoI schema, pool_stage1, shared_fc, cls_fc, reg_fc, cls_pred,
reg_pred, backbone_2d, dense_head).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.voxel import VoxelGrid
from ..core.voxel.sparse_ops import SparseGrid
from ..train import torch_convert
from . import roi_head
from .backbone_2d import ConvBNReLU
from .image.common import nhwc
from .pointpillar import AnchorDetectorBase
from .sparse_backbone import SparseEncoder, height_compression, voxel_centers_of
from .sparse_backbone_focal import VoxelBackBone8xFocal
from .vfe import MeanVFE

ENCODER_CHANNELS = (16, 16, 32, 64, 64)   # the JAX SparseEncoder's default
STAGE_STRIDES = (1, 2, 4, 8)
STAGE_INDEX = {"x_conv1": 0, "x_conv2": 1, "x_conv3": 2, "x_conv4": 3}
IMAGE_CHANNELS = 16   # the focal trunk's image features per voxel (USE_IMG)


class VoxelTwoStage(roi_head.RoIStage, AnchorDetectorBase):
    """What Voxel R-CNN and PV-RCNN share: MeanVFE, SparseEncoder, the BEV
    backbone and anchor RPN over its height-compressed output, and the RoI
    stage configs."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid)
        bb3d = model_cfg.get("BACKBONE_3D", {})
        self.vfe = MeanVFE(grid, max_voxels)
        self.stage_channels = tuple(bb3d.get("CHANNELS", ENCODER_CHANNELS))[1:]
        out_channels = bb3d.get("OUT_CHANNELS", 128)
        self.encoder = self.build_encoder(bb3d, num_point_features, max_voxels)
        self.bev_channels = self.encoder.out_grid.nz * out_channels
        self._setup_head(self.bev_channels)
        self._setup_roi_stage(model_cfg.get("ROI_HEAD", {}))

    def build_encoder(self, bb3d, num_point_features: int, max_voxels: int):
        """The sparse trunk BACKBONE_3D names: SparseEncoder for
        VoxelBackBone8x, as the JAX package builds it."""
        if bb3d.get("NAME", "VoxelBackBone8x") != "VoxelBackBone8x":
            raise NotImplementedError(f"BACKBONE_3D {bb3d.NAME} with {self.model_cfg.NAME} is "
                                      "not ported")
        return SparseEncoder(SparseGrid(*self.grid.grid_size), max_voxels, num_point_features,
                             tuple(bb3d.get("CHANNELS", ENCODER_CHANNELS)),
                             bb3d.get("OUT_CHANNELS", 128))

    def trunk(self, batch, feats, vox):
        """(conv_out tensor, stages [s1, s2, s4, s8], the trunk's own loss: 0
        here) of the voxelized batch."""
        # the strided convs' transpose tables serve the backward only
        levels = self.encoder.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                   transpose=self.training)
        bev_st, stages = self.encoder(feats, levels)
        return bev_st, stages, torch.zeros((), device=feats.device)

    def backbone(self, batch):
        """(RPN predictions, BEV map (B, ny, nx, C), stages [s1, s2, s4, s8],
        the trunk's loss)."""
        feats, vox = self.vfe(batch.points, batch.points_valid)
        bev_st, stages, trunk_loss = self.trunk(batch, feats, vox)
        bev = height_compression(bev_st).to(bev_st.features.dtype)
        return self.dense_head(self.backbone_2d(bev)), bev, stages, trunk_loss

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
        total, tb = self.two_stage_loss(batch, *self.backbone(batch)[:3], sampler, dropout)
        return total, tb

    def two_stage_loss(self, batch, preds, bev, stages, sampler=None, dropout=None):
        """(RPN loss + source loss + RoI loss, tb) of the trunk's outputs."""
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
        preds, bev, stages, _ = self.backbone(batch)
        rois, _, roi_labels, roi_valid = self.proposals(preds, False)
        sources = self.roi_sources(batch, bev, stages, rois, roi_valid)
        rcnn_cls, rcnn_reg = self.refine(sources, rois, roi_valid)
        refined = roi_head.generate_predicted_boxes(rois[..., :7], rcnn_reg)
        scores = torch.where(roi_valid, torch.sigmoid(rcnn_cls), 0.0)
        return roi_head.final_nms(refined, scores, roi_labels, roi_valid,
                                  self.model_cfg.POST_PROCESSING)


class VoxelRCNN(VoxelTwoStage):
    """Voxel R-CNN with the reference ROI_GRID_POOL schema
    (voxel_rcnn_car.yaml): one NeighborVoxelSA per FEATURES_SOURCE stage
    (pool_{source}); or, without ROI_GRID_POOL, the JAX package's legacy
    compact schema (voxelrcnn.py:100-109): GRID_SIZE, one max-pooling
    NeighborVoxelSA per POOL_STAGES entry s (pool_stage{s}) with its
    POOL_RADII radius and the shared GRID_MLP and GRID_NSAMPLE."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features, max_voxels)
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_GRID_POOL", None)
        if pool_cfg is not None:
            self.roi_grid = int(pool_cfg.get("GRID_SIZE", 6))
            self.pool_sources = tuple(pool_cfg["FEATURES_SOURCE"])
            layers = pool_cfg["POOL_LAYERS"]
            pools = [(f"pool_{src}", STAGE_INDEX[src], roi_head.NeighborVoxelSA(
                self.stage_channels[STAGE_INDEX[src]], tuple(layers[src]["MLPS"][0]),
                float(layers[src]["POOL_RADIUS"][0]), int(layers[src]["NSAMPLE"][0]),
                layers[src].get("POOL_METHOD", "max_pool"))) for src in self.pool_sources]
        else:
            self.roi_grid = int(rh.get("GRID_SIZE", 6))
            self.pool_sources = ()   # no reference layout to map
            mlp, nsample = tuple(rh.get("GRID_MLP", (32, 32))), int(rh.get("GRID_NSAMPLE", 16))
            pools = [(f"pool_stage{s}", s, roi_head.NeighborVoxelSA(
                self.stage_channels[s], mlp, float(r), nsample))
                for s, r in zip(rh.get("POOL_STAGES", (1, 2, 3)),
                                rh.get("POOL_RADII", (0.4, 0.8, 1.6)))]
        self.pool_layers = tuple((name, s) for name, s, _ in pools)
        width = 0
        for name, _, pool in pools:
            self.add_module(name, pool)
            width += pool.out_channels
        dp = float(rh.get("DP_RATIO", 0.3))
        self.shared_fc = roi_head.shared_fc_stack(
            self.roi_grid ** 3 * width, tuple(rh.get("SHARED_FC", rh.get("FC", (256, 256)))), dp)
        c = self.shared_fc.out_channels
        self.cls_fc = roi_head.shared_fc_stack(c, tuple(rh.get("CLS_FC", (256, 256))), dp)
        self.reg_fc = roi_head.shared_fc_stack(c, tuple(rh.get("REG_FC", (256, 256))), dp)
        self.cls_pred = nn.Linear(self.cls_fc.out_channels, 1)
        self.reg_pred = nn.Linear(self.reg_fc.out_channels, 7)

    def build_encoder(self, bb3d, num_point_features: int, max_voxels: int):
        """SparseEncoder, or with BACKBONE_3D VoxelBackBone8xFocal the focal
        trunk, whose USE_IMG stream reads semantic features of the first
        camera's image (img_c1, img_c2: the JAX package's compact stand-in
        for the reference's pretrained DeepLabV3-ResNet-50). SKIP_MASK_KERNEL
        is not read: in the JAX package it changes nothing (dilated voxels
        enter with zero features)."""
        self.focal = bb3d.get("NAME", "") == "VoxelBackBone8xFocal"
        self.use_img = self.focal and bool(bb3d.get("USE_IMG", False))
        if not self.focal:
            return super().build_encoder(bb3d, num_point_features, max_voxels)
        if self.use_img:
            self.img_c1 = ConvBNReLU(3, 32, stride=2)
            self.img_c2 = ConvBNReLU(32, IMAGE_CHANNELS)
        return VoxelBackBone8xFocal(
            SparseGrid(*self.grid.grid_size), max_voxels, num_point_features,
            self.grid.point_cloud_range, self.grid.voxel_size,
            tuple(bb3d.get("CHANNELS", ENCODER_CHANNELS)), bb3d.get("OUT_CHANNELS", 128),
            topk=bb3d.get("TOPK", True), threshold=float(bb3d.get("THRESHOLD", 0.5)),
            kernel_size=int(bb3d.get("KERNEL_SIZE", 3)), mask_multi=bb3d.get("MASK_MULTI", False),
            image_channels=IMAGE_CHANNELS if self.use_img else 0)

    def trunk(self, batch, feats, vox):
        if not self.focal:
            return super().trunk(batch, feats, vox)
        image_feats = None
        if self.use_img:
            if not hasattr(batch, "images"):
                raise TypeError("BACKBONE_3D USE_IMG needs a MultimodalBatch: its focal layer's "
                                "importance conv reads image features (the JAX package "
                                "silently drops them on a PointBatch and changes the conv's "
                                "input width)")
            image_feats = self.voxel_image_feats(batch, vox.voxel_coords, vox.voxel_valid)
        return self.encoder(feats, vox.voxel_coords, vox.voxel_valid, batch.gt_boxes,
                            batch.gt_valid, image_feats)

    def voxel_image_feats(self, batch, coords, valid):
        """Per voxel (B, V, 16) the semantic features of the first camera's
        image at its centre's projection (construct_multimodal_features,
        focal_sparse_conv.py:50-113): the centre projected with
        lidar_to_cam and cam_to_img (fp32), the image-plane position scaled
        to the feature map and truncated to int, that pixel's features, 0
        where the centre lies outside the image, behind the camera or in an
        empty slot."""
        imgs = batch.images[:, 0]
        feat = nhwc(lambda x: self.img_c2(self.img_c1(x)), imgs)
        b, fh, fw, c = feat.shape
        ih, iw = imgs.shape[1:3]
        dev = coords.device
        vs = torch.tensor(self.grid.voxel_size, dtype=torch.float32, device=dev)
        lo = torch.tensor(self.grid.point_cloud_range[:3], dtype=torch.float32, device=dev)
        with torch.autocast(dev.type, enabled=False):
            centers = (coords.float() + 0.5) * vs + lo
            hom = torch.cat([centers, centers.new_ones(centers.shape[:-1] + (1,))], dim=-1)
            cam = torch.einsum("bij,bvj->bvi", batch.lidar_to_cam[:, 0].float(), hom)
            img_pt = torch.einsum("bij,bvj->bvi", batch.cam_to_img[:, 0].float(), cam)
        depth = torch.clamp(img_pt[..., 2], min=1e-3)
        u = img_pt[..., 0] / depth
        v = img_pt[..., 1] / depth
        inside = valid & (img_pt[..., 2] > 0) & (u >= 0) & (u < iw) & (v >= 0) & (v < ih)
        fu = torch.clamp((u * fw / iw).to(torch.int32), 0, fw - 1).long()
        fv = torch.clamp((v * fh / ih).to(torch.int32), 0, fh - 1).long()
        sampled = torch.gather(feat.reshape(b, fh * fw, c), 1,
                               (fv * fw + fu)[..., None].expand(-1, -1, c))
        return torch.where(inside[..., None], sampled, 0)

    def refine(self, stages, rois, roi_valid, dropout=None):
        """roi_grid_pool (voxelrcnn_head.py:106-191), the grid-major flatten
        of `pooled_features.view(N, -1)` (:232-238), the FC towers."""
        pts, valid = self.grid_points(rois, roi_valid)
        parts = []
        for name, s in self.pool_layers:
            st = stages[s]
            parts.append(getattr(self, name)(pts, valid, self.stage_centers(stages, s),
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
        preds, bev, stages, focal_loss = self.backbone(batch)
        total, tb = self.two_stage_loss(batch, preds, bev, stages, sampler, dropout)
        tb["loss_box_of_pts"] = focal_loss
        return total + focal_loss, tb

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) and VoxelRCNNHead's (pool
        layers, FC towers, pred layers); the sparse backbone and the compact
        schema's pools, which have no reference layout, stay unmapped."""
        return {**super().reference_mapping(),
                **torch_convert.voxelrcnn_head_mapping(
                    self.shared_fc.num, self.cls_fc.num, self.reg_fc.num, self.pool_sources)}
