"""TransFusion-L, the LiDAR-only TransFusion detector (port of
dfu3d_tpu/models/bevfusion.py TransFusion; reference pcdet
detectors/transfusion.py):

    MeanVFE → VoxelResBackBone8x or VoxelBackBone8x (kernel B2) →
    height_compression → BaseBEVBackbone → TransFusionHead

`forward` is the train loss (the head's matching and losses), `predict` the
decoded queries with `keep = scores > 0`: no NMS, as in the JAX package,
though the reference config sets one. The trunk is the one BACKBONE_3D
names, as the JAX package's CenterPoint builds it; a config without a NAME
builds VoxelBackBone8x. (The JAX TransFusion builds VoxelBackBone8x
whatever the name, so it cannot build the shipped transfusion_lidar.yaml,
whose VoxelResBackBone8x has four CHANNELS.)
"""
from __future__ import annotations

from torch import nn

from ..core.voxel import VoxelGrid
from ..core.voxel.sparse_ops import SparseGrid
from ..train import torch_convert
from ..utils.config import CfgDict
from .backbone_2d import BaseBEVBackbone
from .sparse_backbone import height_compression
from .transfusion_head import TransFusionHead
from .vfe import MeanVFE


class TransFusion(nn.Module):
    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000, bev_channels=None):
        """`bev_channels`: the 2D backbone's input width where it is not the
        trunk's height-compressed width (BevFusion's fuser)."""
        super().__init__()
        from .detectors import DEFAULT_CHANNELS, backbone_8x

        cfg = model_cfg
        self.model_cfg = cfg
        self.class_names = list(class_names)
        if cfg.get("VFE") and cfg.VFE.NAME != "MeanVFE":
            raise NotImplementedError(f"VFE {cfg.VFE.NAME} with TransFusion is not ported")
        bb3d = CfgDict(cfg.get("BACKBONE_3D") or {})
        bb3d.NAME = bb3d.get("NAME") or "VoxelBackBone8x"
        self.vfe = MeanVFE(grid, max_voxels)
        self.backbone_3d = backbone_8x(bb3d)(
            SparseGrid(*grid.grid_size), voxel_cap=max_voxels, in_channels=num_point_features,
            channels=tuple(bb3d.get("CHANNELS", DEFAULT_CHANNELS[bb3d.NAME])),
            out_channels=bb3d.get("OUT_CHANNELS", 128))
        self.lidar_channels = self.backbone_3d.out_grid.nz * bb3d.get("OUT_CHANNELS", 128)
        bb = cfg.BACKBONE_2D
        if bb.get("NAME", "BaseBEVBackbone") != "BaseBEVBackbone":
            raise NotImplementedError(f"BACKBONE_2D {bb.NAME} with TransFusion is not ported")
        self.backbone_2d = BaseBEVBackbone(
            in_channels=bev_channels or self.lidar_channels,
            layer_nums=tuple(bb.LAYER_NUMS), layer_strides=tuple(bb.LAYER_STRIDES),
            num_filters=tuple(bb.NUM_FILTERS), upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
            num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS))
        dh = cfg.DENSE_HEAD
        if dh.NAME != "TransFusionHead":
            raise NotImplementedError(f"DENSE_HEAD {dh.NAME} with TransFusion is not ported")
        tac = dh.get("TARGET_ASSIGNER_CONFIG", {})
        self.dense_head = TransFusionHead(
            in_channels=self.backbone_2d.out_channels, num_class=len(self.class_names),
            point_cloud_range=grid.point_cloud_range, voxel_size=grid.voxel_size,
            num_proposals=int(dh.get("NUM_PROPOSALS", 200)),
            hidden=int(dh.get("HIDDEN_CHANNEL", 128)), num_heads=int(dh.get("NUM_HEADS", 8)),
            ffn_channel=int(dh.get("FFN_CHANNEL", 256)),
            num_hm_conv=int(dh.get("NUM_HM_CONV", 2)),
            nms_kernel_size=int(dh.get("NMS_KERNEL_SIZE", 3)),
            use_vel="vel" in list(dh.get("SEPARATE_HEAD_CFG", {}).get("HEAD_ORDER", [])),
            dataset_name=str(tac.get("DATASET", "nuScenes")),
            use_bias_before_norm=bool(dh.get("USE_BIAS_BEFORE_NORM", False)),
            keep=1.0 - float(dh.get("BN_MOMENTUM", 0.1)),
            feature_map_stride=int(tac.get("FEATURE_MAP_STRIDE", 8)),
            matcher=str(dh.get("MATCHER", "auto")))

    def lidar_bev(self, batch):
        """The trunk's height-compressed map (B, ny, nx, nz · C) of a batch's points."""
        feats, vox = self.vfe(batch.points, batch.points_valid)
        # the strided convs' transpose tables serve the backward only
        levels = self.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                       transpose=self.training)
        st = self.backbone_3d(feats, levels)
        return height_compression(st).to(st.features.dtype)

    def bev(self, batch):
        """The 2D backbone's map (B, H, W, C) of a PointBatch."""
        return self.backbone_2d(self.lidar_bev(batch))

    def features(self, batch):
        return self.dense_head(self.bev(batch))

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {tf_cls_loss, tf_reg_loss, tf_hm_loss}). The train
        step's `sampler` and `dropout` generators are not used."""
        lw = self.model_cfg.DENSE_HEAD.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
        return self.dense_head.loss(self.features(batch), batch.gt_boxes, batch.gt_valid,
                                    dict(lw))

    def predict(self, batch):
        """Eval: (boxes (B, Q, 7 or 9), scores (B, Q), labels (B, Q) 1-based,
        keep = scores > 0)."""
        boxes, scores, labels = self.dense_head.decode(self.features(batch))
        return boxes, scores, labels, scores > 0.0

    def reference_mapping(self):
        """The reference-key mapping of a checkpoint (train/torch_convert):
        the 2D backbone's and the head's; the sparse trunk stays unmatched,
        as in the JAX package."""
        dh = self.dense_head
        return {**torch_convert.bev_backbone_mapping(self.backbone_2d.layer_nums),
                **torch_convert.transfusion_head_mapping(
                    num_conv=dict((n, c) for n, _, c in dh.branches)["center"],
                    num_hm_conv=dict((n, c) for n, _, c in dh.branches)["heatmap"],
                    use_vel=any(n == "vel" for n, _, _ in dh.branches))}
