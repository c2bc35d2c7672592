"""BEVFusion, the LiDAR + camera detector (port of dfu3d_tpu/models/
bevfusion.py BevFusion and ConvFuser; reference pcdet/models/detectors/
bevfusion.py):

    lidar:  TransFusion's MeanVFE → the trunk BACKBONE_3D names (kernel B2)
            → height_compression
    camera: SwinTransformer → GeneralizedLSSFPN (its first level) →
            DepthLSSTransform (depth net, geometry, bev_pool)
    the camera BEV resized bilinearly to the lidar BEV where the grids
    differ → ConvFuser (concat, 3×3 conv, BN, ReLU) → BaseBEVBackbone →
    TransFusionHead

A subclass of the port's TransFusion: its trunk, 2D backbone (on the
fuser's channels) and head, its loss and its decode (no NMS). The JAX
BevFusion inherits a setup that builds VoxelBackBone8x whatever BACKBONE_3D
names, so it cannot build the shipped bevfusion.yaml (whose base config's
VoxelResBackBone8x has four CHANNELS); the port builds the named trunk, as
its TransFusion does. It reads a `MultimodalBatch`. Module names follow
the flax tree (image_backbone, image_neck, vtransform, fuser.conv,
fuser.bn).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.voxel import VoxelGrid
from .image.common import image_bn, nhwc, resize_bilinear
from .image.depth_lss import DepthLSSTransform
from .image.fpn import GeneralizedLSSFPN
from .image.swin import SwinTransformer
from .transfusion import TransFusion


class ConvFuser(nn.Module):
    """concat(camera BEV, lidar BEV) → 3×3 conv (no bias) → BN → ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn = image_bn(out_channels)

    def forward(self, cam_bev, lidar_bev):
        x = torch.cat([cam_bev, lidar_bev.to(cam_bev.dtype)], dim=-1)
        return nhwc(lambda t: F.relu(self.bn(self.conv(t))), x)


class BevFusion(TransFusion):
    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        cfg = model_cfg
        fuser_ch = int(cfg.get("FUSER", {}).get("OUT_CHANNEL", 128))
        super().__init__(cfg, class_names, grid, num_point_features, max_voxels,
                         bev_channels=fuser_ch)
        ib = cfg.get("IMAGE_BACKBONE", {})
        self.image_backbone = SwinTransformer(
            embed_dim=int(ib.get("EMBED_DIMS", 96)), depths=tuple(ib.get("DEPTHS", (2, 2, 6))),
            num_heads=tuple(ib.get("NUM_HEADS", (3, 6, 12))),
            window_size=int(ib.get("WINDOW_SIZE", 7)), patch_size=int(ib.get("PATCH_SIZE", 4)),
            out_indices=tuple(ib.get("OUT_INDICES", (0, 1, 2))))
        neck = cfg.get("NECK", {})
        neck_ch = int(neck.get("OUT_CHANNELS", 128))
        self.image_neck = GeneralizedLSSFPN(
            tuple(neck.get("IN_CHANNELS", self.image_backbone.out_channels)), neck_ch, num_outs=1)
        vt = cfg.get("VTRANSFORM", {})
        pcr, vs = list(grid.point_cloud_range), list(grid.voxel_size)
        self.vtransform = DepthLSSTransform(
            in_channel=neck_ch, out_channel=int(vt.get("OUT_CHANNEL", 80)),
            image_size=tuple(vt.get("IMAGE_SIZE", (256, 704))),
            feature_size=tuple(vt.get("FEATURE_SIZE", (32, 88))),
            xbound=list(vt.get("XBOUND", [pcr[0], pcr[3], vs[0] * 8])),
            ybound=list(vt.get("YBOUND", [pcr[1], pcr[4], vs[1] * 8])),
            zbound=list(vt.get("ZBOUND", [pcr[2], pcr[5], pcr[5] - pcr[2]])),
            dbound=list(vt.get("DBOUND", [1.0, 60.0, 0.5])),
            downsample=int(vt.get("DOWNSAMPLE", 1)))
        cam_ch = self.vtransform.out_channel * (self.vtransform.grid[2]
                                                if self.vtransform.downsample == 1 else 1)
        self.fuser = ConvFuser(cam_ch + self.lidar_channels, fuser_ch)

    def camera_bev(self, batch):
        """The camera BEV (B, ny, nx, C) of a MultimodalBatch's images."""
        b, n, ih, iw = batch.images.shape[:4]
        stages = self.image_backbone(batch.images.reshape(b * n, ih, iw, 3))
        feats = self.image_neck(stages)[0]
        feats = feats.reshape(b, n, *feats.shape[1:])
        return self.vtransform(feats, batch.depth_maps, batch.cam2lidar_rots,
                               batch.cam2lidar_trans, batch.cam_intrinsics)

    def bev(self, batch):
        """The 2D backbone's map (B, H, W, C): the lidar and camera BEVs fused."""
        lidar_bev = self.lidar_bev(batch)
        cam_bev = resize_bilinear(self.camera_bev(batch), lidar_bev.shape[1:3])
        return self.backbone_2d(self.fuser(cam_bev, lidar_bev))

    def reference_mapping(self):
        raise NotImplementedError(
            "BevFusion has no reference mapping: the JAX package composes none for it "
            "(train/torch_convert.py has swin_mapping and lss_fpn_mapping for its image "
            "backbone and neck alone, which train.torch_convert copies)")
