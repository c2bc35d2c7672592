"""CaDDN, the monocular camera detector (port of dfu3d_tpu/models/caddn.py;
reference pcdet/models/detectors/caddn.py and backbones_3d/vfe/image_vfe.py):

    images → DDN (DDNDeepLabV3 over ResNet-101 as CaDDN.yaml names it, or the
    compact DDN) → CHANNEL_REDUCE (1×1 conv, BN, ReLU) → frustum features
    (depth probabilities without the "beyond" bin ⊗ features) → per camera
    `frustum_to_voxel` at every voxel centre of the grid, summed over the
    cameras → Conv2DCollapse (z · C → NUM_BEV_FEATURES) → BaseBEVBackbone →
    AnchorHeadSingle

through the port's `AnchorDetectorBase` (anchors, targets, the anchor loss,
decode and class-agnostic NMS). Training adds LOSS.WEIGHT × the DDN's focal
depth loss against the depth maps resized to the logits' grid (nearest, as
jax.image.resize does it). Module names follow the flax tree (ddn,
channel_reduce_conv, channel_reduce_bn, conv2d_collapse, collapse_bn,
backbone_2d, dense_head). It reads a `MultimodalBatch`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.voxel import VoxelGrid
from .image.common import image_bn, nhwc, resize_nearest
from .image.ddn import DDN, ddn_depth_loss, frustum_to_voxel
from .image.deeplab import RESNET_LAYERS, DDNDeepLabV3
from .pointpillar import AnchorDetectorBase


def voxel_centers(grid: VoxelGrid) -> np.ndarray:
    """(nx · ny · nz, 3) fp32 centres of every voxel of the grid, x slowest
    and z fastest."""
    nx, ny, nz = grid.grid_size
    pcr = np.asarray(grid.point_cloud_range, np.float32)
    vs = np.asarray(grid.voxel_size, np.float32)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    centers = np.stack([ix, iy, iz], axis=-1).astype(np.float32)
    return ((centers + 0.5) * vs + pcr[:3]).reshape(-1, 3)


class CaDDN(AnchorDetectorBase):
    """`num_point_features` and `max_voxels` (the CLIs pass them) are not
    read: CaDDN reads no points."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels=None):
        super().__init__(model_cfg, class_names, grid)
        vfe = model_cfg.get("VFE", {})
        ddn_cfg = vfe.get("DDN", {})
        disc = vfe.get("DISC_CFG", {})
        self.num_depth_bins = int(disc.get("num_bins", 80))
        self.depth_min = float(disc.get("depth_min", 2.0))
        self.depth_max = float(disc.get("depth_max", 46.8))
        ddn_name = str(ddn_cfg.get("NAME", "DDNCompact"))
        if ddn_name == "DDNDeepLabV3":
            layers = (tuple(ddn_cfg["LAYERS"]) if "LAYERS" in ddn_cfg
                      else RESNET_LAYERS[str(ddn_cfg.get("BACKBONE_NAME", "ResNet101"))])
            self.ddn = DDNDeepLabV3(self.num_depth_bins + 1, layers)
        else:
            self.ddn = DDN(self.num_depth_bins, int(ddn_cfg.get("FEAT_CHANNELS", 64)),
                           tuple(ddn_cfg.get("STEM_CHANNELS", (16, 32, 64))))
        feat_ch = self.ddn.out_channels
        cr = vfe.get("CHANNEL_REDUCE",
                     {"out_channels": 64} if ddn_name == "DDNDeepLabV3" else None)
        self.reduce = bool(cr)
        if cr:
            out = int(cr.get("out_channels", 64))
            self.channel_reduce_conv = torch.nn.Conv2d(feat_ch, out, 1, bias=False)
            self.channel_reduce_bn = image_bn(out)
            feat_ch = out
        self.depth_loss_weight = float(vfe.get("LOSS", {}).get("WEIGHT", 3.0))
        bev = int(model_cfg.get("MAP_TO_BEV", {}).get("NUM_BEV_FEATURES", 64))
        nz = grid.grid_size[2]
        self.conv2d_collapse = torch.nn.Conv2d(nz * feat_ch, bev, 1, bias=False)
        self.collapse_bn = image_bn(bev)
        self.register_buffer("voxel_centers", torch.from_numpy(voxel_centers(grid)),
                             persistent=False)
        self._setup_head(bev)

    def image_features(self, images, dropout=None):
        """(features (B·N, fH, fW, C) after CHANNEL_REDUCE, depth logits
        (B·N, fH, fW, D + 1) fp32) of images (B, N, H, W, 3)."""
        b, n, ih, iw = images.shape[:4]
        imgs = images.reshape(b * n, ih, iw, 3)
        if isinstance(self.ddn, DDNDeepLabV3):
            feats, logits = self.ddn(imgs, dropout)
        else:
            feats, logits = self.ddn(imgs)
        if self.reduce:
            feats = nhwc(lambda x: F.relu(self.channel_reduce_bn(self.channel_reduce_conv(x))),
                         feats)
        return feats, logits

    def frustum_features(self, feats, depth_logits):
        """(B·N, D, fH, fW, C) fp32: the depth probabilities but the beyond
        bin ⊗ the features."""
        probs = torch.softmax(depth_logits, dim=-1)[..., :self.num_depth_bins]
        return probs.permute(0, 3, 1, 2)[..., None] * feats.float()[:, None]

    def voxel_features(self, frustum, batch):
        """(B, nx, ny, nz, C) fp32: each camera's frustum sampled at every
        voxel centre, summed over the cameras."""
        b, n, ih, iw = batch.images.shape[:4]
        vox, _ = frustum_to_voxel(frustum, self.voxel_centers,
                                  batch.lidar_to_cam.reshape(b * n, 4, 4),
                                  batch.cam_to_img.reshape(b * n, 3, 4), self.num_depth_bins,
                                  self.depth_min, self.depth_max, (ih, iw))
        nx, ny, nz = self.grid.grid_size
        return vox.view(b, n, nx, ny, nz, -1).sum(dim=1)

    def collapse(self, vox, dtype):
        """Conv2DCollapse: (B, nx, ny, nz, C) → (B, ny, nx, NUM_BEV_FEATURES)."""
        b, nx, ny, nz, c = vox.shape
        bev = vox.permute(0, 2, 1, 3, 4).reshape(b, ny, nx, nz * c).to(dtype)
        return nhwc(lambda x: F.relu(self.collapse_bn(self.conv2d_collapse(x))), bev)

    def features(self, batch, dropout=None):
        """The anchor head's predictions, with "depth_logits" added."""
        feats, depth_logits = self.image_features(batch.images, dropout)
        vox = self.voxel_features(self.frustum_features(feats, depth_logits), batch)
        preds = self.dense_head(self.backbone_2d(self.collapse(vox, feats.dtype)))
        preds["depth_logits"] = depth_logits
        return preds

    def depth_loss(self, depth_logits, depth_maps):
        """The DDN's focal loss against the depth maps (B, N, H, W) resized
        (nearest) to the logits' grid."""
        b, n = depth_maps.shape[:2]
        sparse = resize_nearest(depth_maps.reshape(b * n, *depth_maps.shape[2:]),
                                depth_logits.shape[1:3])
        return ddn_depth_loss(depth_logits, sparse, self.num_depth_bins, self.depth_min,
                              self.depth_max)

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        depth_loss}); `dropout` drives DeepLab's ASPP dropout."""
        preds = self.features(batch, dropout)
        total, tb = self.rpn_loss(preds, batch)
        d_loss = self.depth_loss(preds["depth_logits"], batch.depth_maps)
        tb["depth_loss"] = d_loss
        return total + self.depth_loss_weight * d_loss, tb

    def reference_mapping(self):
        raise NotImplementedError(
            "CaDDN has no reference mapping: the JAX package composes none for it "
            "(train/torch_convert.py has deeplab_ddn_mapping for its DDN alone, which "
            "train.torch_convert.deeplab_ddn_mapping copies)")
