"""CaDDN's depth-distribution network and frustum sampling (port of
dfu3d_tpu/models/image/ddn.py; reference backbones_3d/vfe/image_vfe_modules):

* `bin_depths_lid`: depth → continuous LID bin index;
* `DDN`: the compact residual encoder (down{i} / res{i} blocks, feat_out,
  depth_out with D + 1 logits, the last the "beyond range" bin), the JAX
  package's stand-in for the torchvision DeepLabV3 (image/deeplab.py);
* `frustum_to_voxel`: every voxel centre projected into (u, v, LID bin),
  trilinear sampling of the (D, fH, fW, C) frustum, with the depth
  sanitised before the divisions and an `ok` mask of the samples inside;
* `ddn_depth_loss`: the focal depth-bin classification against projected
  LiDAR depth, pixels without depth masked out.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import StridedConv1x1, image_bn


def bin_depths_lid(depth, d: int, dmin: float, dmax: float):
    """Continuous LID bin index of `depth` (reference transform_utils.bin_depths, mode LID)."""
    bin_size = 2 * (dmax - dmin) / (d * (1 + d))
    arg = torch.clamp(1 + 8 * (depth - dmin) / bin_size, min=0.0)
    return -0.5 + 0.5 * torch.sqrt(arg)


class ResBlock(nn.Module):
    """conv 3×3 (stride) → BN → ReLU → conv 3×3 → BN, plus the input (a
    strided or widening 1×1 conv `short` where the shape changes), ReLU;
    flax's auto names Conv_0, BatchNorm_0, Conv_1, BatchNorm_1."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, ch, 3, stride, 1, bias=False)
        self.BatchNorm_0 = image_bn(ch)
        self.Conv_1 = nn.Conv2d(ch, ch, 3, 1, 1, bias=False)
        self.BatchNorm_1 = image_bn(ch)
        self.short = StridedConv1x1(cin, ch, stride) if stride != 1 or cin != ch else None

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        idn = self.short(x) if self.short is not None else x
        return F.relu(y + idn.to(y.dtype))


class DDN(nn.Module):
    """images (B, H, W, 3) → (features (B, fH, fW, C), depth logits
    (B, fH, fW, D + 1) fp32)."""

    def __init__(self, num_depth_bins: int, feat_channels: int = 64,
                 stem_channels: Sequence[int] = (16, 32, 64)):
        super().__init__()
        cin = 3
        for i, ch in enumerate(stem_channels):
            self.add_module(f"down{i}", ResBlock(cin, ch, 2))
            self.add_module(f"res{i}", ResBlock(ch, ch))
            cin = ch
        self.num_stem = len(stem_channels)
        self.out_channels = feat_channels
        self.feat_out = nn.Conv2d(cin, feat_channels, 1)
        self.depth_out = nn.Conv2d(cin, num_depth_bins + 1, 1)

    def forward(self, images):
        def net(x):
            for i in range(self.num_stem):
                x = getattr(self, f"res{i}")(getattr(self, f"down{i}")(x))
            return self.feat_out(x), self.depth_out(x).float()

        feats, logits = net(images.permute(0, 3, 1, 2))
        return feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)


def frustum_to_voxel(frustum_feats, voxel_centers, lidar_to_cam, cam_to_img, d: int,
                     dmin: float, dmax: float, image_size):
    """Sample each camera's frustum at every voxel centre.

    frustum_feats (N, D, fH, fW, C) fp32, voxel_centers (V, 3) lidar xyz,
    lidar_to_cam (N, 4, 4), cam_to_img (N, 3, 4) → ((N, V, C) features, 0
    outside the frustum; (N, V) in-frustum mask). Geometry in fp32, also
    under autocast."""
    n, dd, fh, fw, c = frustum_feats.shape
    ih, iw = image_size
    v = voxel_centers.shape[0]
    with torch.autocast(frustum_feats.device.type, enabled=False):
        hom = torch.cat([voxel_centers, voxel_centers.new_ones((v, 1))], dim=1)
        cam = torch.matmul(hom, lidar_to_cam.float().transpose(1, 2))          # (N, V, 4)
        c2i = cam_to_img.float()
        img = torch.matmul(cam[..., :3], c2i[:, :, :3].transpose(1, 2)) + c2i[:, None, :, 3]
    depth = img[..., 2]
    # sanitised before the divisions: voxels behind the camera would put
    # inf / NaN into the graph and poison gradients through the final mask
    depth_safe = torch.where(depth > 1e-3, depth, 1.0)
    fu = img[..., 0] / depth_safe * (fw / iw)
    fv = img[..., 1] / depth_safe * (fh / ih)
    fd = bin_depths_lid(depth, d, dmin, dmax)
    ok = ((depth > 0) & (fu >= 0) & (fu <= fw - 1) & (fv >= 0) & (fv <= fh - 1)
          & (fd >= 0) & (fd <= dd - 1))
    u0 = torch.clamp(torch.floor(fu).long(), 0, fw - 2)
    v0 = torch.clamp(torch.floor(fv).long(), 0, fh - 2)
    d0 = torch.clamp(torch.floor(fd).long(), 0, dd - 2)
    au = torch.clamp(fu - u0, 0, 1)[..., None]
    av = torch.clamp(fv - v0, 0, 1)[..., None]
    ad = torch.clamp(fd - d0, 0, 1)[..., None]
    flat = frustum_feats.reshape(-1, c)
    base = torch.arange(n, device=flat.device)[:, None] * (dd * fh * fw)

    def g(di, vi, ui):
        idx = ((d0 + di) * fh + (v0 + vi)) * fw + (u0 + ui) + base
        return flat.index_select(0, idx.reshape(-1)).view(n, v, c)

    out = (g(0, 0, 0) * (1 - ad) * (1 - av) * (1 - au)
           + g(0, 0, 1) * (1 - ad) * (1 - av) * au
           + g(0, 1, 0) * (1 - ad) * av * (1 - au)
           + g(0, 1, 1) * (1 - ad) * av * au
           + g(1, 0, 0) * ad * (1 - av) * (1 - au)
           + g(1, 0, 1) * ad * (1 - av) * au
           + g(1, 1, 0) * ad * av * (1 - au)
           + g(1, 1, 1) * ad * av * au)
    return torch.where(ok[..., None], out, 0.0), ok


def ddn_depth_loss(depth_logits, sparse_depth, d: int, dmin: float, dmax: float,
                   alpha: float = 0.25, gamma: float = 2.0):
    """Focal loss of the depth logits (B, fH, fW, D + 1) against the LID bins
    of `sparse_depth` (B, fH, fW), 0 = no depth (masked out), averaged over
    the pixels with depth."""
    has = sparse_depth > 0
    bins = torch.clamp(torch.round(bin_depths_lid(sparse_depth, d, dmin, dmax)), 0, d).long()
    logp = torch.log_softmax(depth_logits.float(), dim=-1)
    p = torch.exp(logp)
    focal = -alpha * ((1 - p) ** gamma) * logp
    loss = torch.gather(focal, -1, bins[..., None])[..., 0]
    return torch.where(has, loss, 0.0).sum() / torch.clamp(has.sum(), min=1).float()
