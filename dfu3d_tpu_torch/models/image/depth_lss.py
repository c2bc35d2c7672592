"""DepthLSSTransform, BEVFusion's view transform (port of dfu3d_tpu/models/
image/depth_lss.py; reference pcdet/models/view_transforms/depth_lss.py).

Lift: the projected LiDAR depth map through the dtransform convs (dt0-dt2)
to the feature grid, concatenated with the camera features, the depth net
(dn0, dn1, dn_out) gives per pixel a softmax over D depth bins and C
features; their outer product is a (B·N, D, fH, fW, C) frustum of features.
Splat: each frustum sample's (u, v, depth) back-projected through the
intrinsics and camera→lidar transform (`get_geometry`) to its BEV cell
[b, z, y, x], `bev_pool` sums the samples per cell, z folds into channels,
and with DOWNSAMPLE 2 three convs (ds0-ds2, the middle one strided) halve
the map. NHWC maps; fp32 geometry, softmax and outer product.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.voxel.bev_pool import bev_pool
from .common import add_conv_bn, conv_bn_relu, nhwc, resize_bilinear


def frustum(image_size, feature_size, dbound) -> np.ndarray:
    """(D, fH, fW, 3) fp32 samples (u, v, depth): fW columns over 0 .. iW - 1,
    fH rows over 0 .. iH - 1, the depths of arange(*dbound)."""
    (ih, iw), (fh, fw) = image_size, feature_size
    ds = np.arange(*dbound, dtype=np.float32)
    f = np.zeros((len(ds), fh, fw, 3), np.float32)
    f[..., 0] = np.linspace(0, iw - 1, fw, dtype=np.float32)[None, None, :]
    f[..., 1] = np.linspace(0, ih - 1, fh, dtype=np.float32)[None, :, None]
    f[..., 2] = ds[:, None, None]
    return f


class DepthLSSTransform(nn.Module):
    """VTRANSFORM: IN_CHANNEL, OUT_CHANNEL, IMAGE_SIZE, FEATURE_SIZE, XBOUND,
    YBOUND, ZBOUND, DBOUND, DOWNSAMPLE."""

    def __init__(self, in_channel: int, out_channel: int, image_size: Tuple[int, int],
                 feature_size: Tuple[int, int], xbound: Sequence[float], ybound: Sequence[float],
                 zbound: Sequence[float], dbound: Sequence[float], downsample: int = 1):
        super().__init__()
        self.in_channel, self.out_channel = in_channel, out_channel
        self.image_size, self.feature_size = tuple(image_size), tuple(feature_size)
        self.bounds = (tuple(xbound), tuple(ybound), tuple(zbound))
        self.downsample = downsample
        self.register_buffer("frustum", torch.from_numpy(frustum(image_size, feature_size,
                                                                 dbound)), persistent=False)
        self.num_depth_bins = d = self.frustum.shape[0]
        for prefix, cin, cout, k, s in (("dt0", 1, 8, 1, 1), ("dt1", 8, 32, 5, 4),
                                        ("dt2", 32, 64, 5, 2),
                                        ("dn0", 64 + in_channel, in_channel, 3, 1),
                                        ("dn1", in_channel, in_channel, 3, 1)):
            add_conv_bn(self, prefix, cin, cout, k, s)
        self.dn_out = nn.Conv2d(in_channel, d + out_channel, 1)
        if downsample > 1:
            if downsample != 2:
                raise NotImplementedError("DOWNSAMPLE other than 1 or 2")
            add_conv_bn(self, "ds0", self.grid[2] * out_channel, out_channel, 3)
            add_conv_bn(self, "ds1", out_channel, out_channel, 3, 2)
            add_conv_bn(self, "ds2", out_channel, out_channel, 3)

    def convs(self, prefixes, x):
        for p in prefixes:
            x = conv_bn_relu(self, p, x)
        return x

    @property
    def grid(self):
        """(nx, ny, nz) of the BEV cells."""
        return tuple(int(round((b[1] - b[0]) / b[2])) for b in self.bounds)

    def get_geometry(self, cam2lidar_rots, cam2lidar_trans, intrins):
        """Each frustum sample's lidar xyz (B, N, D, fH, fW, 3), fp32 (also
        under autocast)."""
        b, n = cam2lidar_trans.shape[:2]
        with torch.autocast(self.frustum.device.type, enabled=False):
            pts = self.frustum.expand((b, n) + self.frustum.shape)
            pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
            combine = torch.matmul(cam2lidar_rots.float(), torch.linalg.inv(intrins.float()))
            pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
            return pts + cam2lidar_trans.float()[:, :, None, None, None, :]

    def depth_net(self, img_feats, sparse_depth):
        """(depth (B·N, fH, fW, D) softmax, feat (B·N, fH, fW, C)) in fp32 of
        the camera features (B, N, fH, fW, C_in) and the depth maps (B, N,
        iH, iW)."""
        b, n, fh, fw, _ = img_feats.shape
        x = img_feats.reshape(b * n, fh, fw, -1)
        dd = sparse_depth.reshape(b * n, *self.image_size, 1).to(x.dtype)
        dd = nhwc(lambda t: self.convs(("dt0", "dt1", "dt2"), t), dd)
        dd = resize_bilinear(dd, (fh, fw))
        y = torch.cat([dd.to(x.dtype), x], dim=-1)
        y = nhwc(lambda t: self.dn_out(self.convs(("dn0", "dn1"), t)), y)
        d = self.num_depth_bins
        return torch.softmax(y[..., :d].float(), dim=-1), y[..., d:].float()

    def pool_coords(self, geom):
        """[b, z, y, x] int cell of every frustum sample (P, 4), in the
        (B, N, D, fH, fW) order of `geom` (B, N, D, fH, fW, 3)."""
        (xb, yb, zb) = self.bounds
        lo = torch.tensor([xb[0], yb[0], zb[0]], dtype=torch.float32, device=geom.device)
        dx = torch.tensor([xb[2], yb[2], zb[2]], dtype=torch.float32, device=geom.device)
        cell = torch.floor((geom - lo) / dx).long().reshape(geom.shape[0], -1, 3)
        bix = torch.arange(geom.shape[0], device=geom.device)[:, None].expand(cell.shape[:2])
        return torch.cat([bix[..., None], cell.flip(-1)], dim=-1).reshape(-1, 4)

    def forward(self, img_feats, sparse_depth, cam2lidar_rots, cam2lidar_trans, intrins):
        """img_feats (B, N, fH, fW, C_in), sparse_depth (B, N, iH, iW) →
        the camera BEV (B, ny, nx, nz · C_out) (halved with DOWNSAMPLE 2)."""
        b, n, fh, fw, _ = img_feats.shape
        depth, feat = self.depth_net(img_feats, sparse_depth)
        frustum_feats = depth.permute(0, 3, 1, 2)[..., None] * feat[:, None]
        geom = self.get_geometry(cam2lidar_rots, cam2lidar_trans, intrins)
        nx, ny, nz = self.grid
        c = self.out_channel
        pooled = bev_pool(frustum_feats.reshape(-1, c), self.pool_coords(geom),
                          torch.ones(frustum_feats.numel() // c, dtype=torch.bool,
                                     device=feat.device), b, nz, ny, nx)
        out = pooled.permute(0, 2, 3, 1, 4).reshape(b, ny, nx, nz * c).to(img_feats.dtype)
        if self.downsample > 1:
            out = nhwc(lambda t: self.convs(("ds0", "ds1", "ds2"), t), out)
        return out
