"""PV-RCNN (port of dfu3d_tpu/models/pvrcnn.py PVRCNN; the reference's
detectors/pv_rcnn.py, pfe/voxel_set_abstraction.py,
dense_heads/point_head_simple.py and roi_heads/pvrcnn_head.py):

    MeanVFE → SparseEncoder → height_compression → BaseBEVBackbone →
    anchor RPN → proposal NMS; in parallel the voxel set abstraction: FPS
    keypoints from the raw points, a ball-query SA from the raw points and
    from each encoder stage's voxel centres, the stride-8 BEV map sampled
    bilinearly, the concatenation fused by an MLP; keypoint segmentation
    weights the fused features (predicted keypoint weighting) → per RoI a
    G³ grid pooled from the keypoints by one SA per radius → channel-major
    flatten → SHARED_FC → CLS_FC / REG_FC → canonical decode → final NMS

Training adds the anchor loss, the keypoint segmentation BCE (a keypoint is
fg inside a valid gt box), the proposal target layer and the RoI losses.
The JAX package builds SparseEncoder here where the config names
VoxelBackBone8x, and the port keeps its trunk. FPS is the sequential loop
of `core.pointnet2`, NUM_KEYPOINTS iterations per request. Module names
follow the flax tree (encoder, sa_raw, sa_stage0..3, vsa_fusion, kp_seg,
grid_sa0.., shared_fc, cls_fc, reg_fc, backbone_2d, dense_head). The legacy
compact RoI schema (GRID_RADIUS, GRID_MLP) and PV-RCNN++ are not ported
and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..core import pointnet2 as P
from ..core.geometry.boxes import points_in_boxes
from ..core.voxel import VoxelGrid
from ..train import torch_convert
from . import roi_head
from .pointnet2_backbone import SharedMLP, masked_max
from .voxelrcnn import STAGE_STRIDES, VoxelTwoStage


class SAFromSource(nn.Module):
    """Ball-query set abstraction of query points from a point source
    (the JAX package's SAFromSource): relative xyz, then the source's
    features, through a masked SharedMLP, max-pooled over the neighbours; a
    query with no neighbour (or invalid) gets 0 (masked to -inf, the max,
    then non-finite → 0, `masked_max`, whose amax shares a gradient among
    tied maxima as JAX's reduce_max does)."""

    def __init__(self, in_channels: int, radius: float, nsample: int, mlp: Sequence[int]):
        super().__init__()
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.SharedMLP_0 = SharedMLP(in_channels + 3, mlp)
        self.out_channels = self.SharedMLP_0.out_channels

    def query(self, queries, q_valid, src_xyz, src_valid):
        """(idx (B, M, nsample), has (B, M)) of the ball query."""
        return P.ball_query(self.radius, self.nsample, src_xyz, src_valid, queries, q_valid)

    def forward(self, queries, q_valid, src_xyz, src_feats, src_valid):
        """queries (B, M, 3), q_valid (B, M), src_xyz (B, N, 3), src_feats
        (B, N, C) or None, src_valid (B, N) → (B, M, C_out)."""
        idx, has = self.query(queries, q_valid, src_xyz, src_valid)
        grouped = P.group_points(src_xyz.float(), idx) - queries[:, :, None, :]
        if src_feats is not None:
            grouped = torch.cat([grouped, P.group_points(src_feats, idx).to(grouped.dtype)], -1)
        m = (has & q_valid)[..., None]
        return masked_max(self.SharedMLP_0(grouped, m), m[..., None], dim=2)


class Keypoints(NamedTuple):
    xyz: torch.Tensor        # (B, K, 3)
    valid: torch.Tensor      # (B, K)
    features: torch.Tensor   # (B, K, C) fused, weighted by the fg score
    seg_logits: torch.Tensor  # (B, K) fp32


def bev_bilinear(bev, xyz, point_cloud_range, voxel_size, stride: float = 8.0):
    """The BEV map (B, H, W, C) sampled at xyz (B, K, 3)'s x, y: pixel
    centres at half a pixel, the top-left tap clamped into [0, W - 2] ×
    [0, H - 2] and the weights into [0, 1] (the JAX package's bilinear
    interpolation, pvrcnn.py:211-234) → (B, K, C) fp32."""
    dev = bev.device
    lo = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    u = (xyz[..., 0] - lo[0]) / vs[0] - 0.5
    v = (xyz[..., 1] - lo[1]) / vs[1] - 0.5
    b, h, w, c = bev.shape
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 2)
    du = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    dv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    flat = bev.float().reshape(b, h * w, c)
    rows = torch.arange(b, device=dev)[:, None]

    def at(vv, uu):
        return flat[rows, vv * w + uu]

    return (at(v0, u0) * (1 - dv) * (1 - du) + at(v0, u0 + 1) * (1 - dv) * du
            + at(v0 + 1, u0) * dv * (1 - du) + at(v0 + 1, u0 + 1) * dv * du)


class PVRCNN(VoxelTwoStage):
    """PV-RCNN with the reference PVRCNNHead ROI_GRID_POOL schema
    (pv_rcnn.yaml: MLPS / POOL_RADIUS / NSAMPLE, one SA per radius)."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features, max_voxels)
        pfe = model_cfg.get("PFE", {})
        self.num_keypoints = int(pfe.get("NUM_KEYPOINTS", 2048))
        mlp = tuple(pfe.get("SA_MLP", (16, 16)))
        nsample = int(pfe.get("NSAMPLE", 16))
        self.sa_raw = SAFromSource(num_point_features - 3, float(pfe.get("RAW_RADIUS", 0.8)),
                                   nsample, mlp)
        radii = tuple(pfe.get("STAGE_RADII", (0.4, 0.8, 1.6, 3.2)))
        self.num_sa_stages = min(len(radii), len(STAGE_STRIDES))
        width = self.sa_raw.out_channels
        for i in range(self.num_sa_stages):
            sa = SAFromSource(self.stage_channels[i], float(radii[i]), nsample, mlp)
            self.add_module(f"sa_stage{i}", sa)
            width += sa.out_channels
        width += self.bev_channels
        self.vsa_fusion = SharedMLP(width, tuple(pfe.get("FUSION_MLP", (128,))))
        self.kp_seg = nn.Linear(self.vsa_fusion.out_channels, 1)
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_GRID_POOL", None)
        if pool_cfg is None or "POOL_RADIUS" not in pool_cfg:
            raise NotImplementedError("the legacy compact RoI schema (GRID_RADIUS, GRID_MLP) is "
                                      "not ported; ROI_GRID_POOL with POOL_RADIUS is")
        self.roi_grid = int(pool_cfg.get("GRID_SIZE", 6))
        self.num_grid_sa = len(pool_cfg["POOL_RADIUS"])
        width = 0
        for i, (r, n, m) in enumerate(zip(pool_cfg["POOL_RADIUS"], pool_cfg["NSAMPLE"],
                                          pool_cfg["MLPS"])):
            sa = SAFromSource(self.vsa_fusion.out_channels, float(r), int(n), tuple(m))
            self.add_module(f"grid_sa{i}", sa)
            width += sa.out_channels
        dp = float(rh.get("DP_RATIO", 0.3))
        self.shared_fc = roi_head.shared_fc_stack(
            self.roi_grid ** 3 * width, tuple(rh.get("SHARED_FC", rh.get("FC", (256, 256)))), dp)
        c = self.shared_fc.out_channels
        self.cls_fc = roi_head.make_fc_stack(c, tuple(rh.get("CLS_FC", (256, 256))), 1, dp)
        self.reg_fc = roi_head.make_fc_stack(c, tuple(rh.get("REG_FC", (256, 256))), 7, dp)

    def roi_sources(self, batch, bev, stages) -> Keypoints:
        """The voxel set abstraction (pvrcnn.py _keypoint_features:183-242):
        FPS keypoints, SA from the raw points and the four stages, the BEV
        sample, the fusion MLP, the fg logits and the weighted features."""
        xyz = batch.points[..., :3].float()
        kp_idx = P.farthest_point_sample(xyz, batch.points_valid, self.num_keypoints)
        kp_valid = torch.gather(batch.points_valid, 1, kp_idx)
        kp = P.group_points(xyz, kp_idx)
        raw_feats = batch.points[..., 3:] if batch.points.shape[-1] > 3 else None
        parts = [self.sa_raw(kp, kp_valid, xyz, raw_feats, batch.points_valid)]
        for i in range(self.num_sa_stages):
            st = stages[i]
            parts.append(getattr(self, f"sa_stage{i}")(kp, kp_valid, self.stage_centers(stages, i),
                                                       st.features.float(), st.valid))
        parts.append(bev_bilinear(bev, kp, self.grid.point_cloud_range, self.grid.voxel_size))
        fused = self.vsa_fusion(torch.cat(parts, dim=-1), kp_valid)
        seg_logits = self.kp_seg(fused)[..., 0].float()
        return Keypoints(kp, kp_valid, fused * torch.sigmoid(seg_logits)[..., None], seg_logits)

    def source_loss(self, batch, kp: Keypoints):
        """The keypoint segmentation BCE (PointHeadSimple): fg inside a valid
        gt box, weighted by 1 / the batch's valid keypoints."""
        with torch.autocast(kp.xyz.device.type, enabled=False):
            inside = points_in_boxes(kp.xyz, batch.gt_boxes[..., :7].float())
            fg = (inside & batch.gt_valid[:, None, :]).any(dim=-1) & kp.valid
            w = kp.valid.float()
            w = w / torch.clamp(w.sum(), min=1.0)
            x, y = kp.seg_logits, fg.float()
            bce = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
            loss = (bce * w).sum()
        return loss, {"kp_seg_loss": loss}

    def refine(self, kp: Keypoints, rois, roi_valid, dropout=None):
        """roi_grid_pool over the keypoints (pvrcnn_head.py:65-112), the
        channel-major flatten of `pooled.permute(0, 2, 1).view(N, C·g³)`
        (:154-158), SHARED_FC → CLS_FC / REG_FC."""
        pts, valid = self.grid_points(rois, roi_valid)
        pooled = torch.cat([getattr(self, f"grid_sa{i}")(pts, valid, kp.xyz, kp.features,
                                                         kp.valid)
                            for i in range(self.num_grid_sa)], dim=-1)
        b, r = rois.shape[:2]
        g3 = self.roi_grid ** 3
        pooled = pooled.reshape(b * r, g3, -1).transpose(1, 2).reshape(b * r, -1)
        h = self.shared_fc(pooled, dropout)
        cls = self.cls_fc(h, dropout)
        reg = self.reg_fc(h, dropout)
        return cls.reshape(b, r).float(), reg.reshape(b, r, 7).float()

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir,
        kp_seg_loss, rcnn_cls_loss, rcnn_reg_loss, rpn_loss}) as JAX's
        PVRCNN.__call__, whose rpn_loss is the whole loss. `sampler` draws
        the proposal target layer's uniforms; `dropout` drives the FC
        dropout."""
        total, tb = super().forward(batch, sampler, dropout)
        tb["rpn_loss"] = total
        return total, tb

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) and PVRCNNHead's (grid SA
        MLPs, FC towers); the sparse backbone and the VSA stay unmapped, as in
        the JAX package."""
        depth = len(self.grid_sa0.SharedMLP_0.channels)
        return {**super().reference_mapping(),
                **torch_convert.pvrcnn_head_mapping(
                    self.shared_fc.num, self.cls_fc.num, self.reg_fc.num, self.num_grid_sa,
                    depth)}
