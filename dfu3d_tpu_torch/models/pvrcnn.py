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
grid_sa0.., or grid_sa in the legacy compact RoI schema, shared_fc, cls_fc,
reg_fc, backbone_2d, dense_head).

PV-RCNN++ (`PVRCNNPlusPlus`, port of pvrcnn.py:356-618) samples its
keypoints around the RoIs and pools with `vector_pool` (`VPFromSource`:
vp_raw, vp_stage0..3, grid_vp0.., grid_msg; grid_vp in the compact schema).
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
    (pv_rcnn.yaml: MLPS / POOL_RADIUS / NSAMPLE, one SA per radius), or
    without it the JAX package's legacy compact schema (pvrcnn.py:130-135):
    GRID_SIZE and one SA (grid_sa) of GRID_RADIUS, GRID_NSAMPLE and
    GRID_MLP."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features, max_voxels)
        pfe = model_cfg.get("PFE", {})
        self.num_keypoints = int(pfe.get("NUM_KEYPOINTS", 2048))
        self.num_point_features = num_point_features
        self.vsa_pools = []
        mlp = tuple(pfe.get("SA_MLP", (16, 16)))
        nsample = int(pfe.get("NSAMPLE", 16))
        self._setup_vsa(pfe, lambda c, r: SAFromSource(c, r, nsample, mlp), "sa_raw", "sa_stage")
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_GRID_POOL", None)
        self.grid_pools = []
        width = 0
        c = self.vsa_fusion.out_channels
        if pool_cfg is not None and "POOL_RADIUS" in pool_cfg:
            self.roi_grid = int(pool_cfg.get("GRID_SIZE", 6))
            for i, (r, n, m) in enumerate(zip(pool_cfg["POOL_RADIUS"], pool_cfg["NSAMPLE"],
                                              pool_cfg["MLPS"])):
                width += self._add_pool(self.grid_pools, f"grid_sa{i}",
                                        SAFromSource(c, float(r), int(n), tuple(m)))
        else:
            self.roi_grid = int(rh.get("GRID_SIZE", 6))
            width += self._add_pool(self.grid_pools, "grid_sa", SAFromSource(
                c, float(rh.get("GRID_RADIUS", 0.8)), int(rh.get("GRID_NSAMPLE", 16)),
                tuple(rh.get("GRID_MLP", (64, 64)))))
        self.grid_msg = None
        self._setup_roi_fc(rh, width)

    def _add_pool(self, names, name, module) -> int:
        """Register `module` under its flax name, list the name, return its
        output width."""
        self.add_module(name, module)
        names.append(name)
        return module.out_channels

    def _setup_roi_fc(self, rh, width: int):
        """SHARED_FC over the channel-major flatten of `width` channels per
        grid point, then the CLS_FC / REG_FC make_fc_layers stacks."""
        dp = float(rh.get("DP_RATIO", 0.3))
        self.shared_fc = roi_head.shared_fc_stack(
            self.roi_grid ** 3 * width, tuple(rh.get("SHARED_FC", rh.get("FC", (256, 256)))), dp)
        c = self.shared_fc.out_channels
        self.cls_fc = roi_head.make_fc_stack(c, tuple(rh.get("CLS_FC", (256, 256))), 1, dp)
        self.reg_fc = roi_head.make_fc_stack(c, tuple(rh.get("REG_FC", (256, 256))), 7, dp)

    def _setup_vsa(self, pfe, make, raw_name: str, stage_prefix: str):
        """The VSA's pools (`make(in_channels, radius)`): one from the raw
        points, one per encoder stage of STAGE_RADII; the fusion MLP over
        their outputs and the BEV sample; the keypoint segmentation layer."""
        width = self._add_pool(self.vsa_pools, raw_name,
                               make(self.num_point_features - 3,
                                    float(pfe.get("RAW_RADIUS", 0.8))))
        radii = tuple(pfe.get("STAGE_RADII", (0.4, 0.8, 1.6, 3.2)))
        for i in range(min(len(radii), len(STAGE_STRIDES))):
            width += self._add_pool(self.vsa_pools, f"{stage_prefix}{i}",
                                    make(self.stage_channels[i], float(radii[i])))
        self.vsa_fusion = SharedMLP(width + self.bev_channels,
                                    tuple(pfe.get("FUSION_MLP", (128,))))
        self.kp_seg = nn.Linear(self.vsa_fusion.out_channels, 1)

    def sample_keypoints(self, batch, points_valid):
        """FPS of NUM_KEYPOINTS keypoints among the points `points_valid`
        marks: (xyz (B, K, 3), valid (B, K)); a keypoint is valid where its
        point is valid in the batch."""
        xyz = batch.points[..., :3].float()
        kp_idx = P.farthest_point_sample(xyz, points_valid, self.num_keypoints)
        return P.group_points(xyz, kp_idx), torch.gather(points_valid, 1, kp_idx)

    def roi_sources(self, batch, bev, stages, rois, roi_valid) -> Keypoints:
        """The voxel set abstraction (pvrcnn.py _keypoint_features:183-242):
        FPS keypoints, then `fuse_keypoints`; PV-RCNN's keypoints do not
        depend on the RoIs."""
        kp, kp_valid = self.sample_keypoints(batch, batch.points_valid)
        return self.fuse_keypoints(batch, kp, kp_valid, bev, stages)

    def fuse_keypoints(self, batch, kp, kp_valid, bev, stages) -> Keypoints:
        """The pools from the raw points and the four stages, the BEV sample,
        the fusion MLP, the fg logits and the weighted features."""
        xyz = batch.points[..., :3].float()
        raw_feats = batch.points[..., 3:] if batch.points.shape[-1] > 3 else None
        raw, *stage_pools = self.vsa_pools
        parts = [getattr(self, raw)(kp, kp_valid, xyz, raw_feats, batch.points_valid)]
        for i, name in enumerate(stage_pools):
            st = stages[i]
            parts.append(getattr(self, name)(kp, kp_valid, self.stage_centers(stages, i),
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
        pooled = torch.cat([getattr(self, name)(pts, valid, kp.xyz, kp.features, kp.valid)
                            for name in self.grid_pools], dim=-1)
        if self.grid_msg is not None:
            pooled = self.grid_msg(pooled, valid)
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
        MLPs, FC towers); the sparse backbone, the VSA and the compact
        schema's grid SA stay unmapped, as in the JAX package."""
        compact = self.grid_pools == ["grid_sa"]
        depth = 0 if compact else len(self.grid_sa0.SharedMLP_0.channels)
        return {**super().reference_mapping(),
                **torch_convert.pvrcnn_head_mapping(
                    self.shared_fc.num, self.cls_fc.num, self.reg_fc.num,
                    0 if compact else len(self.grid_pools), depth)}


class VPFromSource(nn.Module):
    """VectorPool aggregation of query points from a point source (the JAX
    package's VPFromSource, the reference's VectorPoolAggregationModule):
    `vector_pool`'s per-bin means through a masked SharedMLP; a query with
    no neighbour (or invalid) gets 0."""

    def __init__(self, in_channels: int, radius: float, nsample: int, bins: Sequence[int],
                 mlp: Sequence[int]):
        super().__init__()
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.bins = tuple(int(b) for b in bins)
        nbins = self.bins[0] * self.bins[1] * self.bins[2]
        self.SharedMLP_0 = SharedMLP(nbins * (3 + in_channels), mlp)
        self.out_channels = self.SharedMLP_0.out_channels

    def forward(self, queries, q_valid, src_xyz, src_feats, src_valid):
        """queries (B, M, 3), q_valid (B, M), src_xyz (B, N, 3), src_feats
        (B, N, C) or None, src_valid (B, N) → (B, M, C_out)."""
        pooled, has = P.vector_pool(queries, q_valid, src_xyz, src_valid, src_feats,
                                    self.radius, self.nsample, self.bins)
        m = has & q_valid
        out = self.SharedMLP_0(pooled, m)
        return torch.where(m[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


class PVRCNNPlusPlus(PVRCNN):
    """PV-RCNN++ (the JAX package's PVRCNNPlusPlus, the reference's
    pv_rcnn_plusplus.py): PV-RCNN with proposal-centric keypoints (FPS over
    the points within SPC_RADIUS of a RoI centre: the sampled RoIs in
    training, the NMS'd proposals in serving, all points when no RoI is
    valid) and vector pools in place of the ball-query SAs, in the VSA
    (vp_raw, vp_stage0..3, VP_BINS bins) and in the RoI grid pool
    (VectorPoolAggregationModuleMSG: grid_vp0.. per GROUP_CFG_i, fused by
    grid_msg over MSG_POST_MLPS; in the JAX package's legacy compact schema,
    pvrcnn.py:453-459, one vector pool grid_vp of GRID_RADIUS, GRID_NSAMPLE,
    VP_BINS and GRID_MLP). LOCAL_AGGREGATION_TYPE, NUM_REDUCED_CHANNELS and
    NUM_CHANNELS_OF_LOCAL_AGGREGATION are not read, as in the JAX package.
    No reference mapping of the RoI head: the JAX package has none."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        VoxelTwoStage.__init__(self, model_cfg, class_names, grid, num_point_features,
                               max_voxels)
        pfe = model_cfg.get("PFE", {})
        self.num_keypoints = int(pfe.get("NUM_KEYPOINTS", 2048))
        self.kp_roi_radius = float(pfe.get("SPC_RADIUS", 2.4))
        self.num_point_features = num_point_features
        self.vsa_pools = []
        bins = tuple(pfe.get("VP_BINS", (3, 3, 3)))
        mlp = tuple(pfe.get("SA_MLP", (16, 16)))
        nsample = int(pfe.get("NSAMPLE", 16))
        self._setup_vsa(pfe, lambda c, r: VPFromSource(c, r, nsample, bins, mlp), "vp_raw",
                        "vp_stage")
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_GRID_POOL", None)
        self.grid_pools = []
        self.grid_msg = None
        if pool_cfg is None or "NUM_GROUPS" not in pool_cfg:
            self.roi_grid = int(rh.get("GRID_SIZE", 6))
            width = self._add_pool(self.grid_pools, "grid_vp", VPFromSource(
                self.vsa_fusion.out_channels, float(rh.get("GRID_RADIUS", 0.8)),
                int(rh.get("GRID_NSAMPLE", 16)), tuple(rh.get("VP_BINS", (2, 2, 2))),
                tuple(rh.get("GRID_MLP", (64, 64)))))
            self._setup_roi_fc(rh, width)
            return
        self.roi_grid = int(pool_cfg.get("GRID_SIZE", 6))
        width = 0
        for i in range(int(pool_cfg["NUM_GROUPS"])):
            g_cfg = pool_cfg[f"GROUP_CFG_{i}"]
            ns = int(g_cfg.get("NEIGHBOR_NSAMPLE", 32))
            vp = VPFromSource(self.vsa_fusion.out_channels, float(g_cfg["MAX_NEIGHBOR_DISTANCE"]),
                              ns if ns > 0 else 32, tuple(g_cfg["NUM_LOCAL_VOXEL"]),
                              tuple(g_cfg["POST_MLPS"]))
            width += self._add_pool(self.grid_pools, f"grid_vp{i}", vp)
        if pool_cfg.get("MSG_POST_MLPS"):
            self.grid_msg = SharedMLP(width, tuple(pool_cfg["MSG_POST_MLPS"]))
            width = self.grid_msg.out_channels
        self._setup_roi_fc(rh, width)

    def keypoint_mask(self, batch, rois, roi_valid):
        """The points FPS may pick (pvrcnn.py:467-491): valid, and within
        SPC_RADIUS of a valid RoI's centre unless no RoI of the frame is
        valid."""
        with torch.autocast(rois.device.type, enabled=False):
            d2 = P._sq_dist(batch.points[..., :3], rois[..., :3])   # (B, N, R)
            d2 = d2.masked_fill(~roi_valid[:, None, :], float("inf"))
            r2 = torch.full((), self.kp_roi_radius ** 2, dtype=torch.float32, device=d2.device)
            near = d2.amin(dim=-1) < r2
        return batch.points_valid & torch.where(roi_valid.any(dim=-1, keepdim=True), near, True)

    def roi_sources(self, batch, bev, stages, rois, roi_valid) -> Keypoints:
        """Proposal-centric keypoints (FPS over `keypoint_mask`), then the
        VSA's fusion."""
        kp, kp_valid = self.sample_keypoints(batch, self.keypoint_mask(batch, rois, roi_valid))
        return self.fuse_keypoints(batch, kp, kp_valid, bev, stages)

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) only."""
        return VoxelTwoStage.reference_mapping(self)
