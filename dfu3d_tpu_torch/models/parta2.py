"""PartA2 (port of dfu3d_tpu/models/parta2.py; the reference's
detectors/PartA2_net.py, backbones_3d/spconv_unet.py UNetV2, the point
head with part locations and roi_heads/partA2_head.py):

    MeanVFE → SparseUNet: the SparseEncoder stages (strides 1, 2, 4, 8,
    each strided conv with no BN and one refine block) and the z-only
    conv_out for the RPN; a decoder back to stride 1 where each `up` takes
    the stride-2 parent's feature (`parent_gather`), concatenates
    [parent, skip] and runs a submanifold block (up3, up2, up1) →
    height_compression → BaseBEVBackbone → anchor RPN → proposal NMS;
    the part head on the stride-1 decoder voxels (seg_mlp → seg_out, the
    foreground logit, and part_out, the sigmoid part location) → per RoI
    `roiaware_pool` of the part stream ([part location or voxel centre,
    detached score], zeroed below SEG_MASK_SCORE_THRESH; average) and of
    the decoder features (max) on a POOL_SIZE³ grid → `PartA2RoIHead` (two
    dense 3×3×3 conv blocks per stream, masked to the occupied cells,
    [rpn, part] flattened channel-major) → SHARED_FC → CLS_FC / REG_FC →
    canonical decode → final NMS

Training adds the anchor loss, the part targets (`part_targets`: a voxel is
fg inside a valid gt box, the first such box gives its part location), the
segmentation BCE and the part BCE, the proposal target layer and the RoI
losses. All 12 sparse convs (9 encoder, 3 decoder) are B2 launches; each
NMS and the RoI targets' IoU a B1 launch. POINT_HEAD.PART_FC,
ROI_AWARE_POOL.MAX_POINTS_PER_VOXEL and, on PartA2_free.yaml, the point
head's REG_FC, BOX_CODER and point_box_weight are not read, as in the JAX
package: one seg_mlp serves the segmentation and the part outputs, and a
ROI_POINT_SAMPLES sample per RoI feeds the pools. Without ROI_AWARE_POOL
the JAX package's legacy compact schema gives the grid and the width
(ROI_HEAD.GRID_SIZE, NUM_FEATURES; parta2.py:254-256). Module
names follow the flax tree (unet.conv_in, unet.down2_refine, unet.up3,
seg_mlp, seg_out, part_out, roi_head.part0_conv / part0_bn,
roi_head.shared_fc, backbone_2d, dense_head).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.geometry.boxes import points_in_boxes
from ..core.voxel import VoxelGrid, segment_sum_sorted
from ..core.voxel.sparse_ops import SparseGrid, build_lookup, find_neighbors
from ..train import torch_convert
from . import roi_head
from .pointnet2_backbone import SharedMLP
from .pointpillar import AnchorDetectorBase
from .pointrcnn import pool_roi_points
from .sparse_backbone import SparseConvBlock, SparseEncoder, SparseTensor, height_compression
from .sparse_backbone import voxel_centers_of
from .vfe import MaskedBatchNorm, MeanVFE

UNET_CHANNELS = (16, 16, 32, 64, 64)   # the JAX SparseUNet's default


def parent_table(coarse_grid: SparseGrid, coarse_coords, coarse_valid, fine_coords, fine_valid):
    """Per fine voxel the slot of its stride-2 parent (coords // 2) in the
    coarse set, else the coarse set's V: (B, V_fine) int32 (the JAX
    package's _parent_gather lookup, one zero offset)."""
    lookup = build_lookup(coarse_grid, coarse_coords, coarse_valid)
    zero = torch.zeros((1, 3), dtype=torch.int32)
    parent = torch.div(fine_coords, 2, rounding_mode="floor")
    return find_neighbors(coarse_grid, parent, fine_valid, *lookup, zero.numpy())[..., 0]


def parent_gather(coarse: SparseTensor, table):
    """Each fine voxel's parent feature (zero where it has none, or where
    the parent is invalid): coarse features (B, V_c, C), table (B, V_f) from
    `parent_table` → (B, V_f, C)."""
    b, vc, c = coarse.features.shape
    feats = torch.where(coarse.valid[..., None], coarse.features, 0)
    padded = torch.cat([feats, feats.new_zeros(b, 1, c)], dim=1)
    rows = torch.arange(b, device=table.device)[:, None]
    return padded[rows, table.long()]


class SparseUNet(SparseEncoder):
    """The JAX package's SparseUNet: SparseEncoder's encoder and conv_out,
    then the decoder up3 (stride 4), up2 (stride 2), up1 (stride 1), each a
    submanifold block over [parent feature, encoder skip] on the skip's
    set. 12 sparse convs. `plan` adds each decoder level's parent table;
    `forward` returns (conv_out tensor for the RPN, the stride-1 decoder
    tensor)."""

    def __init__(self, grid: SparseGrid, voxel_cap: int, in_channels: int,
                 channels: Sequence[int] = UNET_CHANNELS, out_channels: int = 128):
        super().__init__(grid, voxel_cap, in_channels, channels, out_channels)
        ch = tuple(channels)
        self.up3 = SparseConvBlock(ch[4] + ch[3], ch[3])
        self.up2 = SparseConvBlock(ch[3] + ch[2], ch[2])
        self.up1 = SparseConvBlock(ch[2] + ch[1], ch[1])

    def plan(self, coords, valid, num_unique, transpose: bool = False):
        """The encoder's levels, then per fine level 0..2 the parent table
        into the next coarser level: (levels, parents)."""
        levels = super().plan(coords, valid, num_unique, transpose)
        parents = tuple(parent_table(levels[i + 1].grid, levels[i + 1].coords,
                                     levels[i + 1].valid, levels[i].coords, levels[i].valid)
                        for i in range(3))
        return levels, parents

    def forward(self, features, plan):
        levels, parents = plan
        bev_st, (s1, s2, s3, s4) = super().forward(features, levels)
        d = s4
        for name, skip, i in (("up3", s3, 2), ("up2", s2, 1), ("up1", s1, 0)):
            gathered = parent_gather(d, parents[i])
            x = torch.cat([gathered.to(skip.features.dtype), skip.features], dim=-1)
            d = getattr(self, name)(skip._replace(features=x), levels[i].subm_nbr)
        return bev_st, d


def roiaware_pool(points_xyz, point_feats, points_valid, rois, roi_valid, num_samples: int,
                  grid_size: int, reduce: str = "max"):
    """RoI-aware grid pooling (the JAX package's roiaware_pool): the first
    `num_samples` points of each RoI (`pool_roi_points`, no enlargement), in
    its canonical frame, put in the cell trunc((local / max(size, 1e-3) +
    0.5) · G) clipped to [0, G - 1] per axis, cells x-major ((cx·G + cy)·G
    + cz), and max- or avg-pooled per cell.

    points_xyz (B, N, 3), point_feats (B, N, C), points_valid (B, N), rois
    (B, R, 7+), roi_valid (B, R) → (B, R, G, G, G, C) fp32. Max pooling
    gives an empty cell 0, and tied maxima share the gradient (as
    jax.ops.segment_max); avg pooling divides by max(count, 1), its sums
    taken over the samples sorted by cell."""
    with torch.autocast(points_xyz.device.type, enabled=False):
        local, feats, sample_valid = pool_roi_points(points_xyz.float(), point_feats.float(),
                                                     points_valid, rois.float(), roi_valid,
                                                     num_samples, extra=0.0)
        g = int(grid_size)
        b, r, _, c = feats.shape
        dims = torch.clamp(rois[..., 3:6].float(), min=1e-3)
        rel = (local / dims[:, :, None, :] + 0.5) * g
        cell = torch.clamp(rel.to(torch.int32), 0, g - 1).long()
        cell_id = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]   # (B, R, S)
        n = b * r * g ** 3
        base = torch.arange(b * r, device=cell_id.device).reshape(b, r, 1) * g ** 3
        # samples past a RoI's count go to the extra segment n, dropped
        seg = torch.where(sample_valid, cell_id + base, n).reshape(-1)
        flat = feats.reshape(-1, c)
        if reduce == "max":
            pooled = flat.new_zeros(n + 1, c).scatter_reduce(
                0, seg[:, None].expand(-1, c), flat, "amax", include_self=False)[:n]
        else:   # sorted segments, no atomics: a run on the card repeats bit for bit
            order = torch.argsort(seg, stable=True)
            values = torch.cat([flat, sample_valid.reshape(-1, 1).float()], dim=-1)
            sums = segment_sum_sorted(values[order], seg[order], n)
            pooled = sums[:, :c] / torch.clamp(sums[:, c:], min=1.0)
    return pooled.reshape(b, r, g, g, g, c)


class PartA2RoIHead(nn.Module):
    """PartA2FCHead (the JAX package's PartA2RoIHead): per stream (part,
    rpn) two blocks of a dense 3×3×3 SAME conv (no bias) over the (N, G, G,
    G) pooled grid, a masked BN over the occupied cells (eps 1e-3, keep
    0.99; a cell is occupied where the pooled part stream is nonzero) and a
    ReLU, re-masked; widths 64, then NUM_FEATURES / 2. The streams merge as
    [rpn, part], flattened channel-major, → SHARED_FC → CLS_FC / REG_FC."""

    def __init__(self, part_channels: int, rpn_channels: int, grid_size: int = 12,
                 num_features: int = 128, shared_fc=(256, 256, 256), cls_fc=(256, 256),
                 reg_fc=(256, 256), dp_ratio: float = 0.3):
        super().__init__()
        self.grid_size = int(grid_size)
        c0 = int(num_features) // 2
        for stream, cin in (("part", part_channels), ("rpn", rpn_channels)):
            for i, ch in enumerate((64, c0)):
                self.add_module(f"{stream}{i}_conv", nn.Conv3d(cin, ch, 3, padding=1, bias=False))
                self.add_module(f"{stream}{i}_bn", MaskedBatchNorm(ch, eps=1e-3, keep=0.99))
                cin = ch
        self.shared_fc = roi_head.shared_fc_stack(2 * c0 * self.grid_size ** 3, tuple(shared_fc),
                                                  dp_ratio)
        c = self.shared_fc.out_channels
        self.cls_fc = roi_head.make_fc_stack(c, tuple(cls_fc), 1, dp_ratio)
        self.reg_fc = roi_head.make_fc_stack(c, tuple(reg_fc), 7, dp_ratio)

    def _block(self, x, mask, name: str):
        """x (N, G, G, G, C) channel-last → the block's output, channel-last."""
        y = getattr(self, f"{name}_conv")(x.permute(0, 4, 1, 2, 3))
        y = getattr(self, f"{name}_bn")(y.permute(0, 2, 3, 4, 1), mask)
        return torch.where(mask[..., None], torch.relu(y), torch.zeros((), dtype=y.dtype,
                                                                       device=y.device))

    def forward(self, part_grids, rpn_grids, dropout=None):
        """part_grids (B, R, G, G, G, Cp), rpn_grids (B, R, G, G, G, Cr) →
        (rcnn_cls (B, R), rcnn_reg (B, R, 7)), fp32."""
        b, r = part_grids.shape[:2]
        part = part_grids.reshape((b * r,) + tuple(part_grids.shape[2:]))
        rpn = rpn_grids.reshape((b * r,) + tuple(rpn_grids.shape[2:]))
        mask = part.abs().sum(dim=-1) > 0
        xp, xr = part, rpn
        for i in range(2):
            xp = self._block(xp, mask, f"part{i}")
            xr = self._block(xr, mask, f"rpn{i}")
        merged = torch.cat([xr, xp], dim=-1).permute(0, 4, 1, 2, 3).reshape(b * r, -1)
        h = self.shared_fc(merged, dropout)
        cls = self.cls_fc(h, dropout)
        reg = self.reg_fc(h, dropout)
        return cls.reshape(b, r).float(), reg.reshape(b, r, 7).float()


def part_targets(centers, valid, gt_boxes, gt_valid):
    """Per voxel centre (B, V, 3): fg (inside a valid gt box, and valid)
    and its part location in the first such box (argmax of the inside
    mask; box 0 where none), (local / max(size, 1e-3) + 0.5) clipped to
    [0, 1] in the box's frame → (fg (B, V) bool, parts (B, V, 3) fp32)."""
    inside = points_in_boxes(centers, gt_boxes[..., :7].float()) & gt_valid[:, None, :]
    fg = inside.any(dim=-1) & valid
    bidx = torch.argmax(inside.to(torch.uint8), dim=-1)
    box = torch.gather(gt_boxes.float(), 1, bidx[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    local = centers - box[..., 0:3]
    cos, sin = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    lx = local[..., 0] * cos - local[..., 1] * sin
    ly = local[..., 0] * sin + local[..., 1] * cos
    lz = local[..., 2]
    size = torch.clamp(box[..., 3:6], min=1e-3)
    part = torch.stack([lx / size[..., 0] + 0.5, ly / size[..., 1] + 0.5,
                        lz / size[..., 2] + 0.5], dim=-1)
    return fg, torch.clamp(part, 0.0, 1.0)


class PartA2Net(roi_head.RoIStage, AnchorDetectorBase):
    """PartA2 on PartA2.yaml or PartA2_free.yaml (DISABLE_PART, threshold
    0). `forward` returns (loss, tb) with JAX's keys; `predict` the final
    NMS over the refined RoIs."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid)
        bb3d = model_cfg.get("BACKBONE_3D", {})
        if bb3d.get("NAME", "UNetV2") != "UNetV2":
            raise NotImplementedError(f"BACKBONE_3D {bb3d.NAME} with PartA2Net is not ported")
        if model_cfg.VFE.NAME != "MeanVFE":
            raise NotImplementedError(f"VFE {model_cfg.VFE.NAME} with PartA2Net is not ported")
        channels = tuple(bb3d.get("CHANNELS", UNET_CHANNELS))
        out_channels = bb3d.get("OUT_CHANNELS", 128)
        self.vfe = MeanVFE(grid, max_voxels)
        self.unet = SparseUNet(SparseGrid(*grid.grid_size), max_voxels, num_point_features,
                               channels, out_channels)
        ph = model_cfg.get("POINT_HEAD", {})
        self.seg_mlp = SharedMLP(channels[1], tuple(ph.get("CLS_FC", (64,))))
        self.seg_out = nn.Linear(self.seg_mlp.out_channels, 1)
        self.part_out = nn.Linear(self.seg_mlp.out_channels, 3)
        rh = model_cfg.get("ROI_HEAD", {})
        pool_cfg = rh.get("ROI_AWARE_POOL", None)
        if pool_cfg is not None:
            g, nf = int(pool_cfg.get("POOL_SIZE", 12)), int(pool_cfg.get("NUM_FEATURES", 128))
        else:
            g, nf = int(rh.get("GRID_SIZE", 12)), int(rh.get("NUM_FEATURES", 128))
        self.roi_samples = int(rh.get("ROI_POINT_SAMPLES", 512))
        self.seg_mask_thresh = float(rh.get("SEG_MASK_SCORE_THRESH", 0.3))
        self.disable_part = bool(rh.get("DISABLE_PART", False))
        self.roi_head = PartA2RoIHead(
            4, channels[1], g, nf, tuple(rh.get("SHARED_FC", (256, 256, 256))),
            tuple(rh.get("CLS_FC", (256, 256))), tuple(rh.get("REG_FC", (256, 256))),
            float(rh.get("DP_RATIO", 0.3)))
        self._setup_head(self.unet.out_grid.nz * out_channels)
        self._setup_roi_stage(rh)

    def voxel_centers(self, st):
        return voxel_centers_of(st, self.grid.point_cloud_range, self.grid.voxel_size, 1)

    def backbone(self, batch):
        """(RPN predictions, stride-1 decoder tensor, seg logits (B, V) fp32,
        part locations (B, V, 3) fp32)."""
        feats, vox = self.vfe(batch.points, batch.points_valid)
        # the strided convs' transpose tables serve the backward only
        plan = self.unet.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                              transpose=self.training)
        bev_st, point_st = self.unet(feats, plan)
        bev = height_compression(bev_st).to(bev_st.features.dtype)
        preds = self.dense_head(self.backbone_2d(bev))
        seg_feat = self.seg_mlp(point_st.features, point_st.valid)
        seg_logits = self.seg_out(seg_feat)[..., 0].float()
        part_pred = torch.sigmoid(self.part_out(seg_feat).float())
        return preds, point_st, seg_logits, part_pred

    def features(self, batch):
        return self.backbone(batch)[0]

    def part_loss(self, batch, point_st, seg_logits, part_pred):
        """The segmentation BCE over the valid voxels and the part BCE over
        the fg voxels (summed, / 3), each weighted by 1 / its count:
        (seg_loss, part_loss)."""
        with torch.autocast(seg_logits.device.type, enabled=False):
            fg, part_t = part_targets(self.voxel_centers(point_st), point_st.valid,
                                      batch.gt_boxes, batch.gt_valid)
            w = point_st.valid.float()
            w = w / torch.clamp(w.sum(), min=1.0)
            x, y = seg_logits, fg.float()
            bce = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
            seg_loss = (bce * w).sum()
            fg_w = fg.float()
            fg_w = fg_w / torch.clamp(fg_w.sum(), min=1.0)
            part_bce = -(part_t * torch.log(torch.clamp(part_pred, 1e-6, 1.0))
                         + (1 - part_t) * torch.log(torch.clamp(1 - part_pred, 1e-6, 1.0)))
            part_loss = (part_bce * fg_w[..., None]).sum() / 3.0
        return seg_loss, part_loss

    def pooled_grids(self, rois, roi_valid, point_st, seg_logits, part_pred):
        """The part stream ([part location, or the voxel centre with
        DISABLE_PART, zeroed where the detached score is below
        SEG_MASK_SCORE_THRESH; the score]) average-pooled and the decoder
        features max-pooled per RoI (partA2_head.py roiaware_pool:105-152):
        ((B, R, G, G, G, 4), (B, R, G, G, G, C)) fp32."""
        centers = self.voxel_centers(point_st)
        with torch.autocast(centers.device.type, enabled=False):
            score = torch.sigmoid(seg_logits.detach())
            src = centers if self.disable_part else part_pred
            part = torch.cat([torch.where(score[..., None] >= self.seg_mask_thresh, src, 0.0),
                              score[..., None]], dim=-1)
            g = self.roi_head.grid_size
            return (roiaware_pool(centers, part, point_st.valid, rois, roi_valid,
                                  self.roi_samples, g, "avg"),
                    roiaware_pool(centers, point_st.features.float(), point_st.valid, rois,
                                  roi_valid, self.roi_samples, g, "max"))

    def refine(self, rois, roi_valid, point_st, seg_logits, part_pred, dropout=None):
        part, rpn = self.pooled_grids(rois, roi_valid, point_st, seg_logits, part_pred)
        return self.roi_head(part, rpn, dropout)

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, seg_loss,
        part_loss, rcnn_cls_loss, rcnn_reg_loss, rpn_loss}) as JAX's
        PartA2Net.__call__, whose rpn_loss is the whole loss. `sampler`
        draws the proposal target layer's uniforms; `dropout` drives the FC
        dropout."""
        preds, point_st, seg_logits, part_pred = self.backbone(batch)
        rpn_total, tb = self.rpn_loss(preds, batch)
        seg_loss, part_loss = self.part_loss(batch, point_st, seg_logits, part_pred)
        tgt = self.sample_rois(preds, batch, sampler)
        b, m = tgt["rois"].shape[:2]
        # every sampled slot is a RoI, a zeroed padding proposal included
        roi_valid = torch.ones((b, m), dtype=torch.bool, device=tgt["rois"].device)
        rcnn_cls, rcnn_reg = self.refine(tgt["rois"], roi_valid, point_st, seg_logits, part_pred,
                                         dropout)
        rcnn_loss, rtb = self.roi_loss(rcnn_cls, rcnn_reg, tgt)
        total = rpn_total + seg_loss + part_loss + rcnn_loss
        tb.update({"seg_loss": seg_loss, "part_loss": part_loss,
                   "rcnn_cls_loss": rtb["rcnn_loss_cls"],
                   "rcnn_reg_loss": rtb["rcnn_loss_reg_total"], "rpn_loss": total})
        return total, tb

    def predict(self, batch):
        """Eval: (boxes (B, S, 7), scores, labels, valid), S = the final
        NMS's post size."""
        preds, point_st, seg_logits, part_pred = self.backbone(batch)
        rois, _, roi_labels, roi_valid = self.proposals(preds, False)
        rcnn_cls, rcnn_reg = self.refine(rois, roi_valid, point_st, seg_logits, part_pred)
        refined = roi_head.generate_predicted_boxes(rois[..., :7], rcnn_reg)
        scores = torch.where(roi_valid, torch.sigmoid(rcnn_cls), 0.0)
        return roi_head.final_nms(refined, scores, roi_labels, roi_valid,
                                  self.model_cfg.POST_PROCESSING)

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) and PartA2FCHead's (the
        conv_part / conv_rpn blocks, the FC towers); the UNet and the part
        head stay unmapped, as in the JAX package."""
        h = self.roi_head
        return {**super().reference_mapping(),
                **torch_convert.parta2_head_mapping(h.shared_fc.num, h.cls_fc.num,
                                                    h.reg_fc.num)}
