"""SECOND-IoU: SECONDNet with a SECONDHead IoU-scoring second stage (port of
dfu3d_tpu/models/second_iou.py; the reference's detectors/second_net_iou.py
and roi_heads/second_head.py).

    SECONDNet's trunk and anchor RPN → proposal NMS → rotated BEV RoI-align
    of each proposal from the detached 2D features (`bev_roi_align`) →
    channel-major flatten → SHARED_FC → IOU_FC: one IoU logit per RoI.

Training adds the proposal target layer and the IoU loss (BCE, L2 or
smooth-L1) against the soft roi_iou labels; serving scores the unrefined
RoIs by the sigmoid IoU and runs the final NMS on them
(second_net_iou.post_processing:75-128). Module names follow the flax tree
(backbone_3d, backbone_2d, dense_head, shared_fc, iou_fc).
"""
from __future__ import annotations

import torch

from ..core.voxel import VoxelGrid
from ..train import torch_convert
from . import roi_head
from .pointpillar import SECONDNet


def bev_roi_align(feats, rois, grid_size: int, pcr, voxel_size, stride: float):
    """Rotated BEV RoI-align (second_head.py roi_grid_pool:64-121), the
    reference's affine_grid / grid_sample(align_corners=True, zeros) lattice:
        px(u, v) = cx + hx·(u·cos a − v·sin a)
        py(u, v) = cy + hy·(u·sin a + v·cos a)
    u along the output's width, v along its height, both linspace(-1, 1,
    G); (cx, cy) the RoI's centre in feature-map pixels with no half-pixel
    offset, (hx, hy) its half extents in pixels. Bilinear taps outside the
    map read 0.

    feats (B, H, W, C) with rows = y; rois (B, R, 7+) world boxes; pcr and
    voxel_size sequences → (B, R, G, G, C) fp32, rows = v."""
    b, h, w, c = feats.shape
    dev = feats.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(pcr, dtype=torch.float32, device=dev)
    sx, sy = vs[0] * stride, vs[1] * stride
    cxp = (rois[..., 0] - lo[0]) / sx
    cyp = (rois[..., 1] - lo[1]) / sy
    hx = rois[..., 3] / (2.0 * sx)
    hy = rois[..., 4] / (2.0 * sy)
    # jnp.linspace rounds a few entries an ulp away from torch's
    lin = torch.linspace(-1.0, 1.0, grid_size, device=dev)
    vg, ug = torch.meshgrid(lin, lin, indexing="ij")   # rows = v, cols = u
    cosa = torch.cos(rois[..., 6])[..., None, None]
    sina = torch.sin(rois[..., 6])[..., None, None]
    px = cxp[..., None, None] + hx[..., None, None] * (ug * cosa - vg * sina)
    py = cyp[..., None, None] + hy[..., None, None] * (ug * sina + vg * cosa)
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    dx = (px - x0)[..., None]
    dy = (py - y0)[..., None]
    flat = feats.float().reshape(b, h * w, c)
    rows = torch.arange(b, device=dev).view(b, 1, 1, 1)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        f = flat[rows, yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(ok[..., None], f, 0.0)

    return (tap(y0, x0) * (1 - dy) * (1 - dx)
            + tap(y0, x0 + 1) * (1 - dy) * dx
            + tap(y0 + 1, x0) * dy * (1 - dx)
            + tap(y0 + 1, x0 + 1) * dy * dx)


def iou_loss(x, labels, kind: str):
    """get_box_iou_layer_loss's per-RoI term (second_head.py:160-188)."""
    if kind == "BinaryCrossEntropy":
        return torch.clamp(x, min=0) - x * labels + torch.log1p(torch.exp(-x.abs()))
    if kind == "L2":
        return torch.square(x - labels)
    if kind == "smoothL1":
        n = (x - labels).abs()
        beta = 1.0 / 9.0
        return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    raise NotImplementedError(kind)


class SECONDNetIoU(roi_head.RoIStage, SECONDNet):
    """SECONDNet (MeanVFE, VoxelBackBone8x, BEV backbone, anchor head) and
    the SECONDHead IoU stage. `forward` returns (loss, tb) with JAX's keys;
    `predict` returns the final NMS over the RoIs scored by their IoU."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features=num_point_features,
                         max_voxels=max_voxels)
        rh = model_cfg.get("ROI_HEAD", {})
        if rh.get("NAME", "SECONDHead") != "SECONDHead":
            raise NotImplementedError(f"ROI_HEAD {rh.NAME} with SECONDNetIoU is not ported")
        pool = rh.get("ROI_GRID_POOL", {})
        self.roi_grid = int(pool.get("GRID_SIZE", 7))
        self.roi_stride = float(pool.get("DOWNSAMPLE_RATIO", 8))
        dp = float(rh.get("DP_RATIO", 0.3))
        c = self.backbone_2d.out_channels * self.roi_grid ** 2
        self.shared_fc = roi_head.shared_fc_stack(c, tuple(rh.get("SHARED_FC", (256, 256))), dp)
        self.iou_fc = roi_head.make_fc_stack(self.shared_fc.out_channels,
                                             tuple(rh.get("IOU_FC", (256, 256))), 1, dp)
        self._setup_roi_stage(rh)
        loss_cfg = rh.get("LOSS_CONFIG", {})
        self.iou_loss_kind = loss_cfg.get("IOU_LOSS", "BinaryCrossEntropy")
        self.iou_weight = float(roi_head.roi_head_loss_cfg(rh)["LOSS_WEIGHTS"].get(
            "rcnn_iou_weight", 1.0))

    def iou_head(self, spatial, rois, dropout=None):
        """RoI-align over the detached spatial features and RoIs (second_head.py
        :75-76), channel-major flatten, SHARED_FC → IOU_FC: (B, R) fp32."""
        g = self.roi_grid
        with torch.no_grad():
            pooled = bev_roi_align(spatial.detach(), rois.detach(), g,
                                   self.grid.point_cloud_range, self.grid.voxel_size,
                                   self.roi_stride)
        b, r, c = pooled.shape[0], pooled.shape[1], pooled.shape[-1]
        x = pooled.reshape(b * r, g * g, c).transpose(1, 2).reshape(b * r, -1)
        return self.iou_fc(self.shared_fc(x, dropout), dropout).reshape(b, r).float()

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        iou_loss, rcnn_loss_iou}) as JAX's SECONDNetIoU.__call__. `sampler`
        draws the proposal target layer's uniforms; `dropout` drives the FC
        stacks' dropout."""
        spatial = self.spatial_features(batch)
        preds = self.dense_head(spatial)
        total, tb = self.rpn_loss(preds, batch)
        tgt = self.sample_rois(preds, batch, sampler)
        rcnn_iou = self.iou_head(spatial, tgt["rois"], dropout)
        with torch.autocast(rcnn_iou.device.type, enabled=False):
            labels = tgt["rcnn_cls_labels"].reshape(-1)
            per = iou_loss(rcnn_iou.reshape(-1), labels, self.iou_loss_kind)
            mask = (labels >= 0).float()
            loss = self.iou_weight * (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        tb.update({"iou_loss": loss, "rcnn_loss_iou": loss})
        return total + loss, tb

    def predict(self, batch):
        """Eval: the RoIs (unrefined) scored by their sigmoid IoU through the
        final NMS: (boxes, scores, labels, valid)."""
        spatial = self.spatial_features(batch)
        preds = self.dense_head(spatial)
        rois, _, roi_labels, roi_valid = self.proposals(preds, False)
        scores = torch.where(roi_valid, torch.sigmoid(self.iou_head(spatial, rois)), 0.0)
        return roi_head.final_nms(rois[..., :7], scores, roi_labels, roi_valid,
                                  self.model_cfg.POST_PROCESSING)

    def reference_mapping(self):
        """The RPN's (2D backbone, AnchorHeadSingle) and SECONDHead's
        SHARED_FC / IOU_FC stacks; the sparse backbone stays unmapped."""
        return {**super().reference_mapping(),
                **torch_convert.second_head_mapping(self.shared_fc.num, self.iou_fc.num)}
