"""MPPNet and MPPNetE2E, the multi-frame proposal-trajectory detectors (port
of dfu3d_tpu/models/mppnet.py; reference pcdet detectors/mppnet.py,
mppnet_e2e.py, roi_heads/mppnet_memory_bank_e2e.py).

    SECONDNet's first stage on the merged frames (MeanVFE over every point
    channel, the time lag included → VoxelBackBone8x → height compression →
    BaseBEVBackbone → the anchor head) → the proposal NMS (B1) → the
    trajectory of each proposal (`generate_trajectory`, one B1 launch per
    past frame) → `MPPNetHead` → `refine`: the RoI-frame decode, the score
    sqrt(sigmoid(cls) · max(roi_score, 1e-8)) and label 1 for every box.

Without a store of earlier frames' proposals every frame's proposal set is
the current one, so each proposal matches itself and the trajectory holds
station; the crops of the past frames still read those frames' points
around the current box. Every refined box gets label 1 (JAX mppnet.py:223),
whatever class its proposal had. Both are what the JAX package does
(ROADMAP Queue C).

Training adds the anchor loss, the proposal target layer at trajectory
frame 0 (its trajectories gathered by the sampled indices) and the head's
losses: the class loss averaged over the layers, the joint regression plus
AUX_WEIGHT times (the mean over layers and groups of the token regressions
plus the trajectory branch's).

MPPNetE2E's first stage sees only the points of lag < 1e-3; the head reads
every frame. `predict_with_bank` carries a `MemoryBank` of the last T - 1
frames' proxy geometry features across requests: its entries are matched
to the current trajectory by 3D IoU ≥ 0.5 (one B1 launch over every past
frame of the batch), the head computes fresh features for frame 0 only,
and the bank rolls (the new entry first, the oldest dropped).

The ROI_HEAD keys read are those JAX reads (mppnet.py:69-91): NUM_FRAMES,
NUM_GROUPS, SEQUENCE_STRIDE, GRID_SIZE, NUM_LIDAR_POINTS, HIDDEN,
NUM_LAYERS, NHEADS, DIM_FEEDFORWARD, MIXER_HIDDEN, POOL_RADIUS, NSAMPLE,
AUX_WEIGHT, the NMS keys, TARGET_CONFIG and LOSS_CONFIG; RADIUS,
NUM_PROXY_POINTS, CLASS_AGNOSTIC and MEMORY_BANK_LEN are not read.
Module names follow the flax tree (backbone_3d, backbone_2d, dense_head,
roi_head).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry.iou import pairwise_iou3d
from ..core.voxel import VoxelGrid
from . import roi_head
from .mppnet_head import MPPNetHead, generate_trajectory
from .pointpillar import SECONDNet


class MemoryBank(NamedTuple):
    """The E2E state carried across requests, per past frame: the proxy
    geometry features, their RoIs and whether each entry is valid."""

    feats: torch.Tensor   # (B, T-1, R, P, H) fp32
    rois: torch.Tensor    # (B, T-1, R, 7)
    valid: torch.Tensor   # (B, T-1, R) bool


class MPPNet(roi_head.RoIStage, SECONDNet):
    """The 4- or 16-frame MPPNet (waymo_models/mppnet_4frames.yaml,
    mppnet_16frames.yaml): `forward(batch, sampler=None, dropout=None)` →
    (loss, tb) with JAX's keys; `predict(batch)` → (boxes, scores, labels,
    valid) of the NMS_POST_MAXSIZE refined RoIs (no final NMS)."""

    first_stage_current_only = False

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__(model_cfg, class_names, grid, num_point_features=num_point_features,
                         max_voxels=max_voxels)
        rh = model_cfg.get("ROI_HEAD", {})
        hidden = int(rh.get("HIDDEN", 64))
        self.num_frames = int(rh.get("NUM_FRAMES", 4))
        self.num_rois = int(rh.get("NMS_POST_MAXSIZE", 64))
        self.aux_weight = float(rh.get("AUX_WEIGHT", 0.5))
        self.roi_head = MPPNetHead(
            num_point_features, num_frames=self.num_frames,
            num_groups=int(rh.get("NUM_GROUPS", min(self.num_frames, 4))),
            sequence_stride=int(rh.get("SEQUENCE_STRIDE", 1)),
            grid_size=int(rh.get("GRID_SIZE", 4)),
            num_lidar_points=int(rh.get("NUM_LIDAR_POINTS", 128)), hidden=hidden,
            enc_layers=int(rh.get("NUM_LAYERS", 3)), nheads=int(rh.get("NHEADS", 4)),
            ffn_hidden=int(rh.get("DIM_FEEDFORWARD", 4 * hidden)),
            mixer_hidden=int(rh.get("MIXER_HIDDEN", 16)),
            pool_radii=tuple(rh.get("POOL_RADIUS", (0.8, 1.6))),
            pool_nsample=int(rh.get("NSAMPLE", 16)))
        self._setup_roi_stage(rh)

    def rpn_batch(self, batch):
        """The points the first stage voxelizes: all of them, or for the E2E
        model those of the current frame (lag < 1e-3)."""
        if self.first_stage_current_only and batch.points.shape[-1] >= 5:
            return batch._replace(points_valid=batch.points_valid
                                  & (batch.points[..., -1] < 1e-3))
        return batch

    def features(self, batch):
        return self.dense_head(self.spatial_features(self.rpn_batch(batch)))

    def trajectory(self, rois, roi_valid):
        """Each frame's proposal set is the current one (no proposal store)."""
        t = self.num_frames
        props = rois[:, None].expand(-1, t, -1, -1)
        return generate_trajectory(rois, roi_valid, props, roi_valid[:, None].expand(-1, t, -1))

    def head_losses(self, out, tgt):
        """(rcnn_cls_loss, rcnn_reg_loss) in fp32 (JAX `_head_losses`)."""
        with torch.autocast(out["rcnn_reg"].device.type, enabled=False):
            cls = torch.stack([roi_head.roi_cls_loss(c, tgt["rcnn_cls_labels"], self.loss_cfg)
                               for c in out["cls_layers"]]).mean()

            def reg(pred):
                return roi_head.roi_reg_loss(pred, tgt, self.loss_cfg)[0]

            aux_point = torch.stack([reg(p) for layer in out["point_reg"] for p in layer]).mean()
            loss = reg(out["rcnn_reg"]) + self.aux_weight * (aux_point + reg(out["box_reg"]))
        return cls, loss

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        rcnn_cls_loss, rcnn_reg_loss}). `sampler` draws the proposal target
        layer's uniforms; `dropout` is not used (the head has no dropout)."""
        preds = self.features(batch)
        total, tb = self.rpn_loss(preds, batch)
        rois, roi_scores, roi_labels, roi_valid = self.proposals(preds, True)
        traj, traj_valid = self.trajectory(rois, roi_valid)
        uniforms = roi_head.draw_roi_uniforms(sampler, (rois.shape[0], 2, rois.shape[1]),
                                              rois.device)
        with torch.autocast(rois.device.type, enabled=False):
            tgt = roi_head.assign_roi_targets(uniforms, rois, roi_labels, roi_scores,
                                              batch.gt_boxes, batch.gt_valid, self.target_cfg)
        idx = tgt["sampled_idx"]
        t = traj.shape[1]
        s_traj = torch.gather(traj, 2, idx[:, None, :, None].expand(-1, t, -1, traj.shape[-1]))
        s_tvalid = torch.gather(traj_valid, 2, idx[:, None, :].expand(-1, t, -1))
        out = self.roi_head(tgt["rois"], torch.ones_like(idx, dtype=torch.bool), s_traj,
                            s_tvalid, batch.points, batch.points_valid)
        cls, reg = self.head_losses(out, tgt)
        tb.update({"rcnn_cls_loss": cls, "rcnn_reg_loss": reg})
        return total + cls + reg, tb

    def refine(self, out, rois, roi_scores, roi_valid):
        """(boxes, scores, labels, valid): the RoI-frame decode of the joint
        regression, sqrt(sigmoid(cls) · max(roi_score, 1e-8)), label 1."""
        with torch.autocast(rois.device.type, enabled=False):
            boxes = roi_head.generate_predicted_boxes(rois[..., :7], out["rcnn_reg"])
            scores = torch.sqrt(torch.sigmoid(out["rcnn_cls"])
                                * torch.clamp(roi_scores, min=1e-8))
        scores = torch.where(roi_valid, scores, 0.0)
        return boxes, scores, torch.ones_like(roi_valid, dtype=torch.int64), roi_valid

    def stage_one(self, batch):
        """The serving path up to the head: rois, scores, valid, the
        trajectory and its valid length."""
        rois, roi_scores, _, roi_valid = self.proposals(self.features(batch), False)
        traj, traj_valid = self.trajectory(rois, roi_valid)
        return rois, roi_scores, roi_valid, traj, traj_valid

    def predict(self, batch):
        rois, roi_scores, roi_valid, traj, traj_valid = self.stage_one(batch)
        out = self.roi_head(rois, roi_valid, traj, traj_valid, batch.points, batch.points_valid)
        return self.refine(out, rois, roi_scores, roi_valid)

    def reference_mapping(self):
        raise NotImplementedError(
            "MPPNet has no reference mapping: the JAX package maps no OpenPCDet MPPNet "
            "checkpoint (train/torch_convert.py), so none loads into the port")


class MPPNetE2E(MPPNet):
    """MPPNet with the end-to-end memory bank
    (waymo_models/mppnet_e2e_memorybank_inference.yaml): the first stage on
    the current frame's points; `predict_with_bank(batch, bank)` →
    ((boxes, scores, labels, valid), the rolled bank)."""

    first_stage_current_only = True

    def empty_bank(self, batch_size: int) -> MemoryBank:
        dev = self.roi_head.token.device
        tm1, r = self.num_frames - 1, self.num_rois
        return MemoryBank(
            feats=torch.zeros(batch_size, tm1, r, self.roi_head.num_proxy, self.roi_head.hidden,
                              device=dev),
            rois=torch.zeros(batch_size, tm1, r, 7, device=dev),
            valid=torch.zeros(batch_size, tm1, r, dtype=torch.bool, device=dev))

    @staticmethod
    def match_bank(traj, traj_valid, bank: MemoryBank):
        """Each past frame's bank entries reordered onto the current
        trajectory: the entry of largest 3D IoU (first among ties, invalid
        entries at -1), kept where that IoU is ≥ 0.5 and the trajectory box
        is valid. One B1 launch over (B · (T - 1)) problems. Returns the
        gathered features (B, T-1, R, P, H) and their validity (B, T-1, R)."""
        b, tm1, r = bank.valid.shape
        cur = traj[:, 1:, :, :7].reshape(b * tm1, -1, 7)
        iou = pairwise_iou3d(cur, bank.rois.reshape(b * tm1, r, 7)).reshape(b, tm1, -1, r)
        iou = torch.where(bank.valid[:, :, None, :], iou, -1.0)
        best_iou, best = iou.max(dim=-1)
        ok = (best_iou >= 0.5) & traj_valid[:, 1:]
        feats = torch.gather(bank.feats, 2, best[..., None, None].expand(
            -1, -1, -1, *bank.feats.shape[-2:]))
        return feats, ok

    def predict_with_bank(self, batch, bank: MemoryBank):
        rois, roi_scores, roi_valid, traj, traj_valid = self.stage_one(batch)
        feats, ok = self.match_bank(traj, traj_valid, bank)
        out = self.roi_head(rois, roi_valid, traj, traj_valid, batch.points, batch.points_valid,
                            geometry_bank=feats, bank_valid=ok)
        new_bank = MemoryBank(
            feats=torch.cat([out["geometry_memory"].float()[:, None], bank.feats[:, :-1]], 1),
            rois=torch.cat([rois[..., :7][:, None], bank.rois[:, :-1]], 1),
            valid=torch.cat([roi_valid[:, None], bank.valid[:, :-1]], 1))
        return self.refine(out, rois, roi_scores, roi_valid), new_bank


def make_bank_eval_step(model: MPPNetE2E, recall_thresh=None, device="cuda",
                        dtype=torch.float32):
    """`train_state.make_eval_step` for a stream of requests through the
    memory bank: bank_step(batch, bank) → ((boxes, scores, labels, valid[,
    recall]), the rolled bank). Start from `model.empty_bank(B)`."""
    from ..device import resolve_device
    from ..train.train_state import _autocast, recall_record

    dev = resolve_device(device)

    @torch.no_grad()
    def bank_step(batch, bank):
        if model.training:
            model.eval()
        batch = batch.to(dev)
        with _autocast(dev, dtype):
            out, bank = model.predict_with_bank(batch, bank)
        if recall_thresh is not None:
            out = out + (recall_record(out[0], out[3], batch, recall_thresh),)
        return out, bank

    return bank_step
