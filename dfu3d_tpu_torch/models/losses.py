"""CenterPoint's detection losses, fp32 and mask-aware (port of
dfu3d_tpu/models/losses.py:13-65): the clamped sigmoid, the CornerNet focal
loss on gaussian heat maps and the masked L1 at target cells."""
from __future__ import annotations

import torch


def sigmoid_clamped(x, eps: float = 1e-4):
    """sigmoid(x) clamped into [eps, 1 - eps] as jnp.clip clamps: a value on
    a bound gets half the gradient (torch.clamp would pass all of it; at
    fp32 resolution sigmoid lands exactly on 1 - 1e-4 for a 6e-4 wide band
    of logits)."""
    s = torch.sigmoid(x)
    return torch.minimum(torch.maximum(s, s.new_tensor(eps)), s.new_tensor(1.0 - eps))


def focal_loss_centernet(pred, gt):
    """CornerNet focal loss of probabilities `pred` against gaussian targets
    `gt` (same shape, in [0, 1]); normalised by the number of positives
    (cells where gt >= 1), or the negated negative term when there are none."""
    pred = pred.float()
    gt = gt.float()
    pos_mask = (gt >= 1.0).float()
    neg_mask = 1.0 - pos_mask
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = (torch.log(pred) * torch.pow(1.0 - pred, 2) * pos_mask).sum()
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights * neg_mask).sum()
    num_pos = pos_mask.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss_centernet(pred_feat, target, inds, mask):
    """Masked L1 per code dimension: pred_feat (B, H·W, D) read at inds
    (B, M), against target (B, M, D) where mask (B, M) is set and the target
    is finite; summed over boxes and divided by the live box count + 1e-4.
    Returns (D,)."""
    pred = torch.gather(pred_feat.float(), 1,
                        inds.long()[..., None].expand(-1, -1, pred_feat.shape[-1]))
    target = target.float()
    m = mask.float()[..., None] * torch.isfinite(target).float()
    err = torch.abs(pred * m - target * m)
    return err.sum(dim=(0, 1)) / (mask.float().sum() + 1e-4)
