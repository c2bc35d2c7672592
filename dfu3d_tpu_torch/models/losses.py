"""Detection losses, fp32 and mask-aware (port of dfu3d_tpu/models/losses.py:
13-108): CenterPoint's clamped sigmoid, the CornerNet focal loss on gaussian
heat maps and the masked L1 at target cells; PointRCNN's point-head sigmoid
focal loss and weighted smooth-L1. The formulas are JAX's, term for term:
the BCE is clip(x, 0) - x·t + log1p(exp(-|x|)), not
F.binary_cross_entropy_with_logits, which rounds otherwise."""
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


def bce_with_logits(x, t):
    """clip(x, 0) - x·t + log1p(exp(-|x|)), JAX's form, with JAX's gradients
    at x = 0: the max splits it (as jnp.clip does) and |x| passes +1 (jnp.abs
    selects x where x >= 0; torch.abs passes 0 there)."""
    abs_x = torch.where(x >= 0, x, -x)
    return torch.maximum(x, torch.zeros_like(x)) - x * t + torch.log1p(torch.exp(-abs_x))


def sigmoid_focal_loss(pred_logits, target_onehot, weights, gamma: float = 2.0,
                       alpha: float = 0.25):
    """SigmoidFocalClassificationLoss (loss_utils.py:10-74), elementwise:
    pred_logits, target_onehot (B, A, C), weights (B, A) → (B, A, C)."""
    pred_logits = pred_logits.float()
    target = target_onehot.float()
    pred_sigmoid = torch.sigmoid(pred_logits)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    return focal_weight * bce_with_logits(pred_logits, target) * weights[..., None]


def weighted_smooth_l1(pred, target, weights, beta: float = 1.0 / 9.0, code_weights=None):
    """WeightedSmoothL1Loss (loss_utils.py:76-128): pred, target (B, A, D),
    weights (B, A) → (B, A, D)."""
    diff = pred.float() - target.float()
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=torch.float32, device=diff.device)
    n = diff.abs()
    loss = torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    return loss * weights[..., None]
