"""Residual box coder (port of dfu3d_tpu/models/anchor_head.py:81-128, the
reference's ResidualCoder, box_coder_utils.py:5-80). The RoI head decodes
its refinements with it; the anchor heads join this module when they are
ported."""
from __future__ import annotations

import torch


def encode_boxes(boxes, anchors):
    """(…, 7) gt boxes against (…, 7) anchors → (…, 7) residual targets."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    dxa = torch.clamp(anchors[..., 3], min=1e-5)
    dya = torch.clamp(anchors[..., 4], min=1e-5)
    dza = torch.clamp(anchors[..., 5], min=1e-5)
    ra = anchors[..., 6]
    xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dxg = torch.clamp(boxes[..., 3], min=1e-5)
    dyg = torch.clamp(boxes[..., 4], min=1e-5)
    dzg = torch.clamp(boxes[..., 5], min=1e-5)
    rg = boxes[..., 6]
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                        torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                        rg - ra], dim=-1)


def decode_boxes(encodings, anchors):
    """(…, 7) residuals on (…, 7) anchors → (…, 7) boxes."""
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
    ra = anchors[..., 6]
    xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
    dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]
    rt = encodings[..., 6]
    diagonal = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                        torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza,
                        rt + ra], dim=-1)
