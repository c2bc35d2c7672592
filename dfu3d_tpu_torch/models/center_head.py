"""CenterHead forward, target assignment, loss and post-processing (port of
dfu3d_tpu/models/center_head.py).

Where all (head, branch) towers share one depth (every shipped config), they
run as the JAX package runs them (FusedSeparateHeads): one dense conv to
G·Cmid channels, one BN, then one grouped out conv whose branch outputs are
padded to the widest branch. Where NUM_HM_CONV and the branches' NUM_CONV
differ, each head is a per-tower SeparateHead (head_{h}), as in JAX.
Targets are the JAX package's vectorised gaussian splat: per class one outer
product over (B, M, H, W) and a max over the M boxes. Post-processing runs
rotated NMS (`nms_bev`, kernel B1) or, with NMS_TYPE circle_nms, the
centre-distance NMS (`circle_nms`, no kernel).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry.nms import circle_nms, nms_bev, top_k
from ..train import torch_convert
from . import losses
from .backbone_2d import BatchNorm


def gaussian_radius(height, width, min_overlap: float = 0.1):
    """CenterNet gaussian radius (centernet_utils.gaussian_radius)."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4.0 * c2, min=0.0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


class HeadTargets(NamedTuple):
    heatmap: torch.Tensor       # (B, H, W, C_head)
    target_boxes: torch.Tensor  # (B, M, 8 | 10)
    inds: torch.Tensor          # (B, M) int64 cell index y · W + x
    mask: torch.Tensor          # (B, M) bool


class FusedSeparateHeads(nn.Module):
    """All heads × all branches as G-fused convolutions.

    branch_specs: ((head_idx, name, out_channels), ...) in param order.
    Input and outputs are NCHW; each output map is (B, H, W, c) fp32.
    """

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, branch_specs: Tuple[Tuple[int, str, int], ...],
                 num_heads: int, num_conv: int, mid_channels: int, init_bias: float = -2.19,
                 use_bias: bool = True):
        super().__init__()
        self.branch_specs = tuple(branch_specs)
        self.num_heads = num_heads
        self.num_conv = num_conv
        g = len(self.branch_specs)
        cm = mid_channels
        self.out_max = max(oc for _, _, oc in self.branch_specs)
        cin = in_channels
        for t in range(num_conv - 1):
            self.add_module(f"conv{t}", nn.Conv2d(cin, g * cm, 3, padding=1, bias=use_bias,
                                                  groups=1 if t == 0 else g))
            self.add_module(f"bn{t}", BatchNorm(g * cm, eps=1e-5, keep=0.9))
            cin = g * cm
        self.out = nn.Conv2d(cin, g * self.out_max, 3, padding=1, bias=True,
                             groups=1 if num_conv == 1 else g)
        with torch.no_grad():
            self.out.bias.zero_()
            for i, (_, name, oc) in enumerate(self.branch_specs):
                if name == "hm":
                    self.out.bias[i * self.out_max:i * self.out_max + oc] = init_bias

    def forward(self, x):
        h = x
        for t in range(self.num_conv - 1):
            h = F.relu(getattr(self, f"bn{t}")(getattr(self, f"conv{t}")(h)))
        out = self.out(h).permute(0, 2, 3, 1)
        preds = [dict() for _ in range(self.num_heads)]
        om = self.out_max
        for i, (hidx, name, oc) in enumerate(self.branch_specs):
            preds[hidx][name] = out[..., i * om:i * om + oc].float()
        return preds


class SeparateHead(nn.Module):
    """One head's per-branch towers (JAX SeparateHead, center_head.py:55-92;
    reference center_head.py:12-47): per branch, in `head_dict` order,
    (num_conv - 1) × [3×3 conv at the input width ({name}_conv{k}), BN
    ({name}_bn{k}), ReLU], then the 3×3 out conv ({name}_out, biased; the hm
    bias starts at -2.19). NCHW in; each output (B, H, W, c) fp32.

    head_dict: name → (out_channels, num_conv)."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, head_dict: Dict[str, Tuple[int, int]],
                 init_bias: float = -2.19, use_bias: bool = True):
        super().__init__()
        self.head_dict = dict(head_dict)
        for name, (out_ch, num_conv) in self.head_dict.items():
            for k in range(num_conv - 1):
                self.add_module(f"{name}_conv{k}", nn.Conv2d(in_channels, in_channels, 3,
                                                             padding=1, bias=use_bias))
                self.add_module(f"{name}_bn{k}", BatchNorm(in_channels, eps=1e-5, keep=0.9))
            out = nn.Conv2d(in_channels, out_ch, 3, padding=1, bias=True)
            nn.init.constant_(out.bias, init_bias if name == "hm" else 0.0)
            self.add_module(f"{name}_out", out)

    def forward(self, x):
        preds = {}
        for name, (_, num_conv) in self.head_dict.items():
            h = x
            for k in range(num_conv - 1):
                h = F.relu(getattr(self, f"{name}_bn{k}")(getattr(self, f"{name}_conv{k}")(h)))
            preds[name] = getattr(self, f"{name}_out")(h).permute(0, 2, 3, 1).float()
        return preds


class CenterHead(nn.Module):
    """config: CLASS_NAMES_EACH_HEAD, SHARED_CONV_CHANNEL, NUM_HM_CONV,
    SEPARATE_HEAD_CFG, TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE, POST_PROCESSING."""

    GLOBAL_BATCH = True

    def __init__(self, in_channels: int, class_names: Sequence[str],
                 class_names_each_head: Sequence[Sequence[str]], shared_conv_channel: int,
                 num_hm_conv: int, head_dict: Dict[str, Dict[str, int]],
                 point_cloud_range: Sequence[float], voxel_size: Sequence[float],
                 feature_map_stride: int, use_bias_before_norm: bool = True,
                 head_order: Optional[Sequence[str]] = None, gaussian_overlap: float = 0.1,
                 min_radius: int = 2):
        super().__init__()
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.feature_map_stride = float(feature_map_stride)
        self.num_heads = len(class_names_each_head)
        self.num_classes = len(class_names)
        self.head_order = tuple(head_order) if head_order is not None else tuple(head_dict)
        self.gaussian_overlap = float(gaussian_overlap)
        self.min_radius = int(min_radius)
        # per head: 1-based global class id of each local class
        self.class_id_mapping_each_head = tuple(
            tuple(list(class_names).index(n) + 1 for n in names)
            for names in class_names_each_head)
        # per 1-based global class id: its head and its local id there
        head_of = [0] * (self.num_classes + 1)
        local_of = [0] * (self.num_classes + 1)
        for h, ids in enumerate(self.class_id_mapping_each_head):
            for j, gid in enumerate(ids):
                head_of[gid], local_of[gid] = h, j
        self._head_of, self._local_of = tuple(head_of), tuple(local_of)

        self.shared_conv = nn.ModuleDict({
            "layers_0": nn.Conv2d(in_channels, shared_conv_channel, 3, padding=1,
                                  bias=use_bias_before_norm)})
        self.shared_bn = BatchNorm(shared_conv_channel, eps=1e-5, keep=0.9)
        convs = {num_hm_conv} | {v["num_conv"] for v in head_dict.values()}
        self.fused = len(convs) == 1
        if not self.fused:
            # towers of different depths: one SeparateHead per head, head_{h}
            for h, names in enumerate(class_names_each_head):
                hd = {k: (v["out_channels"], v["num_conv"]) for k, v in head_dict.items()}
                hd["hm"] = (len(names), num_hm_conv)
                self.add_module(f"head_{h}", SeparateHead(shared_conv_channel, hd,
                                                          use_bias=use_bias_before_norm))
            return
        specs = []
        for h, names in enumerate(class_names_each_head):
            hd = {k: v["out_channels"] for k, v in head_dict.items()}
            hd["hm"] = len(names)
            specs.extend((h, name, oc) for name, oc in hd.items())
        self.fused_heads = FusedSeparateHeads(
            shared_conv_channel, tuple(specs), self.num_heads, num_conv=next(iter(convs)),
            mid_channels=shared_conv_channel, use_bias=use_bias_before_norm)

    def forward(self, spatial_features_2d):
        """(B, H, W, C) → list over heads of {branch: (B, H, W, c) fp32}."""
        x = spatial_features_2d.permute(0, 3, 1, 2)
        x = F.relu(self.shared_bn(self.shared_conv["layers_0"](x)))
        if self.fused:
            return self.fused_heads(x)
        return [getattr(self, f"head_{h}")(x) for h in range(self.num_heads)]

    def reference_mapping(self):
        """The reference-checkpoint keys of the shared conv and the towers:
        the fused layout's, or the per-tower SeparateHeads'."""
        if self.fused:
            return torch_convert.center_head_mapping(self.fused_heads.branch_specs)
        return torch_convert.separate_heads_mapping(
            [getattr(self, f"head_{h}").head_dict for h in range(self.num_heads)])

    # ------------------------------------------------------------------
    # Targets and loss (train)
    # ------------------------------------------------------------------

    def assign_targets(self, gt_boxes, gt_valid, feature_map_size):
        """gt_boxes (B, M, 8 | 10) lidar boxes [+ (vx, vy)] + 1-based class
        id, gt_valid (B, M) → a HeadTargets per head at the (H, W) map."""
        H, W = feature_map_size
        dev = gt_boxes.device
        pcr, vs, stride = self.point_cloud_range, self.voxel_size, self.feature_map_stride
        gt_boxes = gt_boxes.float()

        cls_id = torch.clamp(gt_boxes[..., -1].to(torch.int64), 0, self.num_classes)
        head_of = torch.tensor(self._head_of, device=dev)[cls_id]
        local_of = torch.tensor(self._local_of, device=dev)[cls_id]

        coord_x = torch.clamp((gt_boxes[..., 0] - pcr[0]) / vs[0] / stride, 0.0, W - 0.5)
        coord_y = torch.clamp((gt_boxes[..., 1] - pcr[1]) / vs[1] / stride, 0.0, H - 0.5)
        cx_int = coord_x.to(torch.int64)
        cy_int = coord_y.to(torch.int64)
        dx = gt_boxes[..., 3] / vs[0] / stride
        dy = gt_boxes[..., 4] / vs[1] / stride
        radius = torch.clamp(gaussian_radius(dx, dy, self.gaussian_overlap).to(torch.int64),
                             min=self.min_radius)
        live = gt_valid & (dx > 0) & (dy > 0) & (cls_id > 0)

        # a gaussian around each box's integer centre (reference
        # draw_gaussian_to_heatmap: sigma = (2r + 1) / 6, window clipped at r)
        off_y = torch.arange(H, device=dev)[None, None, :] - cy_int[..., None]   # (B, M, H)
        off_x = torch.arange(W, device=dev)[None, None, :] - cx_int[..., None]   # (B, M, W)
        sigma = (2.0 * radius.float() + 1.0) / 6.0
        inv_2s2 = (1.0 / (2.0 * sigma * sigma))[..., None]
        g_y = torch.exp(-(off_y.float() ** 2) * inv_2s2)
        g_x = torch.exp(-(off_x.float() ** 2) * inv_2s2)
        g_y = torch.where((off_y.abs() <= radius[..., None]) & live[..., None], g_y, 0.0)
        g_x = torch.where(off_x.abs() <= radius[..., None], g_x, 0.0)

        target_boxes = torch.stack([
            coord_x - cx_int.float(), coord_y - cy_int.float(), gt_boxes[..., 2],
            torch.log(torch.clamp(gt_boxes[..., 3], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[..., 4], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[..., 5], min=1e-6)),
            torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], dim=-1)
        if gt_boxes.shape[-1] > 8:
            # velocity-width gt: raw (vx, vy) targets of the 'vel' branch
            target_boxes = torch.cat([target_boxes, gt_boxes[..., 7:-1]], dim=-1)
        inds = cy_int * W + cx_int

        results = []
        for h, ids in enumerate(self.class_id_mapping_each_head):
            in_head = live & (head_of == h)
            maps = []
            for c in range(len(ids)):
                gy = torch.where((in_head & (local_of == c))[..., None], g_y, 0.0)
                # outer product per box, then the max over boxes: (B, H, W)
                maps.append((gy[..., :, None] * g_x[..., None, :]).amax(dim=1))
            results.append(HeadTargets(
                heatmap=torch.stack(maps, dim=-1),
                target_boxes=torch.where(in_head[..., None], target_boxes, 0.0),
                inds=torch.where(in_head, inds, 0),
                mask=in_head))
        return results

    def get_loss(self, pred_dicts, target_list, loss_weights):
        """Sum over heads of the focal heat-map loss and the code-weighted L1
        (reference get_loss). Returns (loss, {hm_loss_head_i, loc_loss_head_i,
        rpn_loss})."""
        total = 0.0
        tb = {}
        code_weights = torch.tensor(loss_weights["code_weights"], dtype=torch.float32,
                                    device=pred_dicts[0]["hm"].device)
        for idx, (pred, tgt) in enumerate(zip(pred_dicts, target_list)):
            hm = losses.sigmoid_clamped(pred["hm"])
            hm_loss = losses.focal_loss_centernet(hm, tgt.heatmap) * loss_weights["cls_weight"]
            reg_maps = torch.cat([pred[name] for name in self.head_order], dim=-1)
            bsz, H, W, D = reg_maps.shape
            if tgt.target_boxes.shape[-1] != D:
                raise ValueError(
                    f"reg target width {tgt.target_boxes.shape[-1]} != predicted {D}: a 'vel' "
                    "head needs velocity-width (10-column) gt boxes")
            reg_loss = losses.reg_loss_centernet(reg_maps.reshape(bsz, H * W, D),
                                                 tgt.target_boxes, tgt.inds, tgt.mask)
            loc_loss = (reg_loss * code_weights[:D]).sum() * loss_weights["loc_weight"]
            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{idx}"] = hm_loss
            tb[f"loc_loss_head_{idx}"] = loc_loss
        tb["rpn_loss"] = total
        return total, tb

    # ------------------------------------------------------------------
    # Decode (eval): fixed-size masked outputs
    # ------------------------------------------------------------------

    def decode_topk(self, pred_dicts, post_cfg):
        """Per-head top-K peaks → lidar boxes. Returns a list over heads of
        (boxes (B, K, 7|9), scores (B, K), cls (B, K) local ids, valid (B, K))."""
        k = int(post_cfg.MAX_OBJ_PER_SAMPLE)
        score_thresh = float(post_cfg.get("SCORE_THRESH", 0.0))
        pcr, vs, stride = self.point_cloud_range, self.voxel_size, self.feature_map_stride

        out = []
        for pred in pred_dicts:
            hm = torch.sigmoid(pred["hm"].float())  # (B, H, W, C)
            bsz, H, W, C = hm.shape
            post_range = torch.tensor(post_cfg.POST_CENTER_LIMIT_RANGE, dtype=torch.float32,
                                      device=hm.device)
            # (B, H, W, C) → (B, C, H*W): flat top-K over classes × cells
            hm_flat = hm.permute(0, 3, 1, 2).reshape(bsz, C * H * W)
            scores, inds = top_k(hm_flat, min(k, C * H * W))
            cls = inds // (H * W)
            spatial = inds % (H * W)
            ys = (spatial // W).float()
            xs = (spatial % W).float()

            def gather(name):
                maps = pred[name].float().reshape(bsz, H * W, -1)
                return torch.gather(maps, 1, spatial[..., None].expand(-1, -1, maps.shape[-1]))

            center = gather("center")
            center_z = gather("center_z")[..., 0]
            dim = torch.exp(gather("dim"))
            rot = gather("rot")
            angle = torch.atan2(rot[..., 1], rot[..., 0])

            xs = (xs + center[..., 0]) * stride * vs[0] + pcr[0]
            ys = (ys + center[..., 1]) * stride * vs[1] + pcr[1]
            boxes = torch.stack(
                [xs, ys, center_z, dim[..., 0], dim[..., 1], dim[..., 2], angle], dim=-1)
            if "vel" in pred:
                boxes = torch.cat([boxes, gather("vel")], dim=-1)

            valid = (
                (boxes[..., :3] >= post_range[:3]).all(dim=-1)
                & (boxes[..., :3] <= post_range[3:]).all(dim=-1)
                & (scores > score_thresh)
            )
            out.append((boxes, scores, cls, valid))
        return out

    def generate_predicted_boxes(self, pred_dicts, post_cfg):
        """Per-head top-K decode + rotated NMS, concatenated across heads.

        All heads with the same candidate count go through one batched
        `nms_bev`, so one IoU kernel launch covers B × heads problems. With
        NMS_TYPE circle_nms they go through one batched `circle_nms` instead
        (NMS_THRESH the least centre distance in metres, over every
        candidate; JAX center_head.py:447-455), which launches no kernel.
        Returns (boxes (B, S, 7|9), scores (B, S), labels (B, S) 1-based,
        valid (B, S)) with S = num_heads * NMS_POST_MAXSIZE.
        """
        nms_cfg = post_cfg.NMS_CONFIG
        circle = nms_cfg.get("NMS_TYPE", "nms_gpu") == "circle_nms"
        pre_max = min(int(nms_cfg.NMS_PRE_MAXSIZE), int(post_cfg.MAX_OBJ_PER_SAMPLE))
        post_max = int(nms_cfg.NMS_POST_MAXSIZE)
        nms_thresh = float(nms_cfg.NMS_THRESH)

        decoded = self.decode_topk(pred_dicts, post_cfg)
        groups = defaultdict(list)
        for h, (_, scores, _, _) in enumerate(decoded):
            groups[scores.shape[1]].append(h)
        selected = [None] * len(decoded)
        for k_eff, heads in groups.items():
            boxes = torch.stack([decoded[h][0][..., :7] for h in heads])  # (Hg, B, K, 7)
            scores = torch.stack([decoded[h][1] for h in heads])
            valid = torch.stack([decoded[h][3] for h in heads])
            hg, bsz = scores.shape[:2]
            args = (boxes.reshape(hg * bsz, k_eff, 7), scores.reshape(hg * bsz, k_eff),
                    nms_thresh)
            if circle:
                sel, keep = circle_nms(*args, post_max=post_max,
                                       valid=valid.reshape(hg * bsz, k_eff))
            else:
                sel, keep = nms_bev(*args, pre_max=min(pre_max, k_eff), post_max=post_max,
                                    valid=valid.reshape(hg * bsz, k_eff))
            sel = sel.reshape(hg, bsz, -1)
            keep = keep.reshape(hg, bsz, -1)
            for i, h in enumerate(heads):
                selected[h] = (sel[i], keep[i])

        all_boxes, all_scores, all_labels, all_valid = [], [], [], []
        for h, (boxes, scores, cls, _) in enumerate(decoded):
            sel, keep = selected[h]
            sel_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1]))
            sel_scores = torch.gather(scores, 1, sel)
            sel_cls = torch.gather(cls, 1, sel)
            mapping = torch.tensor(self.class_id_mapping_each_head[h], device=cls.device)
            sel_labels = mapping[torch.clamp(sel_cls, 0, len(mapping) - 1)]
            all_boxes.append(sel_boxes)
            all_scores.append(torch.where(keep, sel_scores, 0.0))
            all_labels.append(torch.where(keep, sel_labels, 0))
            all_valid.append(keep)
        return (torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1),
                torch.cat(all_labels, dim=1), torch.cat(all_valid, dim=1))
