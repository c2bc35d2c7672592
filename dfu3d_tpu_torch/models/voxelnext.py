"""VoxelNeXt, the fully sparse detector (port of dfu3d_tpu/models/voxelnext.py,
reference pcdet detectors/voxelnext.py + dense_heads/voxelnext_head.py).

    MeanVFE → VoxelResBackBone8xVoxelNeXt (strides 8, 16, 32) → the three
    sets mapped onto the stride-8 grid and z-collapsed into BEV_CAP cells
    (`sparse_bev_collapse`) → conv_out → shared_conv → one
    VoxelNeXtSeparateHead per CLASS_NAMES_EACH_HEAD group

or, where BACKBONE_3D names another trunk, the JAX module's legacy compact
path (voxelnext.py:154-175): VoxelBackBone8x (CHANNELS, OUT_CHANNELS) →
two plain strided convs to strides 16 and 32 (down16, down32; no BN) →
the same collapse → NUM_SHARED_BLOCKS (3, 3, 1) blocks (bev_block{i}) →
the heads.

No dense BEV map is built. Every sparse conv is one launch of kernel B2, the
BEV convs and the head's included; `predict` ends in `nms_bev`, one launch
of B1 for the whole batch. Module names follow the flax tree (backbone_3d,
conv_out, shared_conv, down16, down32, bev_block{i}, head_{g}.{branch}_conv{i},
head_{g}.{branch}_out).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core.geometry.iou import aligned_iou3d
from ..core.geometry.nms import nms_bev, top_k
from ..core.voxel import VoxelGrid, segment_sum_sorted
from ..core.voxel.sparse_ops import (
    SparseGrid,
    build_lookup,
    downsample_coords,
    find_neighbors,
    kernel_offsets,
    linearize,
)
from . import losses
from .sparse_backbone import (
    SparseConv3dDown,
    SparseConvBlock,
    SparseTensor,
    VoxelResBackBone8xVoxelNeXt,
)
from .vfe import MeanVFE

NEXT_BACKBONES = ("VoxelResBackBone8xVoxelNeXt", "VoxelResBackBone8xVoxelNeXt2D")


def _sum_into(feats, slot, valid, cap: int):
    """Per sample, the rows of `feats` (B, N, C) where `valid`, summed in
    fp32 into the `cap` slots that `slot` (B, N; cap = dropped) names: in
    order over sorted segments, no atomics. Returns (B, cap, C) fp32."""
    b, n, c = feats.shape
    base = torch.arange(b, device=feats.device)[:, None] * cap
    ids = torch.where(valid & (slot < cap), slot + base, b * cap).reshape(-1)
    order = torch.argsort(ids, stable=True)
    rows = torch.where(valid[..., None], feats, 0).float().reshape(b * n, c)
    return segment_sum_sorted(rows[order], ids[order], b * cap).view(b, cap, c)


def sparse_bev_collapse(st: SparseTensor, out_cap: int) -> SparseTensor:
    """Collapse z: the distinct (x, y) cells of the active voxels, per sample
    in column-major order (JAX's downsample_coords(..., z_only=True) on the
    depth-1 grid), capped at `out_cap`; each cell's features the fp32 sum of
    its voxels', cast back to the input's dtype."""
    g = st.grid
    bev_grid = SparseGrid(g.nx, g.ny, 1)
    flat = st.coords * torch.tensor([1, 1, 0], dtype=st.coords.dtype, device=st.coords.device)
    coords, valid, slot, _ = downsample_coords(bev_grid, flat, st.valid, out_cap, z_only=True)
    summed = _sum_into(st.features, slot, st.valid, out_cap)
    return SparseTensor(summed.to(st.features.dtype), coords, valid, bev_grid)


def _linear_init_(linear: nn.Linear, bias: float):
    """flax Dense's lecun_normal kernel (truncated at two standard deviations)
    and a constant bias."""
    std = (1.0 / linear.in_features) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, 0.0, std, -2 * std, 2 * std)
    nn.init.constant_(linear.bias, bias)


class VoxelNeXtSeparateHead(nn.Module):
    """One class group's head (voxelnext_head.py:13-47): per branch, in
    sorted branch order, (num_conv - 1) × SparseConvBlock((k, k, 1)) at the
    input width, then a biased Linear applied in fp32 to the fp32 features,
    also under autocast (the flax Dense with param_dtype float32 on
    `.astype(float32)` features). The hm bias starts at -2.19."""

    def __init__(self, in_channels: int, num_hm_out: int, head_dict, num_hm_conv: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        branches = {k: dict(v) for k, v in dict(head_dict).items()}
        branches["hm"] = {"out_channels": num_hm_out, "num_conv": num_hm_conv}
        k = int(kernel_size)
        self.specs = tuple((name, int(branches[name]["num_conv"]))
                           for name in sorted(branches))
        for name, num_conv in self.specs:
            for i in range(num_conv - 1):
                self.add_module(f"{name}_conv{i}",
                                SparseConvBlock(in_channels, in_channels, (k, k, 1)))
            out = nn.Linear(in_channels, int(branches[name]["out_channels"]))
            _linear_init_(out, -2.19 if name == "hm" else 0.0)
            self.add_module(f"{name}_out", out)

    def forward(self, bev: SparseTensor, nbr) -> Dict[str, torch.Tensor]:
        outs = {}
        for name, num_conv in self.specs:
            st = bev
            for i in range(num_conv - 1):
                st = getattr(self, f"{name}_conv{i}")(st, nbr)
            with torch.autocast(st.features.device.type, enabled=False):
                outs[name] = getattr(self, f"{name}_out")(st.features.float())
        return outs


def plan_down(conv: SparseConv3dDown, st: SparseTensor, transpose: bool):
    """The output set and table of a strided conv on `st` (and, for
    training, its transpose table)."""
    lookup = build_lookup(st.grid, st.coords, st.valid)
    level = conv.plan(st.grid, st.coords, st.valid, lookup)
    if transpose:
        out_lookup = build_lookup(level.grid, level.coords, level.valid)
        level = level._replace(down_tnbr=conv.transpose_table(st.coords, st.valid, level,
                                                              out_lookup))
    return level


class VoxelNeXt(nn.Module):
    """The VoxelNeXt detector on BACKBONE_3D VoxelResBackBone8xVoxelNeXt
    (cbgs_voxel0075_voxelnext[_doubleflip].yaml, voxelnext_ioubranch_large
    and voxelnext2d_ioubranch, cbgs_voxel01_voxelnext), or on the compact
    trunk where BACKBONE_3D names another (VoxelBackBone8x, as the JAX
    package builds whatever it names there). `forward` is the train loss,
    `predict` the decode (with DENSE_HEAD.DOUBLE_FLIP, the double-flip
    test-time augmentation)."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 16000):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.class_names = list(class_names)
        self.grid = grid
        bb3d = cfg.get("BACKBONE_3D", {})
        dh = cfg.DENSE_HEAD
        if cfg.VFE.NAME != "MeanVFE":
            raise NotImplementedError(f"VFE {cfg.VFE.NAME} with VoxelNeXt is not ported")
        self.vfe = MeanVFE(grid, max_voxels)
        self.ref_backbone = bb3d.get("NAME", "VoxelBackBone8x") in NEXT_BACKBONES
        if self.ref_backbone:
            self.backbone_3d = VoxelResBackBone8xVoxelNeXt(
                SparseGrid(*grid.grid_size), max_voxels, num_point_features,
                channels=tuple(bb3d.get("CHANNELS", (16, 32, 64, 128, 128))),
                kernel_sizes=tuple(bb3d.get("SPCONV_KERNEL_SIZES", (3, 3, 3, 3))))
            out_ch = int(bb3d.get("OUT_CHANNEL", bb3d.get("OUT_CHANNELS", 128)))
            shared = int(dh.get("SHARED_CONV_CHANNEL", out_ch))
            self.conv_out = SparseConvBlock(self.backbone_3d.out_channels, out_ch, (3, 3, 1))
            self.shared_conv = SparseConvBlock(out_ch, shared, (3, 3, 1))
        else:
            from .detectors import backbone_8x

            ch = int(bb3d.get("OUT_CHANNELS", 128))
            self.backbone_3d = backbone_8x(bb3d, "VoxelBackBone8x")(
                SparseGrid(*grid.grid_size), max_voxels, num_point_features,
                channels=tuple(bb3d.get("CHANNELS", (16, 16, 32, 64, 64))), out_channels=ch)
            self.down16 = SparseConv3dDown(ch, ch, max(max_voxels // 16, 16))
            self.down32 = SparseConv3dDown(ch, ch, max(max_voxels // 32, 16))
            self.num_shared_blocks = int(dh.get("NUM_SHARED_BLOCKS", 2))
            shared = int(dh.get("SHARED_CONV_CHANNEL", 128))
            cin = ch
            for i in range(self.num_shared_blocks):
                self.add_module(f"bev_block{i}", SparseConvBlock(cin, shared, (3, 3, 1)))
                cin = shared
            shared = cin

        # class groups: one head each; per-class regressions come from the
        # class's own group branch
        names = self.class_names
        n2i = {n: i for i, n in enumerate(names)}
        groups_cfg = dh.get("CLASS_NAMES_EACH_HEAD", None) or [names]
        self.class_groups = tuple(tuple(n2i[n] for n in g if n in n2i) for g in groups_cfg)
        c2g = np.zeros(len(names), np.int64)
        for gi, g in enumerate(self.class_groups):
            c2g[list(g)] = gi
        self.register_buffer("class_to_group", torch.from_numpy(c2g), persistent=False)

        shc = dh.get("SEPARATE_HEAD_CFG", {})
        self.use_vel = "vel" in list(shc.get("HEAD_ORDER", []))
        hd = {k: dict(v) for k, v in dict(shc.get("HEAD_DICT", {})).items()}
        legacy_heads = not hd   # pointwise pred-only branches
        if legacy_heads:
            hd = {name: {"out_channels": oc, "num_conv": 1}
                  for name, oc in (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2))
                  + ((("vel", 2),) if self.use_vel else ())}
        self.use_iou_branch = bool(dh.get("IOU_BRANCH", False)) or "iou" in hd
        if self.use_iou_branch and "iou" not in hd:
            hd["iou"] = {"out_channels": 1, "num_conv": 1}
        self.reg_dim = 8 + (2 if self.use_vel else 0)
        self.kernel_size_head = int(dh.get("KERNEL_SIZE_HEAD", 3))
        for gi, g in enumerate(self.class_groups):
            self.add_module(f"head_{gi}", VoxelNeXtSeparateHead(
                shared, len(g), hd,
                num_hm_conv=int(dh.get("NUM_HM_CONV", 1 if legacy_heads else 2)),
                kernel_size=self.kernel_size_head))
        rect = dh.get("IOU_RECTIFIER", dh.get("RECTIFIER", 0.68))
        rect = ([float(r) for r in rect] if isinstance(rect, (list, tuple))
                else [float(rect)] * len(names))
        self.register_buffer("iou_rectifier", torch.tensor(rect, dtype=torch.float32),
                             persistent=False)
        self.bev_cap = int(cfg.get("BEV_CAP", max_voxels // 4))

    # ------------------------------------------------------------------
    # Features
    # ------------------------------------------------------------------

    def bev_tables(self, bev: SparseTensor):
        """The BEV set's submanifold tables: (3, 3, 1) for conv_out and
        shared_conv (or the compact path's BEV blocks), and the head's
        (k, k, 1) (the same table at k = 3)."""
        lookup = build_lookup(bev.grid, bev.coords, bev.valid)
        t331 = find_neighbors(bev.grid, bev.coords, bev.valid, *lookup, kernel_offsets(3, 3, 1))
        k = self.kernel_size_head
        head = t331 if k == 3 else find_neighbors(bev.grid, bev.coords, bev.valid, *lookup,
                                                  kernel_offsets(k, k, 1))
        return t331, head

    def features_pts(self, points, points_valid):
        """(bev SparseTensor, hm (B, V, num_class) fp32, reg (B, V, G, D) fp32)
        with D = 8 (+2 vel) (+1 iou)."""
        feats, vox = self.vfe(points, points_valid)
        levels = self.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                       transpose=self.training)
        if self.ref_backbone:
            return self.bev_features(*self.backbone_3d(feats, levels))
        return self.compact_features(self.backbone_3d(feats, levels))

    def compact_features(self, st8: SparseTensor):
        """The compact path after its VoxelBackBone8x: the stride-8 tensor
        through down16 and down32 (strided convs, no BN), then
        `bev_features`."""
        st16 = self.down16(st8, plan_down(self.down16, st8, self.training))
        st32 = self.down32(st16, plan_down(self.down32, st16, self.training))
        return self.bev_features(st8, st16, st32)

    def bev_features(self, st8: SparseTensor, st16: SparseTensor, st32: SparseTensor):
        """The stride-8, 16 and 32 sets merged on the stride-8 grid and
        z-collapsed, the BEV convs (conv_out and shared_conv, or the compact
        path's bev_block{i}), then each class group's head: (bev, hm, reg)
        as `features_pts` returns them."""
        # coarser voxels back onto the stride-8 grid, the sets concatenated
        dev = st8.coords.device
        merged = SparseTensor(
            torch.cat([st8.features, st16.features, st32.features], dim=1),
            torch.cat([st8.coords,
                       st16.coords * torch.tensor([2, 2, 1], dtype=torch.int32, device=dev),
                       st32.coords * torch.tensor([4, 4, 1], dtype=torch.int32, device=dev)],
                      dim=1),
            torch.cat([st8.valid, st16.valid, st32.valid], dim=1), st8.grid)
        bev = sparse_bev_collapse(merged, self.bev_cap)
        t331, t_head = self.bev_tables(bev)
        if self.ref_backbone:
            bev = self.shared_conv(self.conv_out(bev, t331), t331)
        else:
            for i in range(self.num_shared_blocks):
                bev = getattr(self, f"bev_block{i}")(bev, t331)

        num_cls = len(self.class_names)
        hm = bev.features.new_zeros(bev.valid.shape + (num_cls,), dtype=torch.float32)
        regs = []
        for gi, grp in enumerate(self.class_groups):
            outs = getattr(self, f"head_{gi}")(bev, t_head)
            hm[..., list(grp)] = outs["hm"]
            parts = [outs["center"], outs["center_z"], outs["dim"], outs["rot"]]
            if self.use_vel:
                parts.append(outs["vel"])
            if self.use_iou_branch:
                parts.append(outs["iou"])
            regs.append(torch.cat(parts, dim=-1))
        return bev, hm, torch.stack(regs, dim=2)

    def features(self, batch):
        return self.features_pts(batch.points, batch.points_valid)

    @staticmethod
    def gather_group_reg(reg, vox, grp):
        """reg (B, V, G, D), vox (B, K) voxel slots, grp (B, K) group ids →
        (B, K, D): each selection reads its class's own group branch."""
        b, v, g, d = reg.shape
        r = torch.gather(reg.reshape(b, v, g * d), 1, vox[..., None].expand(-1, -1, g * d))
        r = r.view(b, -1, g, d)
        return torch.gather(r, 2, grp[..., None, None].expand(-1, -1, 1, d))[:, :, 0]

    def voxel_xy(self, bev: SparseTensor):
        """BEV voxel centres in world coordinates (stride-8 cells)."""
        pcr, vs = self.grid.point_cloud_range, self.grid.voxel_size
        x = (bev.coords[..., 0].float() + 0.5) * float(vs[0]) * 8.0 + float(pcr[0])
        y = (bev.coords[..., 1].float() + 0.5) * float(vs[1]) * 8.0 + float(pcr[1])
        return x, y

    # ------------------------------------------------------------------
    # Targets and loss (train)
    # ------------------------------------------------------------------

    def assign_targets(self, bev: SparseTensor, gt_boxes, gt_valid):
        """Each live gt claims its nearest active BEV voxel (argmin, first
        index on ties; within 32 stride-8 cells), a distance gaussian over
        the voxels per class (max over the gts), the exact peak 1 at each
        claimed voxel. Returns (hm_t (B, V, C), nearest (B, M), reg_t
        (B, M, 8|10), claimed (B, M))."""
        gt_boxes = gt_boxes.float()
        vx, vy = self.voxel_xy(bev)
        gx, gy = gt_boxes[..., 0], gt_boxes[..., 1]
        cls_id = gt_boxes[..., -1].to(torch.int64)
        live = gt_valid & (cls_id > 0) & (gt_boxes[..., 3] > 0)
        d2 = (vx[:, :, None] - gx[:, None, :]) ** 2 + (vy[:, :, None] - gy[:, None, :]) ** 2
        d2 = torch.where(live[:, None, :] & bev.valid[..., None], d2, 1e12)   # (B, V, M)
        min_d2 = d2.amin(dim=1)
        nearest = torch.argmin(d2, dim=1)   # the first minimal index, as jnp.argmin
        claimed = live & (min_d2 < (8.0 * 4) ** 2)

        stride_m = 8.0 * float(self.grid.voxel_size[0])
        radius = torch.clamp(torch.minimum(gt_boxes[..., 3], gt_boxes[..., 4]) / (2 * stride_m),
                             min=2.0)
        sigma = (2 * radius + 1) / 6.0
        g = torch.exp(-d2 / (2 * (sigma[:, None, :] * stride_m) ** 2))
        g = torch.where(claimed[:, None, :], g, 0.0)
        num_cls = len(self.class_names)
        hm_t = torch.stack([torch.where((claimed & (cls_id == c + 1))[:, None, :], g, 0.0)
                            .amax(dim=2) for c in range(num_cls)], dim=-1)
        b, v = bev.valid.shape
        cell = nearest * num_cls + torch.clamp(cls_id - 1, 0, num_cls - 1)
        hm_t = hm_t.reshape(b, v * num_cls).scatter_reduce(
            1, cell, claimed.float(), "amax").view(b, v, num_cls)

        vxg = torch.gather(vx, 1, nearest)
        vyg = torch.gather(vy, 1, nearest)
        reg_t = torch.stack([
            gx - vxg, gy - vyg, gt_boxes[..., 2],
            torch.log(torch.clamp(gt_boxes[..., 3], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[..., 4], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[..., 5], min=1e-6)),
            torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], dim=-1)
        if self.use_vel:
            if gt_boxes.shape[-1] < 10:
                raise ValueError("a 'vel' VoxelNeXt head needs velocity-width (10-column) gt")
            reg_t = torch.cat([reg_t, gt_boxes[..., 7:9]], dim=-1)
        return hm_t, nearest, reg_t, claimed

    def decode_boxes_at(self, bev, inds, rp):
        """Boxes (B, M, 7) decoded from raw regressions rp at voxel slots inds
        (dims still log)."""
        vx, vy = self.voxel_xy(bev)
        return torch.stack([
            torch.gather(vx, 1, inds) + rp[..., 0], torch.gather(vy, 1, inds) + rp[..., 1],
            rp[..., 2], torch.exp(rp[..., 3]), torch.exp(rp[..., 4]), torch.exp(rp[..., 5]),
            torch.atan2(rp[..., 7], rp[..., 6])], dim=-1)

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {hm_loss[, iou_loss], rpn_loss}). The train step's
        `sampler` and `dropout` generators are not used."""
        bev, hm, reg = self.features(batch)
        hm_t, inds, reg_t, mask = self.assign_targets(bev, batch.gt_boxes, batch.gt_valid)
        cls_id = batch.gt_boxes[..., -1].to(torch.int64)
        grp = self.class_to_group[torch.clamp(cls_id - 1, 0, len(self.class_names) - 1)]
        rp = self.gather_group_reg(reg, inds, grp)   # (B, M, D)
        ident = torch.arange(rp.shape[1], device=rp.device).expand(rp.shape[:2])
        hm_prob = torch.where(bev.valid[..., None], losses.sigmoid_clamped(hm), 1e-4)
        hm_loss = losses.focal_loss_centernet(hm_prob, hm_t)
        reg_loss = losses.reg_loss_centernet(rp[..., :self.reg_dim], reg_t, ident, mask)
        lw = self.model_cfg.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
        code_w = torch.tensor(list(lw.get("code_weights", [1.0] * self.reg_dim)),
                              dtype=torch.float32, device=rp.device)[:self.reg_dim]
        total = hm_loss * lw.get("cls_weight", 1.0) + \
            (reg_loss * code_w).sum() * lw.get("loc_weight", 0.25)
        tb = {"hm_loss": hm_loss}
        if self.use_iou_branch:
            # L1 between tanh(iou) at each claimed voxel and the actual 3D IoU
            # of the decoded box with its gt (no gradient through the boxes)
            boxes_p = self.decode_boxes_at(bev, inds, rp).detach()
            b, m = boxes_p.shape[:2]
            actual = aligned_iou3d(boxes_p.reshape(b * m, 7),
                                   batch.gt_boxes[..., :7].float().reshape(b * m, 7)).view(b, m)
            w = mask.float()
            w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
            iou_loss = (torch.abs(torch.tanh(rp[..., self.reg_dim]) - actual) * w).sum() / b
            total = total + iou_loss
            tb["iou_loss"] = iou_loss
        tb["rpn_loss"] = total
        return total, tb

    # ------------------------------------------------------------------
    # Decode (eval)
    # ------------------------------------------------------------------

    def tta_double_flip(self, batch):
        """The double-flip test-time augmentation: the original, y-, x- and
        xy-flipped point sets through the network as one batch of 4B, then
        `merge_double_flip`. Returns (merged bev, scores (B, 2·BEV_CAP, C),
        reg (B, 2·BEV_CAP, G, D))."""
        pts, pv = batch.points, batch.points_valid
        c_in = pts.shape[-1]
        sx = torch.ones(c_in, dtype=pts.dtype, device=pts.device)
        sy = sx.clone()
        sx[0] = -1.0
        sy[1] = -1.0
        pts4 = torch.cat([pts, pts * sy, pts * sx, pts * sx * sy], dim=0)
        return self.merge_double_flip(*self.features_pts(pts4, pv.repeat(4, 1)))

    def merge_double_flip(self, bev, hm, reg):
        """The four copies' predictions (the batch's original, y-, x- and
        xy-flipped copies, one after the other) merged: each copy's cells
        un-flipped with the involutive n - 1 - i (the JAX package's
        documented deviation from the reference's n - i) and its offsets,
        headings and velocities mirrored back; the activated predictions
        (sigmoid scores, exp dims) averaged over equal cells (a stable sort
        on the linear cell key, a segment mean into 2 · BEV_CAP slots)."""
        b = bev.valid.shape[0] // 4
        dev = bev.coords.device
        nx8, ny8 = bev.grid.nx, bev.grid.ny
        v = bev.valid.shape[-1]
        g, d = reg.shape[-2], reg.shape[-1]
        coords = bev.coords.view(4, b, v, 3)
        valid = bev.valid.view(4, b, v)
        prob = torch.sigmoid(hm).view(4, b, v, -1)
        reg = reg.view(4, b, v, g, d)
        reg = torch.cat([reg[..., :3], torch.exp(reg[..., 3:6]), reg[..., 6:]], dim=-1)
        flip_y = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
        flip_x = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
        cx = torch.where(flip_x[:, None, None] < 0, nx8 - 1 - coords[..., 0], coords[..., 0])
        cy = torch.where(flip_y[:, None, None] < 0, ny8 - 1 - coords[..., 1], coords[..., 1])
        coords = torch.stack([cx, cy, coords[..., 2]], dim=-1)
        ones = torch.ones(4, device=dev)
        scale = [flip_x, flip_y, ones, ones, ones, ones, flip_x, flip_y]
        if self.use_vel:
            scale += [flip_x, flip_y]
        scale += [ones] * (d - len(scale))   # the iou channel is flip-invariant
        reg = reg * torch.stack(scale, dim=-1)[:, None, None, None, :]

        cap = 2 * self.bev_cap
        num_cls = len(self.class_names)
        feats = torch.cat([prob, reg.reshape(4, b, v, g * d)], dim=-1)
        coords_m = coords.transpose(0, 1).reshape(b, 4 * v, 3)
        valid_m = valid.transpose(0, 1).reshape(b, 4 * v)
        feats_m = feats.transpose(0, 1).reshape(b, 4 * v, -1)

        sentinel = bev.grid.num_cells
        key = linearize(bev.grid, coords_m, valid_m)                  # (B, 4V)
        order = torch.argsort(key, dim=1, stable=True)
        skey = torch.gather(key, 1, order)
        is_start = torch.ones_like(skey, dtype=torch.bool)
        is_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
        is_start &= skey < sentinel
        seg = torch.cumsum(is_start.long(), dim=1) - 1
        seg = torch.where((skey < sentinel) & (seg < cap), seg, cap)
        f_s = torch.gather(feats_m, 1, order[..., None].expand(-1, -1, feats_m.shape[-1]))
        c_s = torch.gather(coords_m, 1, order[..., None].expand(-1, -1, 3))
        live = seg < cap
        sums = _sum_into(f_s, seg, live, cap)
        counts = _sum_into(live[..., None].float(), seg, live, cap)
        avg = sums / torch.clamp(counts, min=1.0)
        base = torch.arange(b, device=dev)[:, None] * (cap + 1)
        rows = torch.where(is_start & live, seg, cap) + base
        out_coords = coords_m.new_zeros((b * (cap + 1), 3))
        out_coords[rows.reshape(-1)] = c_s.reshape(-1, 3)
        out_coords = out_coords.view(b, cap + 1, 3)[:, :cap]
        out_valid = torch.arange(cap, device=dev) < torch.clamp(is_start.sum(dim=1), max=cap)[:, None]
        merged = SparseTensor(avg, out_coords, out_valid, bev.grid)
        return merged, avg[..., :num_cls], avg[..., num_cls:].reshape(b, cap, g, d)

    def predict(self, batch):
        """Eval: top-K over the flattened (class, voxel) scores (jax.lax.top_k's
        order among ties), each selection decoded from its class's own group
        branch, IoU-rectified scores where the head has an IoU branch, then
        rotated NMS per frame (all frames in one `nms_bev`). Returns (boxes
        (B, S, 7|9), scores (B, S), labels (B, S) 1-based, valid (B, S)),
        S = NMS_POST_MAXSIZE."""
        if self.model_cfg.DENSE_HEAD.get("DOUBLE_FLIP", False):
            bev, scores_all, reg = self.tta_double_flip(batch)
        else:
            bev, hm, reg = self.features(batch)
            scores_all = torch.sigmoid(hm)
            reg = torch.cat([reg[..., :3], torch.exp(reg[..., 3:6]), reg[..., 6:]], dim=-1)
        return self.decode(bev, torch.where(bev.valid[..., None], scores_all, 0.0), reg)

    def decode(self, bev, scores_all, reg):
        """The top-K decode and NMS of `predict` on the BEV set's activated
        scores (B, V, C) and regressions (B, V, G, D), dims exp'd."""
        pp = self.model_cfg.DENSE_HEAD.POST_PROCESSING
        vx, vy = self.voxel_xy(bev)
        b, v, c = scores_all.shape
        k = min(int(pp.MAX_OBJ_PER_SAMPLE), v)
        scores, idx = top_k(scores_all.transpose(1, 2).reshape(b, c * v), k)
        cls = idx // v + 1
        vox = idx % v
        r = self.gather_group_reg(reg, vox, self.class_to_group[cls - 1])
        boxes = torch.stack([torch.gather(vx, 1, vox) + r[..., 0],
                             torch.gather(vy, 1, vox) + r[..., 1], r[..., 2],
                             r[..., 3], r[..., 4], r[..., 5],   # dims already exp'd
                             torch.atan2(r[..., 7], r[..., 6])], dim=-1)
        if self.use_vel:
            boxes = torch.cat([boxes, r[..., 8:10]], dim=-1)
        if self.use_iou_branch and pp.get("USE_IOU_TO_RECTIFY_SCORE", True):
            iou = torch.clamp(torch.tanh(r[..., self.reg_dim]), 0.0, 1.0)
            w = self.iou_rectifier[cls - 1]
            scores = torch.pow(torch.clamp(scores, min=1e-8), 1.0 - w) * \
                torch.pow(torch.clamp(iou, min=1e-4), w)
        valid = scores > float(pp.get("SCORE_THRESH", 0.1))
        nms_cfg = pp.NMS_CONFIG
        sel, keep = nms_bev(boxes[..., :7], scores, float(nms_cfg.NMS_THRESH),
                            pre_max=min(int(nms_cfg.NMS_PRE_MAXSIZE), k),
                            post_max=int(nms_cfg.NMS_POST_MAXSIZE), valid=valid)
        sel_boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1]))
        return (sel_boxes, torch.where(keep, torch.gather(scores, 1, sel), 0.0),
                torch.where(keep, torch.gather(cls, 1, sel), 0), keep)

    def reference_mapping(self):
        """The JAX package has no reference-checkpoint mapping for VoxelNeXt,
        so the port has none either: every key stays unmapped."""
        return {}
