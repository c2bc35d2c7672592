"""PillarNet (port of dfu3d_tpu/models/pillarnet.py, reference pcdet
detectors/pillarnet.py):

    DynPillarVFESimple2D (or MeanVFE) → the sparse pillar pyramid to stride 8
    (VoxelBackBone8x, or VoxelResBackBone8x when BACKBONE_3D.NAME has "Res",
    on the depth-1 pillar grid: the 3 × 3 × 3 submanifold convs become 3 × 3
    ones, 18 of their 27 taps never live) → height_compression → the dense
    stride-16 stage conv5_down, conv5_a, conv5_b → BaseBEVBackboneV1 →
    AnchorHeadSingle (kitti_models/pillarnet.yaml, `PillarNetAnchor`) or
    CenterHead (waymo_models/pillarnet.yaml, `PillarNetCenter`)

`PillarNet` dispatches on DENSE_HEAD.NAME, as the JAX factory does. Every
sparse conv is one launch of kernel B2; NMS and recall are B1. Module names
follow the flax tree (vfe.pfn_0, backbone_3d, conv5_down, backbone_2d,
dense_head).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.voxel import VoxelGrid, dynamic_voxelize
from ..core.voxel.sparse_ops import SparseGrid
from ..train import torch_convert
from .backbone_2d import BaseBEVBackboneV1, ConvBNReLU
from .detectors import CenterPoint, center_head
from .pointpillar import AnchorDetectorBase
from .sparse_backbone import VoxelBackBone8x, VoxelResBackBone8x, height_compression
from .vfe import MeanVFE, PFNLayer

PILLAR_VFES = ("DynamicPillarVFESimple2D", "DynPillarVFESimple2D", "MeanVFE")


class DynPillarVFESimple2D(nn.Module):
    """DynamicPillarVFESimple2D (dynamic_pillar_vfe.py:145-240): per point
    [f_center (3), the point's channels (or those after xyz) (, its range)]
    through the PFNLayer stack over batch-global pillar ids, so that BN sees
    every point of the batch, then the max over each pillar's points.
    Returns sparse pillars ((B, V, C) features, Voxelized) in the
    voxelizer's slot order."""

    def __init__(self, num_filters: Sequence[int], grid: VoxelGrid, num_point_features: int = 4,
                 use_norm: bool = True, use_absolute_xyz: bool = True,
                 with_distance: bool = False, max_pillars: int = 32768):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.grid = grid
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        self.max_pillars = max_pillars
        cin = 3 + (num_point_features if use_absolute_xyz else num_point_features - 3)
        cin += int(with_distance)
        for i, nf in enumerate(self.num_filters):
            self.add_module(f"pfn_{i}", PFNLayer(cin, nf, use_norm,
                                                 i >= len(self.num_filters) - 1))
            cin = nf

    def forward(self, points, points_valid):
        b, n, c = points.shape
        v = self.max_pillars
        dev = points.device
        vox = dynamic_voxelize(self.grid, points, points_valid, v)
        pcr = torch.tensor(self.grid.point_cloud_range, dtype=torch.float32, device=dev)
        vs = torch.tensor(self.grid.voxel_size, dtype=torch.float32, device=dev)
        xyz = points[..., :3].float()
        cf = torch.floor((xyz[..., :2] - pcr[:2]) / vs[:2])
        f_center = torch.stack([
            xyz[..., 0] - (cf[..., 0] * vs[0] + vs[0] / 2 + pcr[0]),
            xyz[..., 1] - (cf[..., 1] * vs[1] + vs[1] / 2 + pcr[1]),
            xyz[..., 2] - (vs[2] / 2 + pcr[2])], dim=-1)
        feats = [f_center, points.float() if self.use_absolute_xyz else points[..., 3:].float()]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        ok = points_valid & (vox.point_to_voxel < v)
        x = torch.where(ok[..., None], torch.cat(feats, dim=-1), 0.0)
        # batch-global pillar ids, the points sorted by them (the PFN's
        # segment ops take ascending ids with the sentinel last)
        base = torch.arange(b, device=dev)[:, None] * v
        seg = torch.where(ok, vox.point_to_voxel + base, b * v).reshape(b * n)
        order = torch.argsort(seg, stable=True)
        flat, ok_flat, seg = x.reshape(b * n, -1)[order], ok.reshape(b * n)[order], seg[order]
        x_max = None
        for i in range(len(self.num_filters)):
            flat, x_max = getattr(self, f"pfn_{i}")(flat, ok_flat, seg, b * v)
        return x_max.view(b, v, -1), vox


class _PillarNetTrunk:
    """What both PillarNet detectors share: the VFE, the sparse pyramid, the
    dense conv5 stage and the V1 neck (`_setup_pillarnet`), and
    `spatial_features(batch)` → the neck's (B, H/8, W/8, C) map."""

    def _setup_pillarnet(self, cfg, grid: VoxelGrid, num_point_features: int, max_voxels: int):
        vfe_cfg = cfg.VFE
        if vfe_cfg.NAME not in PILLAR_VFES:
            raise NotImplementedError(f"VFE {vfe_cfg.NAME} with PillarNet is not ported")
        nx, ny, nz = grid.grid_size
        if nz != 1:
            raise ValueError(f"PillarNet needs a pillar grid (nz == 1), got {nz}")
        if vfe_cfg.NAME == "MeanVFE":
            self.vfe = MeanVFE(grid, max_voxels)
            vfe_out = num_point_features
        else:
            self.vfe = DynPillarVFESimple2D(
                num_filters=tuple(vfe_cfg.get("NUM_FILTERS", (32,))), grid=grid,
                num_point_features=num_point_features, use_norm=vfe_cfg.get("USE_NORM", True),
                use_absolute_xyz=vfe_cfg.get("USE_ABSLOTE_XYZ", True),
                with_distance=vfe_cfg.get("WITH_DISTANCE", False), max_pillars=max_voxels)
            vfe_out = self.vfe.num_filters[-1]
        bb3d = cfg.get("BACKBONE_3D", {})
        # PillarRes18BackBone8x: residual blocks; PillarBackBone8x: plain ones
        bb_cls = VoxelResBackBone8x if "Res" in bb3d.get("NAME", "") else VoxelBackBone8x
        out_channels = int(bb3d.get("OUT_CHANNELS", 256))
        self.backbone_3d = bb_cls(SparseGrid(nx, ny, nz), voxel_cap=max_voxels,
                                  in_channels=vfe_out,
                                  channels=tuple(bb3d.get("CHANNELS", (32, 32, 64, 128, 256))),
                                  out_channels=out_channels)
        c4 = self.backbone_3d.out_grid.nz * out_channels
        c5 = int(bb3d.get("CONV5_CHANNELS", 256))
        self.conv5_down = ConvBNReLU(c4, c5, stride=2)
        self.conv5_a = ConvBNReLU(c5, c5)
        self.conv5_b = ConvBNReLU(c5, c5)
        bb = cfg.BACKBONE_2D
        if bb.NAME != "BaseBEVBackboneV1":
            raise NotImplementedError(f"BACKBONE_2D {bb.NAME} with PillarNet is not ported")
        self.backbone_2d = BaseBEVBackboneV1(
            (c4, c5), layer_nums=tuple(bb.LAYER_NUMS), num_filters=tuple(bb.NUM_FILTERS),
            upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
            num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS))

    def spatial_features(self, batch):
        feats, vox = self.vfe(batch.points, batch.points_valid)
        # the strided convs' transpose tables serve the backward only
        levels = self.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                       transpose=self.training)
        st = self.backbone_3d(feats, levels)
        x4 = height_compression(st).to(st.features.dtype)      # stride 8, (B, H, W, C)
        x5 = self.conv5_b(self.conv5_a(self.conv5_down(x4.permute(0, 3, 1, 2))))
        return self.backbone_2d([x4, x5.permute(0, 2, 3, 1)])  # stride 16 in, stride 8 out

    def trunk_mapping(self):
        """The reference keys the JAX package maps for this trunk: the pillar
        VFE's PFN layers and BaseBEVBackboneV1; the sparse pyramid and the
        conv5 stage stay unmapped."""
        m = {}
        if isinstance(self.vfe, DynPillarVFESimple2D):
            m.update(torch_convert.pfn_mapping(len(self.vfe.num_filters)))
        m.update(torch_convert.bev_v1_backbone_mapping(self.backbone_2d.layer_nums))
        return m


class PillarNetAnchor(_PillarNetTrunk, AnchorDetectorBase):
    """PillarNet with AnchorHeadSingle (kitti_models/pillarnet.yaml)."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 32768):
        AnchorDetectorBase.__init__(self, model_cfg, class_names, grid)
        self._setup_pillarnet(model_cfg, grid, num_point_features, max_voxels)
        self._setup_anchor_head(self.backbone_2d.out_channels)

    def features(self, batch):
        return self.dense_head(self.spatial_features(batch))

    def reference_mapping(self):
        return {**self.trunk_mapping(), **self.anchor_head_mapping()}


class PillarNetCenter(_PillarNetTrunk, CenterPoint):
    """PillarNet with CenterHead (waymo_models/pillarnet.yaml); the loss and
    the decode are CenterPoint's."""

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_voxels: int = 60000):
        nn.Module.__init__(self)
        self.model_cfg = model_cfg
        self._setup_pillarnet(model_cfg, grid, num_point_features, max_voxels)
        self.dense_head = center_head(model_cfg.DENSE_HEAD, class_names, grid,
                                      self.backbone_2d.out_channels)

    def features(self, batch):
        return self.dense_head(self.spatial_features(batch))

    def reference_mapping(self):
        return {**self.trunk_mapping(),
                **self.dense_head.reference_mapping()}


def PillarNet(model_cfg, class_names, grid: VoxelGrid, **overrides):
    """The PillarNet detector of DENSE_HEAD.NAME: CenterHead (the default) or
    an anchor head."""
    head = model_cfg.DENSE_HEAD.get("NAME", "CenterHead")
    cls = PillarNetCenter if head == "CenterHead" else PillarNetAnchor
    return cls(model_cfg, class_names, grid, **overrides)
