"""CenterPoint assembly (port of dfu3d_tpu/models/detectors.py, the pillar
and voxel branches):

    pillar: DynPillarVFE → BEV backbone → CenterHead
    voxel:  MeanVFE → VoxelResBackBone8x or VoxelBackBone8x →
            height_compression → BEV backbone → CenterHead
    DSVT:   DynVoxelVFE → DSVTBackbone or DSVTVoxelBackbone → BEV scatter →
            BEV backbone → CenterHead (models/dsvt.py)

The BEV backbone is BaseBEVBackbone or BaseBEVResBackbone (BACKBONE_2D.NAME,
as JAX's detectors.py:177-179).

then decode + NMS (`predict`, eval) or targets + loss (`forward`, train).
`build_network` also builds PointRCNN (models/pointrcnn.py), PointPillar
and SECONDNet (models/pointpillar.py), SECONDNetIoU (models/second_iou.py),
VoxelRCNN (models/voxelrcnn.py), PVRCNN and PVRCNNPlusPlus
(models/pvrcnn.py), PartA2Net (models/parta2.py), VoxelNeXt
(models/voxelnext.py), PillarNet (models/pillarnet.py), TransFusion
(models/transfusion.py), MPPNet and MPPNetE2E (models/mppnet.py), and the
camera detectors BevFusion (models/bevfusion.py) and CaDDN (models/caddn.py).
Submodule names follow the flax module tree (vfe, backbone_3d, backbone_2d,
dense_head)."""
from __future__ import annotations

from torch import nn

from ..core.voxel import VoxelGrid
from ..core.voxel.sparse_ops import SparseGrid
from ..device import resolve_device
from ..train import torch_convert
from . import dsvt
from .backbone_2d import BEV_BACKBONES
from .center_head import CenterHead
from .column_sparse import ColumnVoxelBackBone8x
from .pointrcnn import PointRCNN
from .sparse_backbone import VoxelBackBone8x, VoxelResBackBone8x, height_compression
from .vfe import DynPillarVFE, MeanVFE


DEFAULT_CHANNELS = {"VoxelResBackBone8x": (16, 32, 64, 128),
                    "VoxelBackBone8x": (16, 16, 32, 64, 64)}


def backbone_8x(bb3d_cfg, name=None):
    """The sparse backbone class of BACKBONE_3D (or of `name`, where the
    caller builds one whatever the config names). VoxelBackBone8x has two
    formulations, as in the JAX package (column_sparse.select_backbone8x):
    BACKBONE_3D.FORMULATION gather (the default: every conv a gather-GEMM
    launch) or column (ColumnVoxelBackBone8x: dense-z columns, the same
    parameters). FORMULATION is read from the config only; the JAX package
    also falls back to the DFU3D_SPARSE_FORMULATION environment variable."""
    name = name or bb3d_cfg.NAME
    if name == "VoxelResBackBone8x":
        return VoxelResBackBone8x
    if name != "VoxelBackBone8x":
        raise NotImplementedError(f"BACKBONE_3D {name} is not ported")
    form = bb3d_cfg.get("FORMULATION") or "gather"
    if form not in ("column", "gather"):
        raise ValueError(f"FORMULATION must be 'column' or 'gather', got {form!r}")
    return ColumnVoxelBackBone8x if form == "column" else VoxelBackBone8x


def center_head(dh, class_names, grid: VoxelGrid, in_channels: int) -> CenterHead:
    """The CenterHead of a DENSE_HEAD config on a 2D map of `in_channels`."""
    if dh.NAME != "CenterHead":
        raise NotImplementedError(f"DENSE_HEAD {dh.NAME} is not ported")
    ta = dh.TARGET_ASSIGNER_CONFIG
    return CenterHead(
        in_channels=in_channels,
        class_names=tuple(class_names),
        class_names_each_head=tuple(tuple(x) for x in dh.CLASS_NAMES_EACH_HEAD),
        shared_conv_channel=dh.SHARED_CONV_CHANNEL,
        num_hm_conv=dh.NUM_HM_CONV,
        head_dict=dict(dh.SEPARATE_HEAD_CFG.HEAD_DICT),
        point_cloud_range=grid.point_cloud_range,
        voxel_size=grid.voxel_size,
        feature_map_stride=ta.FEATURE_MAP_STRIDE,
        use_bias_before_norm=dh.get("USE_BIAS_BEFORE_NORM", False),
        head_order=tuple(dh.SEPARATE_HEAD_CFG.HEAD_ORDER),
        gaussian_overlap=ta.GAUSSIAN_OVERLAP,
        min_radius=ta.MIN_RADIUS,
    )


class CenterPoint(nn.Module):
    """CenterPoint-pillar (tools/cfgs/kitti_models/centerpoint_nuscenes2kitti.yaml)
    or, with a BACKBONE_3D, voxel CenterPoint
    (tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml), or,
    with BACKBONE_3D DSVT, DSVT-Pillar / DSVT-Voxel
    (tools/cfgs/waymo_models/dsvt_pillar.yaml, dsvt_voxel.yaml)."""

    GLOBAL_BATCH = True

    def __init__(self, model_cfg, class_names, grid: VoxelGrid, num_point_features: int = 4,
                 max_pillars: int = 32768, max_voxels: int = 60000):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        vfe_cfg = cfg.VFE
        # a null BACKBONE_3D NAME counts as absent, as in the JAX package
        self.use_voxel_backbone = bool(cfg.get("BACKBONE_3D") and cfg.BACKBONE_3D.get("NAME"))
        self.use_dsvt = self.use_voxel_backbone and cfg.BACKBONE_3D.NAME == "DSVT"
        if self.use_dsvt:
            self.vfe, self.backbone_3d = dsvt.build_dsvt(cfg, grid, num_point_features,
                                                         max_voxels)
            bev_channels = self.backbone_3d.dim
        elif self.use_voxel_backbone:
            bb3d = cfg.BACKBONE_3D
            if vfe_cfg.NAME != "MeanVFE":
                raise NotImplementedError(f"VFE {vfe_cfg.NAME} with a 3D backbone is not ported")
            self.vfe = MeanVFE(grid, max_voxels)
            self.backbone_3d = backbone_8x(bb3d)(
                SparseGrid(*grid.grid_size), voxel_cap=max_voxels,
                in_channels=num_point_features,
                channels=tuple(bb3d.get("CHANNELS", DEFAULT_CHANNELS[bb3d.NAME])),
                out_channels=bb3d.get("OUT_CHANNELS", 128))
            # the BEV width height_compression gives, whatever MAP_TO_BEV says
            bev_channels = self.backbone_3d.out_grid.nz * bb3d.get("OUT_CHANNELS", 128)
        else:
            if vfe_cfg.NAME not in ("DynPillarVFE", "DynamicPillarVFE"):
                raise NotImplementedError(f"VFE {vfe_cfg.NAME} is not ported")
            self.vfe = DynPillarVFE(
                num_filters=tuple(vfe_cfg.NUM_FILTERS), grid=grid,
                num_point_features=num_point_features,
                use_norm=vfe_cfg.get("USE_NORM", True),
                use_absolute_xyz=vfe_cfg.get("USE_ABSLOTE_XYZ", True),
                with_distance=vfe_cfg.get("WITH_DISTANCE", False),
                max_pillars=max_pillars,
            )
            bev_channels = vfe_cfg.NUM_FILTERS[-1]
        bb = cfg.BACKBONE_2D
        if bb.NAME not in BEV_BACKBONES:
            raise NotImplementedError(f"BACKBONE_2D {bb.NAME} is not ported")
        self.backbone_2d = BEV_BACKBONES[bb.NAME](
            in_channels=bev_channels,
            layer_nums=tuple(bb.LAYER_NUMS), layer_strides=tuple(bb.LAYER_STRIDES),
            num_filters=tuple(bb.NUM_FILTERS), upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
            num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS),
        )
        self.dense_head = center_head(cfg.DENSE_HEAD, class_names, grid,
                                      self.backbone_2d.out_channels)

    def features(self, batch):
        """PointBatch → list over heads of {branch: (B, H, W, c)}."""
        if self.use_dsvt:
            bev = dsvt.dsvt_bev(self.vfe, self.backbone_3d, self.vfe.grid, batch.points,
                                batch.points_valid)
        elif self.use_voxel_backbone:
            feats, vox = self.vfe(batch.points, batch.points_valid)
            # the strided convs' transpose tables serve the backward only
            levels = self.backbone_3d.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique,
                                           transpose=self.training)
            st = self.backbone_3d(feats, levels)
            # summed in fp32, then in the dtype the sparse convs ran in
            bev = height_compression(st).to(st.features.dtype)
        else:
            bev = self.vfe(batch.points, batch.points_valid)
        return self.dense_head(self.backbone_2d(bev))

    def forward(self, batch, sampler=None, dropout=None):
        """Train: (loss, {hm_loss_head_i, loc_loss_head_i, rpn_loss}); BN
        layers use batch statistics and update their running ones when the
        module is in train mode. The train step's `sampler` and `dropout`
        generators are not used: CenterPoint draws nothing."""
        return self.get_loss(batch, self.features(batch))

    def get_loss(self, batch, pred_dicts):
        """Targets at the head's map size, then the head's loss."""
        h, w = pred_dicts[0]["hm"].shape[1:3]
        targets = self.dense_head.assign_targets(batch.gt_boxes, batch.gt_valid, (h, w))
        return self.dense_head.get_loss(pred_dicts, targets,
                                        self.model_cfg.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS)

    def predict(self, batch):
        """Eval: decoded, NMS'd boxes. Returns (boxes, scores, labels, valid)."""
        return self.dense_head.generate_predicted_boxes(
            self.features(batch), self.model_cfg.DENSE_HEAD.POST_PROCESSING)

    def reference_mapping(self):
        """The reference-key mapping of a checkpoint (train/torch_convert):
        the flagship's, the JAX package's convert_state_dict default; with
        DSVT, BaseBEVResBackbone or per-tower heads the VFE's PFN layers
        (pillar and DSVT), the DSVT trunk's, the 2D backbone's and the
        CenterHead's."""
        res = isinstance(self.backbone_2d, BEV_BACKBONES["BaseBEVResBackbone"])
        if not (self.use_dsvt or res or not self.dense_head.fused):
            return torch_convert.centerpoint_pillar_mapping()
        m = {}
        if self.use_dsvt:
            m.update(torch_convert.pfn_mapping(len(self.vfe.num_filters)))
            m.update(self.backbone_3d.reference_mapping())
        elif not self.use_voxel_backbone:
            m.update(torch_convert.pfn_mapping(len(self.vfe.num_filters)))
        bev = torch_convert.bev_res_backbone_mapping if res else torch_convert.bev_backbone_mapping
        return {**m, **bev(self.backbone_2d.layer_nums), **self.dense_head.reference_mapping()}


def build_network(model_cfg, class_names, grid: VoxelGrid, device="cuda", train: bool = False,
                  **overrides):
    """Build a detector by MODEL.NAME (CenterPoint, PointRCNN, PointPillar,
    SECONDNet, SECONDNetIoU, VoxelRCNN, PVRCNN, PVRCNNPlusPlus, PartA2Net,
    VoxelNeXt, PillarNet, TransFusion, MPPNet, MPPNetE2E, BevFusion or CaDDN)
    on `device` (the card unless the caller asks for the CPU), in eval mode,
    or in train mode with `train`. `overrides` are constructor keywords
    (num_point_features, max_pillars, max_voxels); PointRCNN reads no grid
    and takes num_point_features only, PointPillar takes max_voxels and
    leaves its pillar cap alone, CaDDN reads neither, and the voxel
    detectors take no max_pillars."""
    from .bevfusion import BevFusion
    from .caddn import CaDDN
    from .mppnet import MPPNet, MPPNetE2E
    from .parta2 import PartA2Net
    from .pillarnet import PillarNet
    from .pointpillar import PointPillar, SECONDNet
    from .pvrcnn import PVRCNN, PVRCNNPlusPlus
    from .second_iou import SECONDNetIoU
    from .transfusion import TransFusion
    from .voxelnext import VoxelNeXt
    from .voxelrcnn import VoxelRCNN

    dev = resolve_device(device)
    if model_cfg.NAME == "PointRCNN":
        return PointRCNN(model_cfg, class_names, **overrides).to(dev).train(train)
    gridded = {"PointPillar": PointPillar, "SECONDNet": SECONDNet, "SECONDNetIoU": SECONDNetIoU,
               "VoxelRCNN": VoxelRCNN, "PVRCNN": PVRCNN, "PVRCNNPlusPlus": PVRCNNPlusPlus,
               "PartA2Net": PartA2Net, "VoxelNeXt": VoxelNeXt, "PillarNet": PillarNet,
               "TransFusion": TransFusion, "MPPNet": MPPNet, "MPPNetE2E": MPPNetE2E,
               "BevFusion": BevFusion, "CaDDN": CaDDN}
    if model_cfg.NAME in gridded:
        return gridded[model_cfg.NAME](model_cfg, class_names, grid, **overrides).to(dev).train(
            train)
    if model_cfg.NAME != "CenterPoint":
        raise NotImplementedError(f"detector {model_cfg.NAME} is not ported yet")
    return CenterPoint(model_cfg, class_names, grid, **overrides).to(dev).train(train)
