"""Builders for the port's other supported models: voxel CenterPoint,
PointRCNN, the nuScenes anchor detectors (SECOND and PointPillar
multi-head), the two-stage KITTI voxel detectors (SECOND-IoU, Voxel
R-CNN, PV-RCNN, PartA2, PartA2-free, PV-RCNN++), the fully sparse and
pillar-sparse detectors (VoxelNeXt on its nuScenes, double-flip and large
Waymo configs; PillarNet on its KITTI and Waymo configs; DSVT-Pillar and
DSVT-Voxel on their Waymo configs), with `waymo_batches` for the Waymo
configs, TransFusion-L on nuScenes, and MPPNet (4 and 16 frames) and
MPPNetE2E on their Waymo configs with `waymo_sequence_batches`, and the
configs derived from shipped ones that run the model options and legacy
compact schemas (`option_cfg`: `centerpoint_options`, `second_iou_height`,
`voxel_rcnn_compact`, `pv_rcnn_compact`, `pv_rcnn_plusplus_compact`,
`parta2_compact`, `voxelnext_compact`).

`voxel_centerpoint` is voxel CenterPoint on the public OpenPCDet nuScenes
config tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml
(MeanVFE, VoxelResBackBone8x, 0.1 × 0.1 × 0.2 m voxels), built as the JAX
package's tools/test.py and tools/train.py build it: the grid from
POINT_CLOUD_RANGE and the last transform_points_to_voxels VOXEL_SIZE, the
voxel cap from MAX_NUMBER_OF_VOXELS['test'] (['train'] for training).
"""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from .core.voxel import VoxelGrid
from .data.batch import MultimodalBatch, PointBatch
from .models import build_network
from .utils.config import CfgDict, cfg_from_yaml_file

VOXEL_CFG = (Path(__file__).resolve().parents[1]
             / "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml")
# 12.8 m square, full height: a 128 x 128 x 40 grid at the config's voxels
VOXEL_TINY_RANGE = [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]


def voxel_centerpoint(tiny: bool = False, device="cuda", train: bool = False):
    """Returns (cfg, grid, model) at full widths, in train mode with `train`;
    `tiny` shrinks only the point-cloud range. The model's weights are
    PyTorch's defaults."""
    cfg = cfg_from_yaml_file(VOXEL_CFG, CfgDict())
    if tiny:
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(VOXEL_TINY_RANGE)
    voxel_cfg = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p.NAME.startswith("transform_points_to_voxels")][-1]
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, voxel_cfg.VOXEL_SIZE)
    max_voxels = voxel_cfg.MAX_NUMBER_OF_VOXELS
    if isinstance(max_voxels, dict):
        max_voxels = max_voxels["train" if train else "test"]
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=train,
                          max_voxels=int(max_voxels))
    return cfg, grid, model


POINTRCNN_CFG = (Path(__file__).resolve().parents[1]
                 / "tools/cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml")
POINTRCNN_BATCH_SIZE = 4  # the config's BATCH_SIZE_PER_GPU
POINTRCNN_SEED = 0


def pointrcnn(device="cuda", train: bool = False):
    """PointRCNN on DFU3D's second detector config
    tools/cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml at its published
    widths: returns (cfg, grid, model) in eval mode, or in train mode with
    `train`, with the grid of the config's voxel placeholder (the model
    reads no grid). The model's weights are PyTorch's defaults."""
    cfg = cfg_from_yaml_file(POINTRCNN_CFG, CfgDict())
    voxel_cfg = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                 if p.NAME.startswith("transform_points_to_voxels")][-1]
    grid = VoxelGrid.create(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, voxel_cfg.VOXEL_SIZE)
    model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device=device, train=train)
    return cfg, grid, model


def pointrcnn_batches(cfg, root, info_file, num_batches: int, training: bool = False):
    """`kitti_batches` of POINTRCNN_BATCH_SIZE frames, numpy's global
    generator seeded with POINTRCNN_SEED: the config's processors mask the
    range, sample 16,384 points (sample_points) and shuffle them; in train
    mode the base dataset config's augmentations run first (gt sampling,
    flip, rotation, scaling, translation)."""
    return kitti_batches(cfg, root, info_file, num_batches, POINTRCNN_BATCH_SIZE, training,
                         seed=POINTRCNN_SEED)


def write_pointrcnn_root(cfg, root, num_frames: int, training: bool = False):
    """A synthetic KITTI-format root of `num_frames` frames in the val split,
    or with `training` in the train split with its gt database under the
    name the config's gt sampling reads (data.kitti_synthetic at its
    defaults: 40,000-60,000 points in the camera frustum, 20-40 boxes of the
    config's classes, seed POINTRCNN_SEED), and its info file; returns the
    info file's path."""
    from .data import kitti_synthetic
    from .data.kitti_dataset import KittiDataset, create_kitti_infos

    split = "train" if training else "val"
    kitti_synthetic.write_root(root, num_frames if training else 0, 0 if training else num_frames,
                               cfg.CLASS_NAMES, seed=POINTRCNN_SEED)
    (info,) = create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, splits=(split,))
    if training:
        dataset = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
        dataset.set_split("train")
        dbinfos = dataset.create_groundtruth_database(info, root, used_classes=cfg.CLASS_NAMES,
                                                      split="train")
        (sampling,) = [a for a in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
                       if a.NAME == "gt_sampling"]
        Path(dbinfos).rename(Path(root) / sampling.DB_INFO_PATH[0])
    return info


PROPOSAL_GT = 16  # gt boxes per frame that proposal_gt appends


def proposal_gt(model, batch, dtype=torch.float32, count: int = PROPOSAL_GT):
    """`batch` on the model's device with `count` gt boxes per frame
    appended after its own, made of the two-stage `model`'s first-stage
    boxes as its train step would propose them now (train mode, under
    `dtype` autocast; the BN running statistics are put back): gt j of a
    frame is the box of its j-th highest score, with its class, shifted
    along x by 0.05·j of its length. The first stage is PointRCNN's point
    head, or the anchor RPN of SECONDNetIoU, VoxelRCNN and PVRCNN. The
    proposal NMS always keeps the highest-scored box, so every frame then
    has a RoI at IoU 1 with its gt 0, over REG_FG_THRESH: the RoI head's reg
    and corner losses (SECOND-IoU's IoU labels) carry gradient, as a
    trained model's do, where seeded random weights alone almost never
    propose a box over it. The shifts put RoIs on both sides of each IoU
    threshold of the target layer. Runs no NMS, so no kernel."""
    from .models.pointrcnn import point_decode

    dev = next(model.parameters()).device
    batch = batch.to(dev)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    with torch.no_grad(), torch.autocast(dev.type, dtype=dtype,
                                         enabled=dtype != torch.float32):
        if hasattr(model, "stage1"):
            _, cls_logits, box_codes = model.stage1(batch)
        else:
            preds = model.features(batch)
    for k, v in model.named_buffers():
        v.copy_(buffers[k])
    if hasattr(model, "stage1"):
        pred_cls = torch.argmax(cls_logits, dim=-1) + 1
        boxes = point_decode(box_codes, batch.points[..., :3].float(), pred_cls, model.mean_sizes)
        scores = torch.where(batch.points_valid, torch.sigmoid(cls_logits).amax(dim=-1), -1.0)
    else:
        boxes, cls_scores = model.decode({k: v.float() for k, v in preds.items()})
        pred_cls = torch.argmax(cls_scores, dim=-1) + 1
        scores = cls_scores.amax(dim=-1)
    top = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :count]
    gt = torch.cat([torch.gather(boxes, 1, top[..., None].expand(-1, -1, 7)),
                    torch.gather(pred_cls, 1, top)[..., None].float()], dim=-1)
    shift = 0.05 * torch.arange(count, device=dev, dtype=gt.dtype)
    gt[..., 0] += shift * gt[..., 3]
    return batch._replace(
        gt_boxes=torch.cat([batch.gt_boxes, gt.to(batch.gt_boxes.dtype)], dim=1),
        gt_valid=torch.cat([batch.gt_valid, torch.ones_like(top, dtype=torch.bool)], dim=1))


SECOND_MULTIHEAD_CFG = (Path(__file__).resolve().parents[1]
                        / "tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml")
PP_MULTIHEAD_CFG = (Path(__file__).resolve().parents[1]
                    / "tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml")
TRANSFUSION_CFG = (Path(__file__).resolve().parents[1]
                   / "tools/cfgs/nuscenes_models/transfusion_lidar.yaml")
NUSCENES_BATCH_SIZE = 4  # the configs' BATCH_SIZE_PER_GPU


def _nuscenes_detector(path, device, train):
    from .tools.common import build_model, model_grid

    cfg = cfg_from_yaml_file(path, CfgDict())
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def second_multihead(train: bool = False, device="cuda"):
    """SECONDNet on tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml at
    its published widths, built as the CLIs build it (tools.common.
    build_model): MeanVFE over the 5 point features (x, y, z, intensity,
    time lag), VoxelBackBone8x on the 1024 x 1024 x 40 grid with
    MAX_NUMBER_OF_VOXELS (60,000), BaseBEVBackbone [5, 5], AnchorHeadMulti
    with six class groups. Returns (cfg, grid, model), in eval mode or in
    train mode with `train`; the weights are PyTorch's defaults."""
    return _nuscenes_detector(SECOND_MULTIHEAD_CFG, device, train)


def pp_multihead(train: bool = False, device="cuda"):
    """PointPillar on tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml at
    its published widths (DynPillarVFE 64 on the 512 x 512 grid,
    BaseBEVBackbone [3, 5, 5], AnchorHeadMulti); as `second_multihead`."""
    return _nuscenes_detector(PP_MULTIHEAD_CFG, device, train)


def transfusion(train: bool = False, device="cuda"):
    """TransFusion-L on tools/cfgs/nuscenes_models/transfusion_lidar.yaml at
    its published widths, built as the CLIs build it (tools.common.
    build_model): MeanVFE over the 5 point features, VoxelResBackBone8x
    16-32-64-128 on the 1440 x 1440 x 40 grid with MAX_NUMBER_OF_VOXELS
    (120,000 train, 160,000 test), BaseBEVBackbone [5, 5] to 512 channels at
    180 x 180, TransFusionHead (hidden 128, 200 proposals, 8 heads, the vel
    branch, the Hungarian matcher). Returns (cfg, grid, model), in eval mode
    or in train mode with `train`; the weights are PyTorch's defaults."""
    return _nuscenes_detector(TRANSFUSION_CFG, device, train)


def nuscenes_batches(cfg, root, info_file, num_batches: int, training: bool = False, seed=0):
    """`num_batches` PointBatches of NUSCENES_BATCH_SIZE frames read from the
    nuScenes-layout `root` through NuScenesDataset, the frames of
    `info_file` in order (repeated if there are fewer): key frame plus
    MAX_SWEEPS - 1 sweeps with the time-lag channel, the config's processors
    (range mask, shuffle), at most MAX_POINTS_PER_FRAME points per frame. In
    test mode, or with `training` in train mode (the config's augmentations
    but gt sampling, whose database neither package can write for nuScenes;
    class-balanced resampling); numpy's global generator, which the
    augmentations draw from, is seeded with `seed`."""
    from .data.nuscenes_dataset import NuScenesDataset

    ds_cfg = copy.deepcopy(cfg.DATA_CONFIG)
    ds_cfg.DATA_AUGMENTOR.DISABLE_AUG_LIST = ["gt_sampling"]
    ds_cfg.DATA_PATH = str(root)
    ds_cfg.INFO_PATH = {"train": [str(info_file)] if training else [],
                        "test": [] if training else [str(info_file)]}
    dataset = NuScenesDataset(ds_cfg, cfg.CLASS_NAMES, training=training, root_path=Path(root),
                              rng=np.random.RandomState(seed))
    np.random.seed(seed)
    b = NUSCENES_BATCH_SIZE
    frames = [dataset[i % len(dataset)] for i in range(num_batches * b)]
    return [dataset.collate_batch(frames[i:i + b])[0] for i in range(0, len(frames), b)]


KITTI_CFGS = Path(__file__).resolve().parents[1] / "tools/cfgs/kitti_models"
TWO_STAGE_CFGS = {"second_iou": "second_iou.yaml", "voxel_rcnn": "voxel_rcnn_car.yaml",
                  "pv_rcnn": "pv_rcnn.yaml", "parta2": "PartA2.yaml",
                  "parta2_free": "PartA2_free.yaml", "pv_rcnn_plusplus": "pv_rcnn_plusplus.yaml"}


def _kitti_detector(name, device, train):
    from .tools.common import build_model, model_grid

    cfg = cfg_from_yaml_file(KITTI_CFGS / TWO_STAGE_CFGS[name], CfgDict())
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def second_iou(train: bool = False, device="cuda"):
    """SECONDNetIoU on tools/cfgs/kitti_models/second_iou.yaml at its
    published widths, built as the CLIs build it (tools.common.build_model):
    MeanVFE, VoxelBackBone8x on the 1408 x 1600 x 40 grid with
    MAX_NUMBER_OF_VOXELS (16,000 train, 40,000 test), BaseBEVBackbone
    [5, 5], AnchorHeadSingle over Car, Pedestrian, Cyclist, the SECONDHead
    IoU stage. Returns (cfg, grid, model), in eval mode or in train mode
    with `train`; the weights are PyTorch's defaults."""
    return _kitti_detector("second_iou", device, train)


def voxel_rcnn(train: bool = False, device="cuda"):
    """VoxelRCNN on tools/cfgs/kitti_models/voxel_rcnn_car.yaml (Car only) at
    its published widths, on the JAX package's SparseEncoder trunk; as
    `second_iou`."""
    return _kitti_detector("voxel_rcnn", device, train)


def pv_rcnn(train: bool = False, device="cuda"):
    """PVRCNN on tools/cfgs/kitti_models/pv_rcnn.yaml at its published
    widths (2,048 keypoints), on the JAX package's SparseEncoder trunk; as
    `second_iou`."""
    return _kitti_detector("pv_rcnn", device, train)


def parta2(train: bool = False, device="cuda"):
    """PartA2Net on tools/cfgs/kitti_models/PartA2.yaml at its published
    widths (SparseUNet 16-64 with conv_out 128, the part head's seg_mlp 128,
    128, the RoI-aware pools at 12³ with 512 samples per RoI, SHARED_FC
    256 x 3); as `second_iou`."""
    return _kitti_detector("parta2", device, train)


def parta2_free(train: bool = False, device="cuda"):
    """PartA2Net on tools/cfgs/kitti_models/PartA2_free.yaml: PartA2's
    anchor RPN with DISABLE_PART and SEG_MASK_SCORE_THRESH 0, as the JAX
    package builds it; as `second_iou`."""
    return _kitti_detector("parta2_free", device, train)


def pv_rcnn_plusplus(train: bool = False, device="cuda"):
    """PVRCNNPlusPlus on tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml at
    its published widths (4,096 proposal-centric keypoints, vector pools of
    3 x 3 x 3 bins), on the JAX package's SparseEncoder trunk; as
    `second_iou`."""
    return _kitti_detector("pv_rcnn_plusplus", device, train)


def kitti_batches(cfg, root, info_file, num_batches: int, batch_size: int,
                  training: bool = False, seed=0):
    """`num_batches` PointBatches of `batch_size` frames read from the KITTI
    root through KittiDataset, the frames of `info_file` in order (repeated
    if there are fewer), through the config's processors (FOV, range mask,
    shuffle). In test mode, or with `training` in train mode: the config's
    augmentations first (gt sampling from the root's gt database, flip,
    rotation, scaling); numpy's global generator, which they draw from, is
    seeded with `seed`."""
    from .data.kitti_dataset import KittiDataset

    ds_cfg = copy.deepcopy(cfg.DATA_CONFIG)
    ds_cfg.DATA_PATH = str(root)
    ds_cfg.INFO_PATH = {"train": [str(info_file)] if training else [],
                        "test": [] if training else [str(info_file)]}
    dataset = KittiDataset(ds_cfg, cfg.CLASS_NAMES, training=training, root_path=Path(root))
    np.random.seed(seed)
    frames = [dataset[i % len(dataset)] for i in range(num_batches * batch_size)]
    return [dataset.collate_batch(frames[i:i + batch_size])[0]
            for i in range(0, len(frames), batch_size)]


CFGS = Path(__file__).resolve().parents[1] / "tools/cfgs"
FULLY_SPARSE_CFGS = {
    "voxelnext": "nuscenes_models/cbgs_voxel0075_voxelnext.yaml",
    "voxelnext_tta": "nuscenes_models/cbgs_voxel0075_voxelnext_doubleflip.yaml",
    "voxelnext_iou_large": "waymo_models/voxelnext_ioubranch_large.yaml",
    "pillarnet": "kitti_models/pillarnet.yaml",
    "pillarnet_waymo": "waymo_models/pillarnet.yaml",
}
DSVT_CFGS = {"dsvt_pillar": "waymo_models/dsvt_pillar.yaml",
             "dsvt_voxel": "waymo_models/dsvt_voxel.yaml"}


def _fully_sparse(name, device, train):
    from .tools.common import build_model, model_grid

    cfg = cfg_from_yaml_file(CFGS / {**FULLY_SPARSE_CFGS, **DSVT_CFGS}[name], CfgDict())
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def voxelnext(train: bool = False, device="cuda"):
    """VoxelNeXt on tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext.yaml
    at its published widths, built as the CLIs build it (tools.common.
    build_model): MeanVFE over the 5 point features, the 1440 x 1440 x 40
    grid with MAX_NUMBER_OF_VOXELS (120,000 train, 160,000 test), six class
    groups with a vel branch. Returns (cfg, grid, model), in eval mode or in
    train mode with `train`; the weights are PyTorch's defaults."""
    return _fully_sparse("voxelnext", device, train)


def voxelnext_tta(train: bool = False, device="cuda"):
    """VoxelNeXt on cbgs_voxel0075_voxelnext_doubleflip.yaml (the double-flip
    test-time augmentation); as `voxelnext`."""
    return _fully_sparse("voxelnext_tta", device, train)


def voxelnext_iou_large(train: bool = False, device="cuda"):
    """VoxelNeXt on tools/cfgs/waymo_models/voxelnext_ioubranch_large.yaml:
    the 1504 x 1504 x 40 Waymo grid, 150,000 voxels, channels up to 256,
    5 x 5 x 5 strided convs at strides 2 and 4, the IoU branch; as
    `voxelnext`. The Waymo configs run on `waymo_batches` (no Waymo
    dataset in the port)."""
    return _fully_sparse("voxelnext_iou_large", device, train)


def pillarnet(train: bool = False, device="cuda"):
    """PillarNetAnchor on tools/cfgs/kitti_models/pillarnet.yaml: the
    704 x 800 x 1 pillar grid with MAX_NUMBER_OF_VOXELS (16,000 train, 40,000
    test), DynamicPillarVFESimple2D, PillarBackBone8x 32-256, the conv5
    stage, BaseBEVBackboneV1 [5, 5], AnchorHeadSingle; as `voxelnext`."""
    return _fully_sparse("pillarnet", device, train)


def pillarnet_waymo(train: bool = False, device="cuda"):
    """PillarNetCenter on tools/cfgs/waymo_models/pillarnet.yaml: the
    1504 x 1504 x 1 pillar grid, 150,000 pillars, PillarRes18BackBone8x,
    CenterHead over Vehicle, Pedestrian, Cyclist; as `voxelnext_iou_large`."""
    return _fully_sparse("pillarnet_waymo", device, train)


def dsvt_pillar(train: bool = False, device="cuda"):
    """CenterPoint with DSVT-Pillar on tools/cfgs/waymo_models/dsvt_pillar.yaml
    at its published widths, built as the CLIs build it: DynamicVoxelVFE
    [192, 192] over the 5 point features on the 468 x 468 x 1 grid (0.32 m
    pillars, 60,000 per frame: the placeholder processor sets no
    MAX_NUMBER_OF_VOXELS), four blocks of two set-attention layers (d_model
    192, 8 heads, FFN 384, sets of 36 in 12 x 12 windows, MAX_SETS 1024),
    BaseBEVBackbone [1, 2, 2] to 384 channels, CenterHead at stride 1. As
    `voxelnext_iou_large`; on `waymo_batches`."""
    return _fully_sparse("dsvt_pillar", device, train)


def dsvt_voxel(train: bool = False, device="cuda"):
    """CenterPoint with DSVT-Voxel on tools/cfgs/waymo_models/dsvt_voxel.yaml:
    as `dsvt_pillar` on the 468 x 468 x 32 grid (0.1875 m in z, 60,000
    voxels per frame), four single-block stages of 3D set attention (sets
    of 48; windows 12 x 12 x 32, 8, 2, 1) joined by attention pooling along
    z (strides 4, 4, 2)."""
    return _fully_sparse("dsvt_voxel", device, train)


WAYMO_BATCH_SIZE = 4   # the Waymo configs' BATCH_SIZE_PER_GPU
# (length, width, height) in metres of the Waymo classes' boxes
WAYMO_CLASS_DIMS = {"Vehicle": (4.7, 2.1, 1.7), "Pedestrian": (0.9, 0.9, 1.8),
                    "Cyclist": (1.8, 0.8, 1.8)}


def waymo_batches(cfg, num_batches: int, num_points: int = 150_000, num_boxes=(20, 40),
                  seed: int = 0, batch_size: int = WAYMO_BATCH_SIZE):
    """`num_batches` PointBatches of `batch_size` frames made in memory for a
    Waymo config (the port has no Waymo dataset): per frame `num_points`
    points in POINT_CLOUD_RANGE with its five features (x, y, z, intensity,
    elongation): 15 % on the surfaces of 20-40 boxes of the config's classes
    (standing on the ground at z = 0, random headings, the box sizes of
    WAYMO_CLASS_DIMS within ±10 %), 70 % on the ground with a density
    falling as 1 / range, 15 % clutter uniform in the range; gt (B,
    num_boxes[1], 8) with the class id last, the unused slots invalid. From
    a numpy generator seeded with `seed`."""
    rng = np.random.RandomState(seed)
    lo, hi = _waymo_range(cfg)
    out = []
    for _ in range(num_batches):
        pts = np.zeros((batch_size, num_points, 5), np.float32)
        gt = np.zeros((batch_size, num_boxes[1], 8), np.float32)
        gt_valid = np.zeros((batch_size, num_boxes[1]), bool)
        for i in range(batch_size):
            cls, dims, ctr, yaw = _waymo_boxes(rng, cfg, num_boxes, lo, hi)
            m = len(cls)
            gt[i, :m] = np.concatenate([ctr, dims[:, 2:3] / 2, dims, yaw[:, None],
                                        cls[:, None] + 1.0], axis=1)
            gt_valid[i, :m] = True
            pts[i] = _waymo_frame(rng, ctr, dims, yaw, num_points, lo, hi)
        out.append(PointBatch.from_numpy(pts, np.ones((batch_size, num_points), bool), gt,
                                         gt_valid))
    return out


def _waymo_range(cfg):
    return (np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[:3], np.float32),
            np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[3:], np.float32))


def _waymo_boxes(rng, cfg, num_boxes, lo, hi):
    """20-40 boxes of the config's classes: (class index, dims, BEV centre,
    heading)."""
    names = list(cfg.CLASS_NAMES)
    m = rng.randint(num_boxes[0], num_boxes[1] + 1)
    cls = rng.randint(0, len(names), m)
    dims = np.array([WAYMO_CLASS_DIMS[names[c]] for c in cls], np.float32)
    dims *= rng.uniform(0.9, 1.1, dims.shape).astype(np.float32)
    ctr = rng.uniform(lo[:2] * 0.9, hi[:2] * 0.9, (m, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    return cls, dims, ctr, yaw


def _waymo_frame(rng, ctr, dims, yaw, num_points, lo, hi):
    """One frame's (num_points, 5) points around the boxes (see
    `waymo_batches`)."""
    m = len(ctr)
    n_box, n_ground = int(0.15 * num_points), int(0.7 * num_points)
    n_clutter = num_points - n_box - n_ground
    # box surfaces: a random face point per sample, rotated by the heading
    owner = rng.randint(0, m, n_box)
    u = rng.uniform(-0.5, 0.5, (n_box, 3)).astype(np.float32)
    face = rng.randint(0, 3, n_box)
    u[np.arange(n_box), face] = np.sign(u[np.arange(n_box), face]) * 0.5
    local = u * dims[owner]
    c, s = np.cos(yaw[owner]), np.sin(yaw[owner])
    box_xyz = np.stack([local[:, 0] * c - local[:, 1] * s + ctr[owner, 0],
                        local[:, 0] * s + local[:, 1] * c + ctr[owner, 1],
                        local[:, 2] + dims[owner, 2] / 2], axis=1)
    reach = float(np.abs(np.concatenate([lo[:2], hi[:2]])).max())
    r = reach * rng.uniform(0.02, 1.0, n_ground)
    phi = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(phi), r * np.sin(phi),
                       rng.normal(0.0, 0.03, n_ground)], axis=1)
    ground = ground[(np.abs(ground[:, :2]) < hi[:2]).all(axis=1)]
    clutter = rng.uniform(lo, hi, (n_clutter + n_ground - len(ground), 3))
    xyz = np.concatenate([box_xyz, ground, clutter]).astype(np.float32)
    pts = np.zeros((num_points, 5), np.float32)
    pts[:, :3] = xyz[rng.permutation(num_points)]
    pts[:, 3] = rng.uniform(0, 1, num_points)
    pts[:, 4] = rng.uniform(0, 1, num_points)
    return pts


MPPNET_BATCH_SIZE = 2   # the MPPNet configs' BATCH_SIZE_PER_GPU
FRAME_DT = 0.1          # s between Waymo frames, the head's frame_dt
# the largest speed (m/s) of each class's boxes
WAYMO_CLASS_SPEED = {"Vehicle": 15.0, "Pedestrian": 3.0, "Cyclist": 3.0}


def waymo_sequence_batches(cfg, num_batches: int, frames: int, num_points: int = 150_000,
                           num_boxes=(20, 40), seed: int = 0,
                           batch_size: int = MPPNET_BATCH_SIZE, sequence: bool = False):
    """`num_batches` multi-frame PointBatches of `batch_size` samples for the
    MPPNet configs, made in memory: each sample is a scene of 20-40 boxes of
    the config's classes (as `waymo_batches`), each box moving at a seeded
    speed (Vehicles 0-15 m/s, Pedestrians and Cyclists 0-3 m/s) along a
    random direction; its `frames` frames have the lags 0, 0.1, ..., 0.1 ·
    (frames - 1) s, frame f `num_points` points (`waymo_batches`' recipe)
    with the boxes where they were f · 0.1 s earlier, and the lag as a sixth
    channel; the frames are concatenated, frame 0 first. The gt is frame
    0's boxes. With `sequence` every batch holds the same scenes 0.1 s later
    than the batch before (the requests of one E2E sequence), else each
    batch draws new scenes. From a numpy generator seeded with `seed`."""
    rng = np.random.RandomState(seed)
    lo, hi = _waymo_range(cfg)
    names = list(cfg.CLASS_NAMES)
    n = frames * num_points
    scenes, out = None, []
    for k in range(num_batches):
        if scenes is None or not sequence:
            scenes = []
            for _ in range(batch_size):
                cls, dims, ctr, yaw = _waymo_boxes(rng, cfg, num_boxes, lo, hi)
                speed = rng.uniform(0, 1, len(cls)) * np.array(
                    [WAYMO_CLASS_SPEED[names[c]] for c in cls])
                heading = rng.uniform(-np.pi, np.pi, len(cls))
                vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)], 1)
                scenes.append((cls, dims, ctr, yaw, vel.astype(np.float32)))
        now = FRAME_DT * k if sequence else 0.0
        pts = np.zeros((batch_size, n, 6), np.float32)
        gt = np.zeros((batch_size, num_boxes[1], 8), np.float32)
        gt_valid = np.zeros((batch_size, num_boxes[1]), bool)
        for i, (cls, dims, ctr, yaw, vel) in enumerate(scenes):
            for f in range(frames):
                at = (ctr + vel * np.float32(now - FRAME_DT * f)).astype(np.float32)
                sl = slice(f * num_points, (f + 1) * num_points)
                pts[i, sl, :5] = _waymo_frame(rng, at, dims, yaw, num_points, lo, hi)
                pts[i, sl, 5] = np.float32(FRAME_DT * f)
                if f == 0:
                    m = len(cls)
                    gt[i, :m] = np.concatenate([at, dims[:, 2:3] / 2, dims, yaw[:, None],
                                                cls[:, None] + 1.0], axis=1)
                    gt_valid[i, :m] = True
        out.append(PointBatch.from_numpy(pts, np.ones((batch_size, n), bool), gt, gt_valid))
    return out


MPPNET_CFGS = {"mppnet_4frames": "waymo_models/mppnet_4frames.yaml",
               "mppnet_16frames": "waymo_models/mppnet_16frames.yaml",
               "mppnet_e2e": "waymo_models/mppnet_e2e_memorybank_inference.yaml"}


def _mppnet(name, device, train):
    from .tools.common import build_model, model_grid

    cfg = cfg_from_yaml_file(CFGS / MPPNET_CFGS[name], CfgDict())
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def mppnet_4frames(train: bool = False, device="cuda"):
    """MPPNet on tools/cfgs/waymo_models/mppnet_4frames.yaml at its published
    widths, built as the CLIs build it (tools.common.build_model): the
    Waymo SECOND first stage (MeanVFE over the 6 point features x, y, z,
    intensity, elongation, time lag; VoxelBackBone8x on the 1504 x 1504 x 40
    grid with 150,000 voxels; BaseBEVBackbone [5, 5]; AnchorHeadSingle over
    Vehicle, Pedestrian, Cyclist), the proposal NMS 1024 → 100, and the
    trajectory head over 4 frames in 4 groups (HIDDEN 256, 3 layers, 4
    heads, FFN 1024, 64 proxies, 128 points per frame and RoI, balls of
    0.8 and 1.6 m with 32 samples). Returns (cfg, grid, model), in eval mode
    or in train mode with `train`; the weights are PyTorch's defaults. On
    `waymo_sequence_batches` (no Waymo dataset in the port)."""
    return _mppnet("mppnet_4frames", device, train)


def mppnet_16frames(train: bool = False, device="cuda"):
    """MPPNet on tools/cfgs/waymo_models/mppnet_16frames.yaml: as
    `mppnet_4frames` over 16 frames in 4 groups (stride 1)."""
    return _mppnet("mppnet_16frames", device, train)


def mppnet_e2e(train: bool = False, device="cuda"):
    """MPPNetE2E on tools/cfgs/waymo_models/mppnet_e2e_memorybank_inference.yaml:
    as `mppnet_4frames`, the first stage on the current frame's points and
    the memory bank of the 3 past frames' geometry features
    (`predict_with_bank`, `models.mppnet.make_bank_eval_step`)."""
    return _mppnet("mppnet_e2e", device, train)


CAMERA_CFGS = {"bevfusion": "nuscenes_models/bevfusion.yaml", "caddn": "kitti_models/CaDDN.yaml",
               "voxel_rcnn_focal": "kitti_models/voxel_rcnn_focal.yaml",
               "voxel_rcnn_focal_car": "kitti_models/voxel_rcnn_car_focal_multimodal.yaml"}
CAMERA_BATCH_SIZE = 4   # the camera configs' BATCH_SIZE_PER_GPU
CAMERA_RIGS = {"nuscenes": (256, 704), "kitti": (375, 1242)}   # the rigs' image sizes


# OpenPCDet's CaDDN.yaml range: CaDDN.yaml here keeps kitti_dataset.yaml's
# [0, -40, -3, 70.4, 40, 1], whose 500 BEV rows (0.16 m) do not divide by
# the BEV backbone's 8, so that its upsampled levels (250, 250 and 252 rows)
# do not concatenate, in either package
CADDN_RANGE = [2.0, -30.08, -3.0, 46.8, 30.08, 1.0]


def _camera_detector(name, device, train):
    from .tools.common import build_model, model_grid

    cfg = cfg_from_yaml_file(CFGS / CAMERA_CFGS[name], CfgDict())
    if name == "caddn":
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(CADDN_RANGE)
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def bevfusion(train: bool = False, device="cuda"):
    """BevFusion on tools/cfgs/nuscenes_models/bevfusion.yaml at its
    published widths, built as the CLIs build it (tools.common.build_model):
    the transfusion_lidar.yaml trunk (MeanVFE over 5 point features,
    VoxelResBackBone8x 16-32-64-128 on the 1440 x 1440 x 40 grid), Swin-T
    (96, [2, 2, 6, 2], window 7) on 256 x 704 images, the LSS FPN at 256,
    DepthLSS (118 depth bins, 80 channels, DOWNSAMPLE 2), ConvFuser 336 →
    256, BaseBEVBackbone, TransFusionHead. Returns (cfg, grid, model); the
    weights are PyTorch's defaults. It reads `camera_batches(cfg, n,
    "nuscenes", (256, 704))`."""
    return _camera_detector("bevfusion", device, train)


def caddn(train: bool = False, device="cuda"):
    """CaDDN on tools/cfgs/kitti_models/CaDDN.yaml at its published widths:
    DDNDeepLabV3 over ResNet-101 on 375 x 1242 images, CHANNEL_REDUCE 256 →
    64, 80 LID bins over 2-46.8 m, frustum-to-voxel on the 280 x 376 x 1
    grid of OpenPCDet's CaDDN range (CADDN_RANGE: the shipped range's grid
    does not run), Conv2DCollapse 64, BaseBEVBackbone [10, 10, 10],
    AnchorHeadSingle; as `bevfusion`. It reads `camera_batches(cfg, n, "kitti", (375,
    1242))`."""
    return _camera_detector("caddn", device, train)


def voxel_rcnn_focal(train: bool = False, device="cuda"):
    """VoxelRCNN on tools/cfgs/kitti_models/voxel_rcnn_focal.yaml at its
    published widths: VoxelBackBone8xFocal on the 1408 x 1600 x 40 grid with
    MAX_NUMBER_OF_VOXELS (16,000 train, 40,000 test), USE_IMG (the first
    camera's image features in focal1), the Voxel R-CNN head; as
    `bevfusion`. It reads `camera_batches(cfg, n, "kitti", (375, 1242))`."""
    return _camera_detector("voxel_rcnn_focal", device, train)


def voxel_rcnn_focal_car(train: bool = False, device="cuda"):
    """VoxelRCNN on tools/cfgs/kitti_models/voxel_rcnn_car_focal_multimodal.yaml
    (voxel_rcnn_focal.yaml with Car only); as `voxel_rcnn_focal`."""
    return _camera_detector("voxel_rcnn_focal_car", device, train)


# (length, width, height) in metres of the camera configs' classes
CAMERA_CLASS_DIMS = {
    "car": (4.6, 1.9, 1.7), "truck": (6.9, 2.5, 2.8), "construction_vehicle": (6.4, 2.8, 3.2),
    "bus": (11.0, 2.9, 3.5), "trailer": (12.0, 2.9, 3.9), "barrier": (0.5, 2.5, 1.0),
    "motorcycle": (2.1, 0.8, 1.5), "bicycle": (1.7, 0.6, 1.3), "pedestrian": (0.7, 0.7, 1.8),
    "traffic_cone": (0.4, 0.4, 1.1), "Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
    "Cyclist": (1.76, 0.6, 1.73)}
# KITTI's calibration of a typical drive (P2, R0_rect, Tr_velo_to_cam)
KITTI_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728], [0.0, 721.5377, 172.854, 0.2163791],
                     [0.0, 0.0, 1.0, 0.002745884]], np.float32)
KITTI_R0 = np.array([[0.9999239, 0.00983776, -0.007445048], [-0.009869795, 0.9999421, -0.004278459],
                     [0.007402527, 0.004351614, 0.9999631]], np.float32)
KITTI_TR = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                     [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                     [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]], np.float32)
NUSC_CAMERA_YAWS = (0.0, 55.0, -55.0, 110.0, -110.0, 180.0)   # degrees, left of the x axis
GROUND_Z = {"nuscenes": -1.8, "kitti": -1.73}   # the road under the lidar


def camera_rig(cameras: str, image_size):
    """(cam_intrinsics (N, 3, 3), cam2lidar_rots (N, 3, 3), cam2lidar_trans
    (N, 3), lidar_to_cam (N, 4, 4), cam_to_img (N, 3, 4)) fp32 of a rig:
    "nuscenes", six cameras on a ring (yaws NUSC_CAMERA_YAWS, 0.5 m from the
    lidar, 0.3 m below it) with nuScenes' 1266-pixel focal length scaled by
    the test resize 0.48 and the principal point at the centre of the
    `image_size` crop; "kitti", the front camera with KITTI's P2 (scaled to
    `image_size` from its 375 x 1242), R0_rect and Tr_velo_to_cam."""
    h, w = image_size
    if cameras == "kitti":
        l2c = np.eye(4, dtype=np.float32)
        l2c[:3, :4] = KITTI_R0 @ KITTI_TR
        c2i = KITTI_P2[None].copy()
        c2i[:, 0] *= w / 1242.0   # P2 is KITTI's for 375 x 1242 images
        c2i[:, 1] *= h / 375.0
        l2c = l2c[None]
    elif cameras == "nuscenes":
        f = 1266.0 * 0.48
        k = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]], np.float32)
        l2c, c2i = [], []
        for yaw in np.deg2rad(NUSC_CAMERA_YAWS):
            fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
            rot = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)    # camera axes in the lidar frame
            t = 0.5 * fwd + np.array([0.0, 0.0, -0.3])
            m = np.eye(4)
            m[:3, :3], m[:3, 3] = rot.T, -rot.T @ t
            l2c.append(m)
            c2i.append(np.concatenate([k, np.zeros((3, 1), np.float32)], axis=1))
        l2c, c2i = np.asarray(l2c, np.float32), np.asarray(c2i, np.float32)
    else:
        raise ValueError(f"cameras must be 'nuscenes' or 'kitti', got {cameras!r}")
    c2l = np.linalg.inv(l2c.astype(np.float64)).astype(np.float32)
    return c2i[:, :, :3].copy(), c2l[:, :3, :3].copy(), c2l[:, :3, 3].copy(), l2c, c2i


def project_depth(points, lidar_to_cam, cam_to_img, image_size):
    """(N, H, W) depth maps of one frame's points (P, 3+) in each camera:
    the nearest point's camera depth at the pixel it falls in (floor of u,
    v), 0 where no point falls."""
    h, w = image_size
    out = np.zeros((len(lidar_to_cam), h, w), np.float32)
    hom = np.concatenate([points[:, :3], np.ones((len(points), 1), np.float32)], axis=1)
    for c, (l2c, c2i) in enumerate(zip(lidar_to_cam, cam_to_img)):
        img = (hom @ l2c.T) @ c2i.T
        depth = img[:, 2]
        ok = depth > 0.1
        u = np.floor(img[ok, 0] / depth[ok]).astype(np.int64)
        v = np.floor(img[ok, 1] / depth[ok]).astype(np.int64)
        d = depth[ok]
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        u, v, d = u[inside], v[inside], d[inside]
        order = np.argsort(-d, kind="stable")        # the nearest written last
        out[c, v[order], u[order]] = d[order]
    return out


def camera_batches(cfg, num_batches: int, cameras: str, image_size, seed: int = 0,
                   num_points=None, num_boxes=(20, 40), batch_size: int = CAMERA_BATCH_SIZE):
    """`num_batches` MultimodalBatches of `batch_size` frames made in memory
    for a camera config (neither package loads images from disk): per
    frame the points of `waymo_batches`' scene (15 % on the surfaces of
    20-40 boxes of the config's classes standing on the road, 70 % on the
    road, 15 % clutter in POINT_CLOUD_RANGE; num_points by default 65,536 on
    "nuscenes" with the time lag 0-0.45 s as fifth feature, 32,768 on
    "kitti" with 4 features), gt with (vx, vy) before the class id on
    "nuscenes"; the rig of `camera_rig`; depth maps made by projecting the
    frame's points into each camera (`project_depth`), sparse as real ones
    are; images drawn uniform in [0, 1). From a numpy generator seeded with
    `seed`."""
    rng = np.random.RandomState(seed)
    rig = camera_rig(cameras, image_size)
    n_cam = len(rig[0])
    nusc = cameras == "nuscenes"
    num_points = num_points or (65_536 if nusc else 32_768)
    lo = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[:3], np.float32)
    hi = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE[3:], np.float32)
    names = list(cfg.CLASS_NAMES)
    ground = GROUND_Z[cameras]
    width = 10 if nusc else 8
    h, w = image_size
    out = []
    for _ in range(num_batches):
        pts = np.zeros((batch_size, num_points, 5 if nusc else 4), np.float32)
        gt = np.zeros((batch_size, num_boxes[1], width), np.float32)
        gt_valid = np.zeros((batch_size, num_boxes[1]), bool)
        depth = np.zeros((batch_size, n_cam, h, w), np.float32)
        for i in range(batch_size):
            m = rng.randint(num_boxes[0], num_boxes[1] + 1)
            cls = rng.randint(0, len(names), m)
            dims = np.array([CAMERA_CLASS_DIMS[names[c]] for c in cls], np.float32)
            dims *= rng.uniform(0.9, 1.1, dims.shape).astype(np.float32)
            ctr = rng.uniform(lo[:2] * 0.9 + hi[:2] * 0.1, hi[:2] * 0.9 + lo[:2] * 0.1,
                              (m, 2)).astype(np.float32)
            yaw = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
            up = np.array([0.0, 0.0, ground], np.float32)   # the scene on the road
            frame = _waymo_frame(rng, ctr, dims, yaw, num_points, lo - up, hi - up)
            frame[:, 2] += ground
            gt[i, :m, :2] = ctr
            gt[i, :m, 2] = ground + dims[:, 2] / 2
            gt[i, :m, 3:6] = dims
            gt[i, :m, 6] = yaw
            if nusc:
                gt[i, :m, 7:9] = rng.uniform(-5, 5, (m, 2))
            gt[i, :m, -1] = cls + 1.0
            gt_valid[i, :m] = True
            pts[i, :, :3] = frame[:, :3]
            pts[i, :, 3] = frame[:, 3] if not nusc else frame[:, 3] * 255.0
            if nusc:
                pts[i, :, 4] = 0.45 * frame[:, 4]
            depth[i] = project_depth(pts[i], rig[3], rig[4], image_size)
        images = rng.uniform(0, 1, (batch_size, n_cam, h, w, 3)).astype(np.float32)
        per_frame = [np.broadcast_to(a, (batch_size,) + a.shape) for a in rig]
        out.append(MultimodalBatch.from_numpy(pts, np.ones((batch_size, num_points), bool), gt,
                                              gt_valid, images, *per_frame, depth))
    return out


# the configs derived from shipped ones: each loads its shipped file and sets
# only the keys `option_cfg` lists, so that the model options and the legacy
# compact schemas that no shipped config sets are built and run
OPTION_CFGS = {
    "centerpoint_options": "nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml",
    "second_iou_height": "kitti_models/second.yaml",
    "voxel_rcnn_compact": "kitti_models/voxel_rcnn.yaml",
    "pv_rcnn_compact": "kitti_models/pv_rcnn.yaml",
    "pv_rcnn_plusplus_compact": "kitti_models/pv_rcnn_plusplus.yaml",
    "parta2_compact": "kitti_models/PartA2.yaml",
    "voxelnext_compact": "nuscenes_models/cbgs_voxel0075_voxelnext.yaml",
    "second_column": "kitti_models/second.yaml",
}


def option_cfg(name: str):
    """The derived config `name` (OPTION_CFGS): the shipped file, then only
    these keys set.

    centerpoint_options: BACKBONE_2D.NAME BaseBEVResBackbone (its other keys
      kept); HEAD_DICT center num_conv 3 (the other branches and NUM_HM_CONV
      stay 2, so the towers are per-tower); both NMS_CONFIGs NMS_TYPE
      circle_nms, NMS_THRESH 1.0.
    second_iou_height: DENSE_HEAD.USE_IOU_HEAD true;
      TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT true.
    voxel_rcnn_compact: ROI_GRID_POOL replaced by GRID_SIZE 6, POOL_STAGES
      [1, 2, 3], POOL_RADII [0.4, 0.8, 1.6], GRID_MLP [32, 32], GRID_NSAMPLE 16.
    pv_rcnn_compact: ROI_GRID_POOL replaced by GRID_SIZE 6, GRID_RADIUS 0.8,
      GRID_MLP [64, 64].
    pv_rcnn_plusplus_compact: ROI_GRID_POOL replaced by GRID_SIZE 6,
      GRID_RADIUS 0.8, VP_BINS [2, 2, 2], GRID_MLP [64, 64].
    parta2_compact: ROI_AWARE_POOL replaced by GRID_SIZE 12, NUM_FEATURES 128.
    voxelnext_compact: BACKBONE_3D VoxelBackBone8x with CHANNELS
      [16, 16, 32, 64, 64], OUT_CHANNELS 128; DENSE_HEAD.NUM_SHARED_BLOCKS 2.
    second_column: BACKBONE_3D.FORMULATION column (ColumnVoxelBackBone8x,
      the same parameters as the gather form).

    The shipped files name their base configs from tools/, so this reads
    them from there whatever the working directory."""
    import os

    cwd = os.getcwd()
    os.chdir(CFGS.parent)
    try:
        cfg = cfg_from_yaml_file(CFGS / OPTION_CFGS[name], CfgDict())
    finally:
        os.chdir(cwd)
    m = cfg.MODEL
    if name == "centerpoint_options":
        m.BACKBONE_2D.NAME = "BaseBEVResBackbone"
        m.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT["center"]["num_conv"] = 3
        for nms in (m.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG, m.POST_PROCESSING.NMS_CONFIG):
            nms.NMS_TYPE, nms.NMS_THRESH = "circle_nms", 1.0
    elif name == "second_iou_height":
        m.DENSE_HEAD.USE_IOU_HEAD = True
        m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT = True
    elif name == "voxel_rcnn_compact":
        del m.ROI_HEAD["ROI_GRID_POOL"]
        m.ROI_HEAD.update(GRID_SIZE=6, POOL_STAGES=[1, 2, 3], POOL_RADII=[0.4, 0.8, 1.6],
                          GRID_MLP=[32, 32], GRID_NSAMPLE=16)
    elif name == "pv_rcnn_compact":
        del m.ROI_HEAD["ROI_GRID_POOL"]
        m.ROI_HEAD.update(GRID_SIZE=6, GRID_RADIUS=0.8, GRID_MLP=[64, 64])
    elif name == "pv_rcnn_plusplus_compact":
        del m.ROI_HEAD["ROI_GRID_POOL"]
        m.ROI_HEAD.update(GRID_SIZE=6, GRID_RADIUS=0.8, VP_BINS=[2, 2, 2], GRID_MLP=[64, 64])
    elif name == "parta2_compact":
        del m.ROI_HEAD["ROI_AWARE_POOL"]
        m.ROI_HEAD.update(GRID_SIZE=12, NUM_FEATURES=128)
    elif name == "voxelnext_compact":
        m.BACKBONE_3D = CfgDict({"NAME": "VoxelBackBone8x", "CHANNELS": [16, 16, 32, 64, 64],
                                 "OUT_CHANNELS": 128})
        m.DENSE_HEAD.NUM_SHARED_BLOCKS = 2
    elif name == "second_column":
        m.BACKBONE_3D.FORMULATION = "column"
    return cfg


def _option_detector(name, device, train):
    from .tools.common import build_model, model_grid

    cfg = option_cfg(name)
    model = build_model(cfg, "train" if train else "test", device, train=train)
    return cfg, model_grid(cfg), model


def centerpoint_options(train: bool = False, device="cuda"):
    """Voxel CenterPoint on `option_cfg("centerpoint_options")`: the
    nuScenes VoxelResBackBone8x trunk, BaseBEVResBackbone, per-tower
    SeparateHeads (a 3-conv center branch) and circle NMS, built as the
    CLIs build it (tools.common.build_model). Returns (cfg, grid, model), in
    eval mode or in train mode with `train`; the weights are PyTorch's
    defaults."""
    return _option_detector("centerpoint_options", device, train)


def second_iou_height(train: bool = False, device="cuda"):
    """SECONDNet on `option_cfg("second_iou_height")`: KITTI second.yaml with
    the IoU head (its L1 loss, the rectified score) and MATCH_HEIGHT's 3D
    IoU target assignment; as `centerpoint_options`."""
    return _option_detector("second_iou_height", device, train)


def voxel_rcnn_compact(train: bool = False, device="cuda"):
    """VoxelRCNN on voxel_rcnn.yaml with the legacy compact RoI schema; as
    `centerpoint_options`."""
    return _option_detector("voxel_rcnn_compact", device, train)


def pv_rcnn_compact(train: bool = False, device="cuda"):
    """PVRCNN on pv_rcnn.yaml with the legacy compact RoI schema; as
    `centerpoint_options`."""
    return _option_detector("pv_rcnn_compact", device, train)


def pv_rcnn_plusplus_compact(train: bool = False, device="cuda"):
    """PVRCNNPlusPlus on pv_rcnn_plusplus.yaml with the legacy compact RoI
    schema (one vector pool of 2 x 2 x 2 bins); as `centerpoint_options`."""
    return _option_detector("pv_rcnn_plusplus_compact", device, train)


def parta2_compact(train: bool = False, device="cuda"):
    """PartA2Net on PartA2.yaml with the legacy compact RoI schema; as
    `centerpoint_options`."""
    return _option_detector("parta2_compact", device, train)


def voxelnext_compact(train: bool = False, device="cuda"):
    """VoxelNeXt on cbgs_voxel0075_voxelnext.yaml with the compact trunk
    (VoxelBackBone8x, two plain downs, two BEV blocks); as
    `centerpoint_options`."""
    return _option_detector("voxelnext_compact", device, train)


def second_column(train: bool = False, device="cuda"):
    """SECONDNet on `option_cfg("second_column")`: KITTI second.yaml (1408 x
    1600 x 40, 16,000 / 40,000 voxels for train / test, AnchorHeadSingle over
    3 classes) with its VoxelBackBone8x in the column formulation; as
    `centerpoint_options`."""
    return _option_detector("second_column", device, train)
