"""Builders for the port's other supported models: voxel CenterPoint,
PointRCNN, the nuScenes anchor detectors (SECOND and PointPillar
multi-head) and the two-stage KITTI voxel detectors (SECOND-IoU, Voxel
R-CNN, PV-RCNN, PartA2, PartA2-free, PV-RCNN++).

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
