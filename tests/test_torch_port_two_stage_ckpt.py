"""Port parity: the two-stage voxel detectors' (SECONDNetIoU, VoxelRCNN,
PVRCNN) checkpoints and the shipped configs of those and of PartA2Net and
PVRCNNPlusPlus, on the CPU:

* each detector's reference checkpoint mapping against the JAX package's
  head and anchor-head mappings, and a save / load round trip;
* the shipped KITTI configs built at full width (parameter counts, voxel
  caps) and the parts that stay out of scope raising.
"""
import numpy as np
import pytest
import torch

from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.tools.common import build_model
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_model import CLASS_NAMES, make_batch
from test_parta2 import pa2_cfg, pa2_grid
from test_pvrcnn import pv_cfg, pv_grid
from test_torch_port_two_stage import MODELS, pair, port_batch, voxel_rcnn_cfg
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)


def jax_head_mapping(name):
    """The JAX package's mappings of the model's heads at its widths."""
    m = jtc.anchor_head_mapping()
    if name == "second_iou":
        m.update(jtc.second_head_mapping(shared_fc=(32, 32), iou_fc=(16,)))
    elif name == "voxel_rcnn":
        m.update(jtc.voxelrcnn_head_mapping(shared_fc=(32, 32), cls_fc=(16,), reg_fc=(16,)))
    else:
        m.update(jtc.pvrcnn_head_mapping(shared_fc=(32, 32), cls_fc=(16,), reg_fc=(16,)))
    return m


def reference_state(model, seed=0):
    """A reference-keyed state for `model`'s reference mapping: Conv1d
    weights (out, in, 1) in the RoI heads, the rest as the port holds them;
    N(0, 0.05) draws, running variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    own = model.state_dict()
    state = {}
    for ours, (ref, _) in model.reference_mapping().items():
        if ours not in own:
            continue
        shape = tuple(own[ours].shape)
        if ref.startswith("roi_head.") and ref.endswith("weight") and len(shape) == 2:
            shape += (1,)
        if len(shape) == 5:   # a Conv3d (O, I, kx, ky, kz) from spconv 2.x's (O, kz, ky, kx, I)
            shape = (shape[0], shape[4], shape[3], shape[2], shape[1])
        w = (rng.uniform(0.5, 1.5, shape) if ref.endswith("running_var")
             else rng.normal(0, 0.05, shape))
        state[ref] = torch.from_numpy(w.astype(np.float32))
    return state


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_mapping_matches_jax(name, tmp_path):
    """Every key the JAX package's head and anchor-head mappings fill equals
    the port's after `load_reference_state`; the port's mapping also fills
    the 2D backbone, and leaves exactly the sparse backbone (and PV-RCNN's
    VSA) unmatched. A save / load round trip keeps predict's outputs."""
    jmodel, variables, model, _ = pair(name, seed=3)
    trunk = ("backbone_3d.",) if name == "second_iou" else ("encoder.", "sa_", "vsa_fusion.",
                                                             "kp_seg.")
    cfg_fn, grid_fn = MODELS[name]
    check_reference_mapping(variables, model, jax_head_mapping(name), trunk, cfg_fn(),
                            grid_fn(), tmp_path)


def check_reference_mapping(variables, model, j_mapping, trunk, jcfg, jgrid, tmp_path):
    """`model` (with the weights of `variables`) after `load_reference_state`
    of a synthetic reference state equals the JAX package's `apply_mapping`
    of `j_mapping` on every key JAX fills; the keys outside `trunk` change
    and exactly the `trunk` keys stay unmatched; predict is kept by a save
    and a load into a model built anew from `jcfg` on `jgrid`."""
    state = reference_state(model, seed=4)
    assert torch_convert.is_reference_state(state)
    assert not torch_convert.is_reference_state(model.state_dict())
    j_vars, j_report = jtc.apply_mapping(
        variables, {k: v.numpy() for k, v in state.items()}, j_mapping)
    want = params_from_jax(j_vars)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = torch_convert.load_reference_state(model, state)
    got = model.state_dict()
    assert not report["missing_in_torch"] and not j_report["missing_in_torch"]
    jaxed = {".".join([*p[1:-1], {"kernel": "weight", "scale": "weight", "bias": "bias",
                                  "mean": "running_mean", "var": "running_var"}[p[-1]]])
             for p, _ in j_mapping.items()}
    assert jaxed <= set(got)
    for k in jaxed:
        assert torch.equal(got[k], want[k]), k
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {k for k in got if not k.startswith(trunk)}
    assert sorted(report["unmatched_ours"]) == sorted(k for k in got if k.startswith(trunk))
    batch = port_batch(make_batch(np.random.RandomState(4), b=2, n=512))
    with torch.no_grad():
        out = model.predict(batch)
    path = tmp_path / "m.pth"
    torch.save(model.state_dict(), path)
    fresh = build_network(CfgDict(jcfg), CLASS_NAMES,
                          voxel.VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size),
                          device="cpu")
    fresh.load_state_dict(torch.load(path))
    with torch.no_grad():
        again = fresh.predict(batch)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


SHIPPED = {"second_iou": ("SECONDNetIoU", 12_094_473, 6),
           "voxel_rcnn": ("VoxelRCNN", 10_846_908, 2),
           "pv_rcnn": ("PVRCNN", 12_723_921, 6),
           "parta2": ("PartA2Net", 62_846_068, 6),
           "parta2_free": ("PartA2Net", 62_846_068, 6),
           "pv_rcnn_plusplus": ("PVRCNNPlusPlus", 13_353_745, 6)}


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_config_builds_at_full_width(name):
    """zoo's builder builds the KITTI config as the CLIs do: the published
    widths, the 1408 x 1600 x 40 grid, MAX_NUMBER_OF_VOXELS per phase, the
    anchors of the config's classes, eval or train mode; without a card the
    default device raises."""
    cls_name, n_params, anchors_per_loc = SHIPPED[name]
    builder = getattr(zoo, name)
    for train, cap in ((False, 40000), (True, 16000)):
        cfg, grid, model = builder(device="cpu", train=train)
        assert type(model).__name__ == cls_name == cfg.MODEL.NAME
        assert model.training == train
        assert tuple(grid.grid_size) == (1408, 1600, 40)
        assert sum(p.numel() for p in model.parameters()) == n_params
        assert model.vfe.max_voxels == cap
        assert sum(model.per_loc_counts) == anchors_per_loc
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            builder()


@pytest.mark.parametrize("cfg_name", ["voxel_rcnn_focal", "pv_rcnn_plusplus_legacy",
                                      "voxel_rcnn_legacy", "pv_rcnn_legacy", "parta2_legacy"])
def test_out_of_scope_raises(cfg_name):
    """The legacy compact RoI schemas (Voxel R-CNN's, PV-RCNN's, PV-RCNN++'s
    and PartA2's) raised NotImplementedError until they were ported; they build now
    with the JAX package's compact pools (pool_stage1..3, grid_sa, grid_vp,
    PartA2's GRID_SIZE; tests/test_torch_port_compact.py holds each against
    JAX). The focal Voxel R-CNN is ported since the camera slice; what
    stays out of its scope is a batch without images, which raises (its
    USE_IMG conv reads image features)."""
    if cfg_name.endswith("_legacy"):
        pool = "ROI_AWARE_POOL" if cfg_name.startswith("parta2") else "ROI_GRID_POOL"
        cfg = {"voxel": voxel_rcnn_cfg, "parta2": pa2_cfg}.get(cfg_name.split("_")[0], pv_cfg)()
        if cfg_name.startswith("pv_rcnn_plusplus"):
            cfg["NAME"] = "PVRCNNPlusPlus"
        cfg["ROI_HEAD"] = {k: v for k, v in cfg["ROI_HEAD"].items() if k != pool}
        jgrid = pa2_grid() if cfg_name.startswith("parta2") else pv_grid()
        cfg, grid = CfgDict(cfg), voxel.VoxelGrid.create(jgrid.point_cloud_range,
                                                         jgrid.voxel_size)
        model = build_network(cfg, CLASS_NAMES, grid, device="cpu")
        children = {name for name, _ in model.named_children()}
        want = {"voxel_rcnn_legacy": {"pool_stage1", "pool_stage2", "pool_stage3"},
                "pv_rcnn_legacy": {"grid_sa"}, "pv_rcnn_plusplus_legacy": {"grid_vp"},
                "parta2_legacy": {"roi_head"}}[cfg_name]
        assert want <= children
        if cfg_name == "parta2_legacy":
            assert model.roi_head.grid_size == 12   # the compact schema's GRID_SIZE default
        return
    cfg = cfg_from_yaml_file(zoo.KITTI_CFGS / f"{cfg_name}.yaml", CfgDict())
    model = build_model(cfg, "test", "cpu")
    points = np.zeros((1, 64, 4), np.float32)
    points[..., 0] = np.linspace(1.0, 60.0, 64)
    batch = PointBatch.from_numpy(points, np.ones((1, 64), bool), np.zeros((1, 1, 8), np.float32),
                                  np.zeros((1, 1), bool))
    with pytest.raises(TypeError, match="MultimodalBatch"):
        model.predict(batch)
