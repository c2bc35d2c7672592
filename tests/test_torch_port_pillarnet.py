"""Port parity: PillarNet's modules and serving against the JAX package, on
the CPU, fp32 on both sides, from the same numpy inputs and weights (flax
layout, carried across by `params_from_jax`):

* DynPillarVFESimple2D in train mode (BN over every point of the batch):
  pillar features within 1e-5, coordinates and masks exactly equal, the BN
  statistics within 1e-6;
* BaseBEVBackboneV1 in train mode within 1e-5, and a reference-format
  BaseBEVBackboneV1 state carried by `bev_v1_backbone_mapping` equal to the
  same state through the JAX package's mapping and `params_from_jax`;
* `predict` of both detectors (tests/test_zoo_variants.py::test_pillarnet's
  CenterHead config with MeanVFE and PillarRes18BackBone8x; an
  AnchorHeadSingle one with DynamicPillarVFESimple2D and PillarBackBone8x):
  keep masks and labels equal, boxes and scores within 1e-4;
* the flax tree of JAX's init equals the port's state_dict leaf for leaf;
* every shipped VoxelNeXt and PillarNet config builds through
  `build_network` on the CPU as the CLIs build it.

The train steps are in tests/test_torch_port_pillarnet_train.py.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.models import backbone_2d as jb2d
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import pillarnet as jpn
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models.backbone_2d import BaseBEVBackboneV1
from dfu3d_tpu_torch.models.pillarnet import DynPillarVFESimple2D
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import CLASS_NAMES, make_batch, tiny_model_cfg
from test_pointpillar import pp_model_cfg
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PILLAR_RANGE, PILLAR_SIZE = [0, -6.4, -3, 6.4, 6.4, 1], [0.1, 0.1, 4.0]   # 64 x 128 x 1
MAX_VOXELS = 512
V1 = {"NAME": "BaseBEVBackboneV1", "LAYER_NUMS": [2, 2], "LAYER_STRIDES": [1, 2],
      "NUM_FILTERS": [16, 16], "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [8, 8]}


def t(a):
    return torch.from_numpy(np.array(a))


def center_cfg():
    """tests/test_zoo_variants.py::test_pillarnet's config (CenterHead,
    MeanVFE, PillarRes18BackBone8x), its neck's upsample filters at 8 + 8
    so that NUM_FILTERS[0] = their sum, as BaseBEVBackboneV1 requires."""
    cfg = tiny_model_cfg()
    cfg["NAME"] = "PillarNet"
    cfg["VFE"] = {"NAME": "MeanVFE"}
    cfg["BACKBONE_3D"] = {"NAME": "PillarRes18BackBone8x", "CHANNELS": [8, 8, 16, 16, 16],
                          "OUT_CHANNELS": 16, "CONV5_CHANNELS": 16}
    cfg["BACKBONE_2D"] = dict(V1)
    cfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["FEATURE_MAP_STRIDE"] = 8
    return cfg


def anchor_cfg():
    """tests/test_pointpillar.py's AnchorHeadSingle config on the kitti
    PillarNet trunk: DynamicPillarVFESimple2D, PillarBackBone8x, the conv5
    stage, BaseBEVBackboneV1; anchors at the neck's stride 8."""
    cfg = pp_model_cfg()
    cfg["NAME"] = "PillarNet"
    cfg["VFE"] = {"NAME": "DynamicPillarVFESimple2D", "WITH_DISTANCE": False,
                  "USE_ABSLOTE_XYZ": True, "USE_NORM": True, "NUM_FILTERS": [16]}
    cfg["BACKBONE_3D"] = {"NAME": "PillarBackBone8x", "CHANNELS": [8, 8, 16, 16, 32],
                          "OUT_CHANNELS": 16, "CONV5_CHANNELS": 16}
    cfg["BACKBONE_2D"] = dict(V1)
    for a in cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]:
        a["feature_map_stride"] = 8
    return cfg


MODELS = {"anchor": anchor_cfg, "center": center_cfg}
# the heads' output convs at 0.1 of He-normal: logits O(1)
GAINS = {"dense_head/conv_box/kernel": 0.1, "dense_head/conv_cls/kernel": 0.1}


def pair(name, seed=1, train=False):
    """(JAX model, flax variables, port model with those weights)."""
    jcfg = MODELS[name]()
    jgrid = JVoxelGrid.create(PILLAR_RANGE, PILLAR_SIZE)
    jmodel = j_build_network(jcfg, CLASS_NAMES, jgrid, max_voxels=MAX_VOXELS)
    model = build_network(CfgDict(jcfg), CLASS_NAMES, VoxelGrid.create(PILLAR_RANGE, PILLAR_SIZE),
                          device="cpu", train=train, max_voxels=MAX_VOXELS)
    variables = numpy_variables(lambda: flax_variables_like(model), seed=seed, gains=GAINS)
    params_from_jax(variables, model)
    return jmodel, variables, model


def port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


def pillar_batch(seed, b=2, n=512):
    """make_batch's points, of which some fall outside the range and some
    share a pillar."""
    return make_batch(np.random.RandomState(seed), b=b, n=n)


def test_dyn_pillar_vfe_simple2d_matches_jax():
    jgrid = JVoxelGrid.create(PILLAR_RANGE, PILLAR_SIZE)
    jvfe = jpn.DynPillarVFESimple2D(num_filters=(16,), grid=jgrid, max_pillars=MAX_VOXELS)
    port = DynPillarVFESimple2D((16,), VoxelGrid.create(PILLAR_RANGE, PILLAR_SIZE),
                                max_pillars=MAX_VOXELS).train()
    variables = numpy_variables(lambda: flax_variables_like(port), seed=3)
    params_from_jax(variables, port)
    batch = pillar_batch(5, n=700)
    (wf, wc, wv), upd = jax.jit(lambda v, p, pv: jvfe.apply(
        v, p, pv, True, mutable=["batch_stats"]))(variables, batch.points, batch.points_valid)
    feats, vox = port(t(batch.points), t(batch.points_valid))
    np.testing.assert_array_equal(vox.voxel_coords.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(vox.voxel_valid.numpy(), np.asarray(wv))
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(wf), atol=1e-5)
    assert np.asarray(wv).sum() > 200 and np.abs(np.asarray(wf)).max() > 0.5
    stats = params_from_jax({"batch_stats": jax.device_get(upd["batch_stats"])})
    own = port.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_bev_v1_backbone_matches_jax():
    """Train mode on a stride-8 map of 24 channels and a stride-16 one of 16:
    the output within 1e-5, the BN statistics within 1e-5."""
    jmod = jb2d.BaseBEVBackboneV1(layer_nums=(2, 1), num_filters=(16, 24),
                                  upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    port = BaseBEVBackboneV1((24, 16), (2, 1), (16, 24), (1, 2), (8, 8)).train()
    variables = numpy_variables(lambda: flax_variables_like(port), seed=4)
    params_from_jax(variables, port)
    rng = np.random.RandomState(6)
    x4 = rng.normal(0, 1, (2, 8, 12, 24)).astype(np.float32)
    x5 = rng.normal(0, 1, (2, 4, 6, 16)).astype(np.float32)
    want, upd = jax.jit(lambda v, a, b: jmod.apply(v, [a, b], True, mutable=["batch_stats"]))(
        variables, x4, x5)
    got = port([t(x4), t(x5)])
    assert got.shape == (2, 8, 12, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    stats = params_from_jax({"batch_stats": jax.device_get(upd["batch_stats"])})
    own = port.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(own[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_bev_v1_mapping_round_trip():
    """A reference-format BaseBEVBackboneV1 state (blocks.{i}.{1, 4, 7, ...}
    convs and BNs, deblocks.{i}.{0, 1}) through the JAX package's
    bev_v1_backbone_mapping into flax variables and `params_from_jax` equals
    the same state through the port's mapping; both PillarNet detectors'
    `reference_mapping` then covers every key of their pillar VFE, neck and
    head, and none of the sparse pyramid or the conv5 stage, which the JAX
    package leaves unmapped."""
    port = BaseBEVBackboneV1((24, 16), (2, 1), (16, 24), (1, 2), (8, 8))
    variables = numpy_variables(lambda: flax_variables_like(port), seed=0)
    rng = np.random.RandomState(8)
    mapping = torch_convert.bev_v1_backbone_mapping((2, 1))
    own = {f"backbone_2d.{k}": v for k, v in port.state_dict().items()}
    ref = {}
    for ours, (ref_key, _) in mapping.items():
        if ours in own:
            ref[ref_key] = rng.normal(0, 1, tuple(own[ours].shape)).astype(np.float32)
    wrapped = {"params": {"backbone_2d": variables["params"]},
               "batch_stats": {"backbone_2d": variables["batch_stats"]}}
    new, report = jtc.apply_mapping(wrapped, ref, jtc.bev_v1_backbone_mapping((2, 1)))
    assert not report["missing_in_torch"] and not report["unmatched_ours"]
    via_jax = params_from_jax({"params": new["params"]["backbone_2d"],
                               "batch_stats": new["batch_stats"]["backbone_2d"]})
    got, preport = torch_convert.apply_mapping(own, {k: t(v) for k, v in ref.items()}, mapping)
    assert not preport["missing_in_torch"] and not preport["unmatched_ours"]
    assert set(via_jax) == set(port.state_dict())
    for k, v in via_jax.items():
        np.testing.assert_array_equal(got[f"backbone_2d.{k}"].numpy(), v.numpy(), err_msg=k)
    for name in MODELS:
        _, _, model = pair(name)
        m = model.reference_mapping()
        keys = model.state_dict()
        unmapped = {k.split(".")[0] for k in keys if k not in m}
        assert unmapped == {"backbone_3d", "conv5_down", "conv5_a", "conv5_b"}, (name, unmapped)
        assert any(k.startswith("backbone_2d.") for k in m)
        assert any(k.startswith("vfe.") for k in m if k in keys) == (name == "anchor")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_matches_jax(name):
    """The decode end to end from points through the sparse pillar pyramid
    (18 of 27 taps never live), the conv5 stage and the V1 neck, then the
    anchor or center decode and rotated NMS (B1's twin): keep masks and
    labels equal, boxes and scores within 1e-4."""
    jmodel, variables, model = pair(name, seed=4)
    jbatch = pillar_batch(3)
    want = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, method=lambda m, bb: m.predict(bb)))(variables, jbatch))
    with torch.no_grad():
        got = model.eval().predict(port_batch(jbatch))
    boxes, scores, labels, keep = (x.numpy() for x in got)
    np.testing.assert_array_equal(keep, np.asarray(want[3]))
    np.testing.assert_array_equal(labels, np.asarray(want[2]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-4)
    assert keep.sum() > 2 and np.isfinite(boxes).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flax_tree_matches_state_dict(name):
    """The flax tree of JAX's PillarNet init has exactly the port
    state_dict's leaves, in flax shapes, so `params_from_jax` carries every
    weight with no key left over."""
    jmodel, _, model = pair(name)
    jbatch = pillar_batch(3, b=1, n=64)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch,
                                                train=False))

    def leaves(tree):
        return {"/".join(k.key for k in p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert leaves(shapes) == leaves(flax_variables_like(model))


SHIPPED = {   # detector, grid, MAX_NUMBER_OF_VOXELS['test'], widest sparse conv
    "nuscenes_models/cbgs_voxel0075_voxelnext": ("VoxelNeXt", (1440, 1440, 40), 160000, 128),
    "nuscenes_models/cbgs_voxel0075_voxelnext_doubleflip": ("VoxelNeXt", (1440, 1440, 40),
                                                            160000, 128),
    "argo2_models/cbgs_voxel01_voxelnext": ("VoxelNeXt", (4096, 4096, 32), 400000, 128),
    "waymo_models/voxelnext_ioubranch_large": ("VoxelNeXt", (1504, 1504, 40), 150000, 256),
    "waymo_models/voxelnext2d_ioubranch": ("VoxelNeXt", (1504, 1504, 1), 150000, 256),
    "kitti_models/pillarnet": ("PillarNetAnchor", (704, 800, 1), 40000, 256),
    "waymo_models/pillarnet": ("PillarNetCenter", (1504, 1504, 1), 150000, 256),
}


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_configs_build(name, monkeypatch):
    """Each config through tools.common.build_model on the CPU in test mode
    (the grid of its range and voxel size, MAX_NUMBER_OF_VOXELS['test'],
    the dataset's point features): the detector class of its MODEL and
    DENSE_HEAD names at its published widths."""
    from dfu3d_tpu_torch.tools.common import build_model, model_grid
    from dfu3d_tpu_torch.utils.config import cfg_from_yaml_file

    monkeypatch.chdir(REPO / "tools")
    cfg = cfg_from_yaml_file(f"cfgs/{name}.yaml", CfgDict())
    model = build_model(cfg, "test", "cpu")
    cls, grid_size, max_voxels, width = SHIPPED[name]
    assert type(model).__name__ == cls and not model.training
    assert tuple(model_grid(cfg).grid_size) == grid_size
    cap = getattr(model.vfe, "max_voxels", None) or model.vfe.max_pillars
    assert cap == max_voxels
    kernels = [v for k, v in model.state_dict().items() if k.endswith(".kernel")]
    assert max(k.shape[-1] for k in kernels) == width
