"""Every shipped model config through the port's CLI builder, on the CPU:
`tools.common.build_model` (what tools.train and tools.test call) builds
each tools/cfgs/*_models/*.yaml at its published widths in test mode, or
raises NotImplementedError naming the piece the port lacks; nothing else
may be raised; no sparse conv of a model built is named q, k or v (the
names `params_from_jax` reads as DSVT's attention projections). And the
PointPillar configs' voxel cap: the CLIs pass
MAX_NUMBER_OF_VOXELS, which PointPillar accepts and does not read (the JAX
package's PointPillar keeps its VFE's pillar cap, 32,768 per frame summed
over the batch). And the seven configs derived from shipped ones
(`zoo.option_cfg`: the model options and legacy compact schemas that no
shipped config sets) build in both packages: the port's as the CLIs build
them, the JAX package's through its modules' setup (bound to no variables,
nothing traced), whose submodules, by path and class, the port has too.
(The flax trees of parameter shapes of JAX's full-width inits equal the
port's state_dicts for all seven; tracing those inits takes 5-15 s each,
so the module-level parity tests at test widths hold the shapes instead.)
"""
from pathlib import Path

import pytest
from flax import linen as flax_nn

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch import zoo

from dfu3d_tpu_torch.data.point_feature_encoder import PointFeatureEncoder
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.tools.common import _voxel_processor, build_model, model_grid
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
CONFIGS = sorted(str(p.relative_to(TOOLS)) for p in TOOLS.glob("cfgs/*_models/*.yaml"))
# the configs the port cannot build yet, and the words of what it raises
NOT_PORTED = {
    "cfgs/waymo_models/pv_rcnn_plusplus_resnet.yaml":
        "BACKBONE_3D VoxelResBackBone8x with PVRCNNPlusPlus",
    "cfgs/waymo_models/pv_rcnn_plusplus_resnet_2frames.yaml":
        "BACKBONE_3D VoxelResBackBone8x with PVRCNNPlusPlus",
}
POINTPILLAR = ("cfgs/kitti_models/pointpillar.yaml", "cfgs/kitti_models/pointpillar_newaugs.yaml",
               "cfgs/kitti_models/pointpillar_ori.yaml",
               "cfgs/kitti_models/pointpillar_pyramid_aug.yaml",
               "cfgs/waymo_models/pointpillar_1x.yaml")


def test_the_catalog():
    assert len(CONFIGS) == 67 and set(NOT_PORTED) <= set(CONFIGS)
    assert "cfgs/nuscenes_models/transfusion_lidar.yaml" in CONFIGS
    assert set(POINTPILLAR) <= set(CONFIGS) - set(NOT_PORTED)


@pytest.mark.parametrize("cfg_file", CONFIGS)
def test_shipped_config_builds(cfg_file, monkeypatch):
    monkeypatch.chdir(TOOLS)   # the configs name their base configs from here
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    if cfg_file in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=NOT_PORTED[cfg_file]):
            build_model(cfg, "test", "cpu")
        return
    model = build_model(cfg, "test", "cpu")
    assert not model.training and sum(p.numel() for p in model.parameters()) > 0
    # params_from_jax reads a 3-D kernel of a module named q, k or v as an
    # attention projection's (DSVT's): no sparse conv may carry such a name
    assert not [k for k in model.state_dict() if k.endswith((".q.kernel", ".k.kernel",
                                                             ".v.kernel"))]


@pytest.mark.parametrize("cfg_file", POINTPILLAR)
def test_pointpillar_voxel_cap_is_not_read(cfg_file, monkeypatch):
    """build_model (with the config's MAX_NUMBER_OF_VOXELS) gives the model
    build_network gives without it: the pillar cap 32,768 and the same
    state_dict keys and shapes."""
    monkeypatch.chdir(TOOLS)
    cfg = cfg_from_yaml_file(cfg_file, CfgDict())
    (vox,) = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
              if p.NAME.startswith("transform_points_to_voxels")]
    assert vox.MAX_NUMBER_OF_VOXELS
    model = build_model(cfg, "train", "cpu")
    features = PointFeatureEncoder(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING).num_point_features
    plain = build_network(cfg.MODEL, cfg.CLASS_NAMES, model_grid(cfg), device="cpu",
                          num_point_features=features)
    assert type(model).__name__ == "PointPillar"
    assert model.vfe.max_pillars == plain.vfe.max_pillars == 32768
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in plain.state_dict().items()}


def setup_tree(module, prefix=""):
    """The flax submodules that `module`'s setup builds, and theirs, by dotted
    path: {path: class name} (nn.compact modules build theirs only when
    called)."""
    module._try_setup()
    out = {}
    for value in list(vars(module).values()):
        for sub in value if isinstance(value, (list, tuple)) else [value]:
            if isinstance(sub, flax_nn.Module) and sub.name and sub.parent is module:
                path = prefix + sub.name
                out[path] = type(sub).__name__
                out.update(setup_tree(sub, path + "."))
    return out


@pytest.mark.parametrize("name", sorted(zoo.OPTION_CFGS))
def test_derived_config_builds_in_both_packages(name):
    cfg = zoo.option_cfg(name)
    _, grid, model = getattr(zoo, name)(device="cpu")
    vox = _voxel_processor(cfg)
    jmodel = j_build_network(JCfgDict(cfg.MODEL), cfg.CLASS_NAMES,
                             JVoxelGrid.create(grid.point_cloud_range, grid.voxel_size),
                             max_voxels=int(vox.MAX_NUMBER_OF_VOXELS["test"]))
    want = setup_tree(jmodel.bind({}))
    got = {k: type(m).__name__ for k, m in model.named_modules()}
    assert len(want) >= 3 and set(want) <= set(got)
    # flax's layers and torch's of the same name in the flax tree
    renamed = {"Dense": "Linear", "Conv": "Conv2d", "Sequential": "ModuleDict"}
    assert {k: renamed.get(v, v) for k, v in want.items()} == {k: got[k] for k in want}
