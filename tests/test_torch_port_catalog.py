"""Every shipped model config through the port's CLI builder, on the CPU:
`tools.common.build_model` (what tools.train and tools.test call) builds
each tools/cfgs/*_models/*.yaml at its published widths in test mode, or
raises NotImplementedError naming the piece the port lacks; nothing else
may be raised; no sparse conv of a model built is named q, k or v (the
names `params_from_jax` reads as DSVT's attention projections). And the
PointPillar configs' voxel cap: the CLIs pass
MAX_NUMBER_OF_VOXELS, which PointPillar accepts and does not read (the JAX
package's PointPillar keeps its VFE's pillar cap, 32,768 per frame summed
over the batch).
"""
from pathlib import Path

import pytest

from dfu3d_tpu_torch.data.point_feature_encoder import PointFeatureEncoder
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.tools.common import build_model, model_grid
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
