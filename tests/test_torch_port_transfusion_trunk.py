"""Port parity: TransFusion-L on the shipped config's trunk (BACKBONE_3D
VoxelResBackBone8x with four CHANNELS) against JAX's own VoxelResBackBone8x
→ height_compression → BaseBEVBackbone → TransFusionHead applied as flax
modules (`ResTrunkTransFusion`: JAX's TransFusion builds VoxelBackBone8x
whatever BACKBONE_3D names), on the CPU, fp32 on both sides, at
tests/test_torch_port_transfusion.py's sizes, with its `compare_model`
checks (predict and loss).
"""
from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.utils.config import CfgDict as JCfgDict

from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_transfusion import (MAX_VOXELS, NAMES3, PCR, VOXEL, ResTrunkTransFusion,
                                         compare_model, model_pair, tf_batch, tf_cfg)


def test_res_trunk_transfusion_matches_jax_modules():
    """The shipped config's trunk (BACKBONE_3D VoxelResBackBone8x with four
    CHANNELS): the port against JAX's VoxelResBackBone8x →
    height_compression → BaseBEVBackbone → TransFusionHead, 3 classes, 16
    proposals (`compare_model`)."""
    cfg = tf_cfg(res_trunk=True)
    jmodel = ResTrunkTransFusion(JCfgDict(cfg), NAMES3, JVoxelGrid.create(PCR, VOXEL),
                                 max_voxels=MAX_VOXELS)
    variables, model = model_pair(cfg, NAMES3, seed=4)
    assert type(model.backbone_3d).__name__ == "VoxelResBackBone8x"
    compare_model(jmodel, variables, model, tf_batch(5, NAMES3))
