"""Port parity: one whole train step of each PillarNet detector
(AnchorHeadSingle and CenterHead, tests/test_torch_port_pillarnet.py's
configs) against the JAX package's `make_train_step`, on the CPU, fp32 on
both sides, weights from numpy in the flax layout with the BN biases +3 on
both sides (as the voxel slice tests), the kitti PillarNet config's
adam_onecycle: the loss and its terms within 1e-5 relative, every gradient
leaf within 1e-4 of its largest entry (of 1e-4 of the whole gradient's where
that is larger: the depth-1 grid's res4b.bn2.bias, 0 in exact arithmetic;
test_torch_port_voxelnext_train.GRAD_FLOOR), the BN running statistics as in
tests/test_torch_port_anchor.py; B2 through its twin once per sparse conv
forward and once per dX in reverse order (conv_input's only where its input
needs a gradient).
"""
import pytest

from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_torch_port_pillarnet import pair, pillar_batch
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import _shift_bn_biases
from test_torch_port_voxelnext_train import compare_train_step

KITTI_CFG = "tools/cfgs/kitti_models/pillarnet.yaml"
# sparse convs of the two pyramids: PillarBackBone8x 12, PillarRes18BackBone8x 21
SPARSE_CONVS = {"anchor": 12, "center": 21}
TERMS = {"anchor": {"loss", "rpn_loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                    "grad_norm"},
         "center": {"loss", "rpn_loss", "hm_loss_head_0", "loc_loss_head_0", "hm_loss_head_1",
                    "loc_loss_head_1", "grad_norm"}}


@pytest.mark.parametrize("name", sorted(SPARSE_CONVS))
def test_pillarnet_train_step_matches_jax(name, monkeypatch):
    jmodel, variables, model = pair(name, seed=2, train=True)
    variables = _shift_bn_biases(variables)
    params_from_jax(variables, model)
    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(tuple(args[3].shape))
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    optim = cfg_from_yaml_file(KITTI_CFG, CfgDict()).OPTIMIZATION
    metrics, _ = compare_train_step(jmodel, variables, model, pillar_batch(7), optim)
    assert set(metrics) == TERMS[name]
    # the pillar VFE's features need a gradient (its PFN layer trains), the
    # voxel means do not: conv_input's dX runs only behind the pillar VFE
    n, first = SPARSE_CONVS[name], 0 if name == "anchor" else 1
    assert len(calls) == 2 * n - first
    assert calls[n:] == [(k, co, ci) for k, ci, co in reversed(calls[first:n])]
