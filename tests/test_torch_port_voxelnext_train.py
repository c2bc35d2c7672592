"""Port parity: one whole VoxelNeXt train step against the JAX package's
`make_train_step`, on the CPU, fp32 on both sides, at tests/test_voxelnext.py's
config with the IoU branch and voxelnext_ioubranch_large's 5 x 5 x 5 downs
(SPCONV_KERNEL_SIZES [5, 5, 3, 3]), weights from numpy in the flax layout
(BN biases +3 on both sides, as the voxel slice tests: no ReLU input within
rounding of its kink), the nuScenes config's adam_onecycle:

* the loss and its terms (hm_loss, iou_loss, rpn_loss) within 1e-5
  relative;
* every gradient leaf within 1e-4 of its largest entry (of 1e-4 of the
  whole gradient's largest entry where that is larger: a leaf that is 0 in
  exact arithmetic; a conv bias in front of a BN, also 0, of its conv
  weight's, as tests/test_torch_port_train_slice.py holds it), the
  regression and IoU branches' nonzero;
* the BN running statistics as in tests/test_torch_port_anchor.py;
* B2 (through its twin) 32 times forward, the 5 x 5 x 5 downs with 125 taps,
  and 31 times for dX in reverse order.

The JAX package's strided-conv backward reads a columnar transpose table
that assumes taps within ±1 (its 2 x 2 parent window,
sparse_ops.transpose_down_neighbors_column), so for the 5 x 5 x 5 downs it
drops the taps at ±2 and their dX and dW are not the gradient of its own
forward. The JAX reference here differentiates those two convs' forward
(`_gather_gemm`, XLA's own transpose) instead; every other conv keeps the
JAX package's custom backward. The port's transpose table is exact at any
kernel size.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file

from test_model import make_batch
from test_torch_port_anchor import TOTAL_STEPS
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import _shift_bn_biases, recording
from test_torch_port_voxelnext import pair, port_batch

NUSC_CFG = "tools/cfgs/nuscenes_models/cbgs_voxel0075_voxelnext.yaml"
# a leaf whose gradient is 0 in exact arithmetic holds only rounding (a BN
# bias whose uniform shift the next train-mode BN takes out: on PillarNet's
# depth-1 grid the z-only conv_out has one live tap, so res4b.bn2.bias sits
# at 1e-8 on both sides): each leaf is held to 1e-4 of the larger of its
# largest entry and GRAD_FLOOR of the whole gradient's
GRAD_FLOOR = 1e-4
# a conv bias in front of a train-mode BN (CenterHead's, with
# USE_BIAS_BEFORE_NORM) is 0 in exact arithmetic too
BIAS_BEFORE_BN = re.compile(r"dense_head\.(shared_conv\.layers_0|fused_heads\.conv\d+)\.bias$")


def exact_wide_down_backward(monkeypatch):
    """JAX's strided convs with more than 27 taps differentiated through
    their forward (see the module docstring)."""
    orig = jsb.down_gather_gemm

    def exact(feats, valid, nbr, tnbr, kernel):
        if kernel.shape[0] <= 27:
            return orig(feats, valid, nbr, tnbr, kernel)
        return jsb._gather_gemm(feats, valid, nbr, kernel)

    monkeypatch.setattr(jsb, "down_gather_gemm", exact)


def compare_train_step(jmodel, variables, model, jbatch, optim_cfg, zero_biases=BIAS_BEFORE_BN,
                       grad_norm_fp64=False):
    """One JAX train step and one port train step from the same weights;
    asserts the loss terms, every gradient leaf and the BN statistics; a
    bias that `zero_biases` matches has a gradient of 0 in exact arithmetic
    and is held to its weight's largest entry. With `grad_norm_fp64` the
    port's grad_norm is held to the norm of JAX's gradient leaves taken in
    float64 rather than to JAX's fp32 grad_norm (whose sum of squares over
    a large gradient rounds by 1e-5 on its own). Returns (port metrics,
    port raw gradients by state_dict key)."""
    tx, _ = j_build_optimizer(optim_cfg, TOTAL_STEPS)
    tx = recording(tx)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(state, jbatch))
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    jstats = params_from_jax({"batch_stats": new_state.batch_stats})
    old_stats = params_from_jax({"batch_stats": variables["batch_stats"]})

    tstate = create_train_state(model, optim_cfg, TOTAL_STEPS)
    raw, step_fn = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return step_fn()

    tstate.optimizer.step = snapshot
    metrics = make_train_step(model, tstate.optimizer, device="cpu",
                              dtype=torch.float32)(port_batch(jbatch))
    assert set(metrics) == set(jmetrics)
    if grad_norm_fp64:
        jmetrics = dict(jmetrics, grad_norm=np.sqrt(sum(
            float((w.double() ** 2).sum()) for w in jgrads.values())))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert set(raw) == set(jgrads)
    whole = max(float(np.abs(w.numpy()).max()) for w in jgrads.values())
    for k, want in jgrads.items():
        want = want.numpy()
        scale = max(np.abs(want).max(), GRAD_FLOOR * whole)
        if zero_biases.search(k):
            # rounding noise only: held to its conv weight's largest entry,
            # as tests/test_torch_port_train_slice.py holds it
            scale = max(scale, np.abs(jgrads[k[:-len("bias")] + "weight"].numpy()).max())
        np.testing.assert_allclose(raw[k].numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=k)
    buffers, modules = dict(model.named_buffers()), dict(model.named_modules())
    stats = {k: v for k, v in buffers.items() if k.rsplit(".", 1)[-1].startswith("running_")}
    assert set(jstats) == set(stats)
    for k, want in jstats.items():
        module, leaf = k.rsplit(".", 1)
        keep = modules[module].keep
        want = want.numpy()
        tol = 1e-5 * (1 + np.abs(want))
        if leaf == "running_var":
            mean_b = (jstats[f"{module}.running_mean"].numpy()
                      - keep * old_stats[f"{module}.running_mean"].numpy()) / (1 - keep)
            tol = 1e-5 * (np.abs(want) + (1 - keep) * mean_b ** 2)
        assert (np.abs(stats[k].numpy() - want) <= tol).all(), (
            k, np.abs(stats[k].numpy() - want).max())
    return metrics, raw


def test_voxelnext_train_step_matches_jax(monkeypatch):
    def cfg_5x5(cfg):
        cfg["BACKBONE_3D"]["SPCONV_KERNEL_SIZES"] = [5, 5, 3, 3]
        return cfg

    jmodel, variables, model = pair("iou", seed=2, train=True, edit=cfg_5x5)
    variables = _shift_bn_biases(variables)
    params_from_jax(variables, model)
    jbatch = make_batch(np.random.RandomState(7), b=2, n=512)
    exact_wide_down_backward(monkeypatch)
    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(tuple(args[3].shape))
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    optim = cfg_from_yaml_file(NUSC_CFG, CfgDict()).OPTIMIZATION
    metrics, raw = compare_train_step(jmodel, variables, model, jbatch, optim)
    assert set(metrics) == {"loss", "hm_loss", "iou_loss", "rpn_loss", "grad_norm"}
    assert float(metrics["iou_loss"]) > 0
    assert len(calls) == 32 + 31 and [k for k, _, _ in calls[:32]].count(125) == 2
    assert calls[32:] == [(k, co, ci) for k, ci, co in reversed(calls[1:32])]
    for branch in ("center", "center_z", "dim", "rot", "iou", "hm"):
        assert raw[f"head_0.{branch}_out.weight"].abs().max() > 0, branch
