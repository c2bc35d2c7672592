"""Port parity for training the two-stage voxel detectors (SECONDNetIoU,
VoxelRCNN, PVRCNN) against the JAX package, on the CPU, fp32 on both sides,
at the test-scale configs of tests/test_torch_port_two_stage.py:

* one `make_train_step` of each model (the KITTI configs' adam_onecycle,
  clip 10) against the JAX package's, the sampler's uniforms and every
  dropout mask JAX draws handed over (its key read by a debug callback in a
  wrapper of `assign_roi_targets`, its bernoulli masks by one in flax's
  Dropout): the sampled RoIs exactly equal, with RoIs over REG_FG_THRESH in
  every frame (`zoo.proposal_gt`'s 4 gt per frame, made of the port's own
  first-stage boxes); the metrics within 1e-5 relative; every gradient leaf
  within 1e-4 of its largest entry and nonzero (the RoI head's reg branch
  included); the parameters after the step within 1e-5 where the two
  gradients agree to 2 % (Adam's first step moves an entry by about ±lr
  whatever its gradient's size); the BN running statistics within 1e-5;

PV-RCNN's step is in tests/test_torch_port_two_stage_cli.py, so that
each file runs in under two minutes on one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import make_batch
from test_torch_port_pointrcnn_train import CaptureTargets, capture_port_targets, jax_draws
from test_torch_port_train_slice import recording
from test_torch_port_two_stage import DropoutMasks, pair, port_batch
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

TOTAL_STEPS = 100
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
KITTI_OPTIM = yaml.safe_load((zoo.KITTI_CFGS / "voxel_rcnn.yaml").read_text())["OPTIMIZATION"]
# the RoI head's reg branch of each model (SECOND-IoU has only its IoU branch)
REG_BRANCH = {"second_iou": ("iou_fc.",), "voxel_rcnn": ("reg_fc.", "reg_pred."),
              "pv_rcnn": ("reg_fc.",)}


@pytest.mark.parametrize("name", ["second_iou", "voxel_rcnn"])
def test_train_step_matches_jax(name, monkeypatch):
    check_train_step(name, monkeypatch)


def check_train_step(name, monkeypatch):
    jmodel, variables, model, _ = pair(name, seed=2, train=True)
    # a dropout after every block of a stack but the last (shared_fc_stack)
    # or after its first (make_fc_stack): one mask per stack of two blocks
    check_model_train_step(jmodel, variables, model, REG_BRANCH[name],
                           {"second_iou": 2, "voxel_rcnn": 1, "pv_rcnn": 3}[name], monkeypatch)


def check_model_train_step(jmodel, variables, model, reg_branch, num_masks, monkeypatch):
    """One train step of `model` against JAX's on `jmodel` with `variables`
    (see the module docstring); `reg_branch` names the RoI head's regression
    leaves, `num_masks` the dropout masks JAX draws."""
    batch = zoo.proposal_gt(model, port_batch(make_batch(np.random.RandomState(7), b=2, n=512)),
                            count=4)
    jbatch = JPointBatch(*(np.asarray(x) for x in batch))
    capture = CaptureTargets(monkeypatch)
    masks = DropoutMasks(monkeypatch)
    tx, _ = j_build_optimizer(CfgDict(KITTI_OPTIM), TOTAL_STEPS)
    tx = recording(tx)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(state, jbatch))
    seen = capture.seen
    assert (seen["reg_valid_mask"].sum(1) > 0).all()
    assert len(masks.masks) == num_masks

    draws = jax_draws(seen["key"], 2, model.train_proposal_nms["post_max"])
    monkeypatch.setattr(proi, "draw_roi_uniforms", lambda gen, shape, device: draws)
    left = masks.hand_over(monkeypatch)
    ported = capture_port_targets(monkeypatch)
    tstate = create_train_state(model, CfgDict(KITTI_OPTIM), TOTAL_STEPS)
    raw, opt_step = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return opt_step()

    tstate.optimizer.step = snapshot
    metrics = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)(batch)
    assert not left
    np.testing.assert_array_equal(ported["sampled_idx"].numpy(), seen["sampled_idx"])
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=LOSS_TOL, atol=1e-7,
                                   err_msg=k)
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    assert set(raw) == set(jgrads)
    for k, w in jgrads.items():
        w = w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(raw[k].numpy(), w, rtol=0, atol=GRAD_TOL * scale, err_msg=k)
    assert any(k.startswith(reg_branch) for k in raw)
    assert all(raw[k].abs().max() > 0 for k in raw if k.startswith(reg_branch))
    want = params_from_jax({"params": new_state.params})
    lr0 = tstate.optimizer.lr_fn(0)
    for k, p in model.named_parameters():
        got, w = p.detach().numpy(), want[k].numpy()
        g, wg = raw[k].numpy(), jgrads[k].numpy()
        sure = np.abs(g - wg) <= 0.02 * np.abs(wg)
        tol = PARAM_TOL * (1 + np.abs(w).max())
        np.testing.assert_allclose(got[sure], w[sure], rtol=0, atol=tol, err_msg=k)
        assert (np.abs(got - w)[~sure] <= 2 * lr0 + tol).all(), k
    jstats = params_from_jax({"batch_stats": new_state.batch_stats})
    old = params_from_jax({"batch_stats": variables["batch_stats"]})
    buffers, modules = dict(model.named_buffers()), dict(model.named_modules())
    for k, w in jstats.items():
        module, leaf = k.rsplit(".", 1)
        keep = modules[module].keep
        w = w.numpy()
        tol = 1e-5 * (1 + np.abs(w))
        if leaf == "running_var":
            mean_b = (jstats[f"{module}.running_mean"].numpy()
                      - keep * old[f"{module}.running_mean"].numpy()) / (1 - keep)
            tol = 1e-5 * (np.abs(w) + (1 - keep) * mean_b ** 2 + 1e-3)
        assert (np.abs(buffers[k].numpy() - w) <= tol).all(), (k, np.abs(buffers[k] - w).max())
