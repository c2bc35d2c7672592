"""Port parity: one whole train step of each anchor detector of
tests/test_torch_port_anchor.py (PointPillar with AnchorHeadSingle,
SECONDNet with AnchorHeadMulti) through `make_train_step` against the JAX
package's, with the nuScenes configs' adam_onecycle: the loss and its terms
within 1e-5 relative, every gradient leaf within 1e-4 of its largest entry,
the BN running statistics as in the train slice test. SECONDNet's BN biases
are shifted by +3 on both sides (ReLU kinks within rounding of 0, as
there). PointPillar's are not: no ReLU input of this step lies at a kink,
and the shift's large post-ReLU means make the next BN's one-pass batch
variance cancel (its gradients then sit 1.0e-4 of their largest entry
apart, 1e-5 without it). The configs, weights and batches are
tests/test_torch_port_anchor.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step

from test_torch_port_anchor import (BN_SHIFT, MODELS, TOTAL_STEPS, _batch, _optim_cfg, _pair,
                                    _port_batch)
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import recording


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_matches_jax(name):
    jmodel, variables, model, _ = _pair(name, seed=2, bn_shift=BN_SHIFT[name])
    jbatch = _batch(7)
    tx, _ = j_build_optimizer(_optim_cfg(), TOTAL_STEPS)
    tx = recording(tx)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(state, jbatch))
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    jstats = params_from_jax({"batch_stats": new_state.batch_stats})
    old_stats = params_from_jax({"batch_stats": variables["batch_stats"]})

    tstate = create_train_state(model, _optim_cfg(), TOTAL_STEPS)
    raw, step_fn = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return step_fn()

    tstate.optimizer.step = snapshot
    metrics = make_train_step(model, tstate.optimizer, device="cpu",
                              dtype=torch.float32)(_port_batch(jbatch))
    assert set(metrics) == set(jmetrics) == {"loss", "rpn_loss", "rpn_loss_cls", "rpn_loss_loc",
                                             "rpn_loss_dir", "grad_norm"}
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert float(jmetrics["rpn_loss_loc"]) > 0  # the batch has positive anchors
    assert set(raw) == set(jgrads)
    for k, want in jgrads.items():
        want = want.numpy()
        scale = np.abs(want).max()
        assert scale > 0, k
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
