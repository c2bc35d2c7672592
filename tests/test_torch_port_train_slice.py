"""Port parity of the whole train step: one step of the flagship
CenterPoint-pillar (full widths, 64 × 128 grid) and of voxel CenterPoint
(full widths, 128 × 128 × 40 grid, a voxel cap of 2048 that binds, 10-column
gt for its vel branch) through `make_train_step` against the JAX package's
`make_train_step` on the same numpy weights and batch, fp32 on both sides,
with the configs' adam_onecycle optimizer (clip 10).

Tolerances: the loss, every per-head loss and the gradient norm within 1e-5
relative; every gradient leaf within 1e-4 of that leaf's largest |entry|
(sums in another order, and JAX runs the grouped packed-row sparse forms
where the port runs the element forms); BN running statistics after the
step within 1e-5, the variances within 1e-5 of var + (1 - keep) · mean_b²
(the batch variance is the one-pass E[x²] - mean_b², whose fp32 rounding
scales with E[x²]). A conv bias in front of a BN has a gradient of exactly
0 in exact arithmetic, so its computed one is rounding noise: it is held to
1e-4 of its conv weight's largest entry instead.

Every BN bias is shifted by +3, so that no ReLU input lies near 0. At full
width a step has millions of ReLU inputs, and a few of them lie within fp32
rounding of 0, where the two frameworks (or one framework with another
thread count) take different sides of the kink; through the BNs' mean terms
one such flip moves every upstream gradient by about 1 %. With the shift
the same step agrees within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import create_train_state as j_create_train_state
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.data.batch import PointBatch, synthetic_batch
from dfu3d_tpu_torch.flagship import flagship
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.zoo import VOXEL_CFG, VOXEL_TINY_RANGE, voxel_centerpoint

from test_torch_port_models import numpy_variables
from test_torch_port_sparse import ground_points
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

TOTAL_STEPS = 100


def recording(tx):
    """tx that also keeps the gradients it was given in its state."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params), "inner": tx.init(params)}

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state["inner"], params)
        return updates, {"grads": grads, "inner": inner}

    return optax.GradientTransformation(init, update)


def _gt(rng, b, m, lo, hi, width):
    gt = np.zeros((b, m, width), np.float32)
    gt[..., 0] = rng.uniform(lo[0], hi[0], (b, m))
    gt[..., 1] = rng.uniform(lo[1], hi[1], (b, m))
    gt[..., 2] = rng.uniform(-2, 0, (b, m))
    gt[..., 3:6] = rng.uniform(0.5, 5, (b, m, 3))
    gt[..., 6] = rng.uniform(-3, 3, (b, m))
    if width == 10:
        gt[..., 7:9] = rng.uniform(-5, 5, (b, m, 2))
    gt[..., -1] = rng.randint(1, 11, (b, m))
    valid = np.zeros((b, m), bool)
    valid[:, :16] = True
    return gt, valid


def _shift_bn_biases(variables, shift=3.0):
    """+shift on the bias of every module that keeps BN statistics."""
    bn = set()
    jax.tree_util.tree_map_with_path(
        lambda path, _: bn.add(tuple(k.key for k in path[:-1])), variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, x: x + np.float32(shift)
        if path[-1].key == "bias" and tuple(k.key for k in path[:-1]) in bn else x,
        variables["params"])
    return variables


def _one_step(jmodel, jcfg, model, cfg, batch, gains, seed):
    """One JAX train step and one port train step from the same weights.
    Returns (port metrics, port raw grads by state_dict key, port model,
    JAX metrics, JAX grads and new batch_stats as port state_dict dicts)."""
    jbatch = JPointBatch(*(t.numpy() for t in batch))
    variables = _shift_bn_biases(numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=seed, gains=gains))
    tx, _ = j_build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
    tx = recording(tx)
    state = j_create_train_state(jmodel, jbatch, tx)._replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(state, jbatch))
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    jstats = params_from_jax({"batch_stats": new_state.batch_stats})
    old_stats = params_from_jax({"batch_stats": variables["batch_stats"]})

    params_from_jax(variables, model)
    tstate = create_train_state(model, cfg.OPTIMIZATION, TOTAL_STEPS)
    raw = {}
    step_fn = tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return step_fn()

    tstate.optimizer.step = snapshot
    metrics = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)(batch)
    return metrics, raw, model, jmetrics, jgrads, jstats, old_stats


def _check(got):
    metrics, raw, model, jmetrics, jgrads, jstats, old_stats = got
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert set(raw) == set(jgrads)
    for k, want in jgrads.items():
        want = want.numpy()
        scale = np.abs(want).max()
        module, leaf = k.rsplit(".", 1)
        weight = jgrads.get(f"{module}.weight")
        if leaf == "bias" and weight is not None:
            # a conv bias in front of a BN: rounding noise only
            scale = max(scale, np.abs(weight.numpy()).max())
        assert scale > 0, k
        np.testing.assert_allclose(raw[k].numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=k)
    buffers = dict(model.named_buffers())
    modules = dict(model.named_modules())
    assert set(jstats) == set(buffers)
    for k, want in jstats.items():
        module, leaf = k.rsplit(".", 1)
        keep = modules[module].keep
        want = want.numpy()
        tol = 1e-5 * (1 + np.abs(want))
        if leaf == "running_var":
            mean_b = (jstats[f"{module}.running_mean"].numpy()
                      - keep * old_stats[f"{module}.running_mean"].numpy()) / (1 - keep)
            tol = 1e-5 * (np.abs(want) + (1 - keep) * mean_b ** 2)
        assert (np.abs(buffers[k].numpy() - want) <= tol).all(), (
            k, np.abs(buffers[k].numpy() - want).max())
    assert float(metrics["grad_norm"]) > 10  # the clip acted


@pytest.mark.parametrize("model_name", ["pillar", "voxel"])
def test_train_step_matches_jax(model_name):
    rng = np.random.RandomState(30)
    if model_name == "pillar":
        jcfg, _, jmodel = graft._flagship(dtype=jnp.float32, tiny=True)
        cfg, _, model = flagship(tiny=True, device="cpu", train=True)
        batch = synthetic_batch(2, 2048, 32, 12.0, seed=5)
        gt, valid = _gt(rng, 2, 32, (1, -11), (11, 11), 8)
        gains = {"vfe/pfn_0/Dense_0/kernel": 0.3, "dense_head/fused_heads/out/kernel": 0.4}
    else:
        jcfg = j_cfg_from_yaml_file(VOXEL_CFG, JCfgDict())
        jcfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(VOXEL_TINY_RANGE)
        jgrid = JVoxelGrid.create(VOXEL_TINY_RANGE, [0.1, 0.1, 0.2])
        jmodel = j_build_network(jcfg.MODEL, jcfg.CLASS_NAMES, jgrid, dtype=jnp.float32,
                                 max_voxels=2048)
        cfg, grid, _ = voxel_centerpoint(tiny=True, device="cpu")
        model = build_network(cfg.MODEL, cfg.CLASS_NAMES, grid, device="cpu", train=True,
                              max_voxels=2048)
        pts, pvalid = ground_points(np.random.RandomState(31), 2)
        gt, valid = _gt(rng, 2, 32, (-6, -6), (6, 6), 10)
        batch = PointBatch.from_numpy(pts, pvalid, gt, valid)
        gains = {"backbone_3d/conv_input/SubMConv3d_0/kernel": 0.5,
                 "dense_head/fused_heads/out/kernel": 0.4}
    batch = batch._replace(gt_boxes=torch.from_numpy(gt), gt_valid=torch.from_numpy(valid))
    _check(_one_step(jmodel, jcfg, model, cfg, batch, gains, seed=32))
