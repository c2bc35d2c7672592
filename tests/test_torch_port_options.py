"""Port parity: the model options that the JAX package builds and no shipped
config sets, against the JAX package on the CPU, fp32 on both sides, from
the same numpy inputs and weights (flax layout, carried across by
`params_from_jax`):

* `circle_nms` over a batch of problems (ties in the scores, masked boxes,
  an empty problem, post_max below and above the candidates): indices and
  keep masks exactly equal;
* CenterHead's per-tower SeparateHeads (a 3-conv center branch beside
  2-conv ones) and BaseBEVResBackbone, each alone in train mode: outputs
  within 1e-5, the gradients of a weighted sum of the outputs (every
  parameter and the input) within 1e-4 of each leaf's largest entry, the
  updated BN running statistics within 1e-5;
* MATCH_HEIGHT's assigner on the 3D IoU: labels exactly equal (a force-match
  tie between two anchors, a masked slot, a frame without gt), regression
  targets within 1e-6; and the detector's per-class assignment, which puts
  all three classes' frames through one overlap call;
* the IoU head's loss and rectified score: `predict` of a CenterPoint with
  the options (per-tower heads, BaseBEVResBackbone, circle NMS) and of a
  SECOND with USE_IOU_HEAD and MATCH_HEIGHT: keep masks and labels equal,
  boxes and scores within 1e-4; one whole train step of that SECOND through
  `make_train_step` against the JAX package's (the loss and its terms, the
  IoU loss among them, within 1e-5 relative, every gradient leaf within
  1e-4 of its largest entry, conv_iou's gradient nonzero, one overlap call);
* the reference-checkpoint mappings of BaseBEVResBackbone and of the
  per-tower heads against the JAX package's, and conv_iou's.

The configs are tests/test_model.py's and tests/test_pointpillar.py's test
scale with the options set; the full-width derived configs (zoo.option_cfg)
are built in both packages by tests/test_torch_port_catalog.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.geometry import nms as jnms
from dfu3d_tpu.models import anchor_head as jah
from dfu3d_tpu.models import backbone_2d as jbb
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import center_head as jch
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.geometry import iou_kernel
from dfu3d_tpu_torch.core.geometry.nms import circle_nms
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import anchor_head as ah
from dfu3d_tpu_torch.models import backbone_2d as bb
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import center_head as ch
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
from dfu3d_tpu_torch.zoo import SECOND_MULTIHEAD_CFG

from test_model import CLASS_NAMES, make_batch, tiny_grid, tiny_model_cfg
from test_pointpillar import CLASSES, second_grid, second_model_cfg
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_train_slice import _shift_bn_biases, recording
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

TOTAL_STEPS = 100
HEAD_DICT = {"center": {"out_channels": 2, "num_conv": 3},
             "center_z": {"out_channels": 1, "num_conv": 2},
             "dim": {"out_channels": 3, "num_conv": 2},
             "rot": {"out_channels": 2, "num_conv": 2}}


def t(a):
    return torch.from_numpy(np.array(a))


def assert_grads_close(got, want, tol=1e-4, zero=(), floor=0.0):
    """The same keys, and every leaf of `want` (a port-keyed dict of
    tensors) within tol of the larger of its largest entry and `floor` of
    the whole gradient's largest entry; the leaves named in `zero` (the
    biases of convs that a train-mode BN follows, whose gradient is 0 but
    for rounding) within 1e-5 of the whole gradient's largest entry on both
    sides."""
    assert set(got) == set(want)
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        if k in zero:
            assert np.abs(w).max() <= 1e-5 * top and np.abs(np.asarray(got[k])).max() <= 1e-5 * top
            continue
        scale = max(np.abs(w).max(), floor * top)
        assert scale > 0, k
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0, atol=tol * scale, err_msg=k)


def weighted(outs, weights):
    return sum(jnp.sum(o * w) for o, w in zip(outs, weights))


# --------------------------------------------------------------------------
# circle_nms
# --------------------------------------------------------------------------

def test_circle_nms_matches_jax():
    rng = np.random.RandomState(0)
    g, n = 6, 160
    boxes = np.zeros((g, n, 7), np.float32)
    boxes[..., :2] = rng.uniform(-8, 8, (g, n, 2))
    # near copies of the first 50 centres, some within the 1 m radius
    boxes[:, 100:150, :2] = boxes[:, :50, :2] + rng.normal(0, 0.8, (g, 50, 2))
    boxes[..., 3:6] = rng.uniform(0.5, 4, (g, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (g, n))
    scores = rng.uniform(0, 1, (g, n)).astype(np.float32)
    scores[:, 150:160] = scores[:, 100:110]   # equal scores: the lower index first
    valid = rng.uniform(0, 1, (g, n)) > 0.2
    valid[5] = False                          # a problem with no live box
    for post_max in (40, 500):
        fn = jax.vmap(lambda b, s, v: jnms.circle_nms(b, s, 1.0, post_max=post_max, valid=v))
        want = jax.device_get(fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
        got = circle_nms(t(boxes), t(scores), 1.0, post_max, valid=t(valid))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert 0 < want[1][:5].sum(1).min() and not want[1][5].any()
    # suppression happened: fewer kept than live in every live problem
    assert (want[1].sum(1)[:5] < valid.sum(1)[:5]).all()


# --------------------------------------------------------------------------
# the per-tower heads and BaseBEVResBackbone, alone in train mode
# --------------------------------------------------------------------------

def _train_mode_pair(jmod, port, x, out_list, seed):
    """Forward + backward of a weighted sum of the outputs in train mode on
    both sides; returns (JAX outputs, updated stats, param grads, input
    grad, port outputs, port param grads, port input grad)."""
    variables = numpy_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False),
                                seed=seed)
    params_from_jax(variables, port)
    rng = np.random.RandomState(seed + 1)

    def jloss(params, xx, weights):
        out, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                              True, mutable=["batch_stats"])
        return weighted(out_list(out), weights), (out, upd)

    shapes = [o.shape for o in out_list(jax.eval_shape(
        lambda: jmod.apply(variables, jnp.asarray(x), False)))]
    weights = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    (_, (jout, upd)), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(
        variables["params"], jnp.asarray(x), [jnp.asarray(w) for w in weights])
    port.train()
    tx = t(x).requires_grad_(True)
    pout = port(tx)
    sum((o * t(w)).sum() for o, w in zip(out_list(pout), weights)).backward()
    pgrads = {k: p.grad for k, p in port.named_parameters()}
    return (jax.device_get(jout), jax.device_get(upd), params_from_jax({"params": gp}),
            np.asarray(gx), pout, pgrads, tx.grad)


def _check_stats(port, upd):
    want = params_from_jax({"batch_stats": upd["batch_stats"]})
    buffers = dict(port.named_buffers())
    assert want and set(want) <= set(buffers)
    for k, v in want.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_separate_heads_match_jax():
    kw = dict(class_names=tuple(CLASS_NAMES), class_names_each_head=(("Car",),
                                                                     ("Pedestrian", "Cyclist")),
              shared_conv_channel=16, num_hm_conv=2, head_dict=HEAD_DICT,
              point_cloud_range=(0, -6.4, -3, 6.4, 6.4, 1), voxel_size=(0.2, 0.2, 4.0),
              feature_map_stride=2)
    jhead = jch.CenterHead(head_order=("center", "center_z", "dim", "rot"), **kw)
    port = ch.CenterHead(24, head_order=("center", "center_z", "dim", "rot"), **kw)
    assert not port.fused and hasattr(port, "head_1") and hasattr(port.head_0, "center_conv1")
    x = np.random.RandomState(3).normal(0, 1, (2, 16, 16, 24)).astype(np.float32)

    def out_list(preds):
        return [p[k] for p in preds for k in sorted(p)]

    jout, upd, jgrads, jgx, pout, pgrads, pgx = _train_mode_pair(jhead, port, x, out_list, 5)
    for g, w in zip(out_list(pout), out_list(jout)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5)
    pre_bn = {k for k in jgrads if k.endswith(".bias") and (k.startswith("shared_conv.")
                                                            or "_conv" in k)}
    assert_grads_close({k: v.numpy() for k, v in pgrads.items()},
                       {k: v.numpy() for k, v in jgrads.items()}, zero=pre_bn)
    assert_grads_close({"x": pgx.numpy()}, {"x": jgx})
    _check_stats(port, upd)


def test_bev_res_backbone_matches_jax():
    kw = dict(layer_nums=(1, 2), layer_strides=(1, 2), num_filters=(16, 32),
              upsample_strides=(1, 2), num_upsample_filters=(16, 16))
    jmod = jbb.BaseBEVResBackbone(**kw)
    port = bb.BaseBEVResBackbone(8, **kw)
    assert port.out_channels == 32 and port.block0_down.has_shortcut
    assert not port.block1_res0.has_shortcut
    x = np.random.RandomState(4).normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    jout, upd, jgrads, jgx, pout, pgrads, pgx = _train_mode_pair(jmod, port, x, lambda o: [o], 6)
    np.testing.assert_allclose(pout.detach().numpy(), jout, rtol=0, atol=1e-5)
    assert_grads_close({k: v.numpy() for k, v in pgrads.items()},
                       {k: v.numpy() for k, v in jgrads.items()})
    assert_grads_close({"x": pgx.numpy()}, {"x": jgx})
    _check_stats(port, upd)


# --------------------------------------------------------------------------
# MATCH_HEIGHT
# --------------------------------------------------------------------------

def test_match_height_assigner_force_match_tie():
    """Anchors on a 1 m lattice, 2 x 2 x 1.5 m at z 0; a gt of the same size
    at x = 0.5 overlaps the anchors at x = 0 and x = 1 in 3D by exactly the
    same IoU (under the 0.7 matched threshold): both are force-matched. A
    gt at z 0.5 elsewhere, a masked slot, and a frame with no gt."""
    from dfu3d_tpu_torch.core.geometry.iou import pairwise_iou3d

    xs = np.arange(-3, 4, dtype=np.float32)
    anchors = np.zeros((len(xs) * 2, 7), np.float32)
    anchors[:, 0] = np.tile(xs, 2)
    anchors[:, 1] = np.repeat([0.0, 5.0], len(xs))
    anchors[:, 3:6] = [2.0, 2.0, 1.5]
    gt = np.zeros((2, 3, 8), np.float32)
    gt[:, :, :7] = [0.5, 0.0, 0.0, 2.0, 2.0, 1.5, 0.0]
    gt[:, :, 7] = 1
    gt[0, 1, :3] = [2.0, 5.0, 0.5]
    gt[0, 2, :3] = [-2.0, 5.0, 0.0]
    mask = np.array([[True, True, False], [False, False, False]])

    def jax_one(g, m):
        return jah.assign_targets_single_class(jnp.asarray(anchors), g[:, :7], m, g[:, -1],
                                               0.7, 0.45, match_height=True)

    want = jax.device_get(jax.jit(jax.vmap(jax_one))(jnp.asarray(gt), jnp.asarray(mask)))
    iou = pairwise_iou3d(t(anchors)[None].expand(2, -1, -1), t(gt[..., :7]))
    got = ah.assign_targets_single_class(t(anchors), t(gt[..., :7]), t(mask), t(gt[..., -1]),
                                         0.7, 0.45, iou=iou)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert (want[0][0][[3, 4]] == 1).all()     # the tie, both force-matched
    assert (want[0][1] == 0).all()             # no gt
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def second_iou_height_cfg():
    """tests/test_pointpillar.py's SECONDNet with USE_IOU_HEAD and
    MATCH_HEIGHT (zoo.option_cfg("second_iou_height")'s keys)."""
    cfg = second_model_cfg()
    cfg["DENSE_HEAD"]["USE_IOU_HEAD"] = True
    cfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["MATCH_HEIGHT"] = True
    return cfg


def centerpoint_options_cfg():
    """tests/test_model.py's CenterPoint with zoo.option_cfg
    ("centerpoint_options")'s options: BaseBEVResBackbone, a 3-conv center
    tower, circle NMS at 1 m."""
    cfg = tiny_model_cfg()
    cfg["BACKBONE_2D"]["NAME"] = "BaseBEVResBackbone"
    cfg["DENSE_HEAD"]["SEPARATE_HEAD_CFG"]["HEAD_DICT"]["center"]["num_conv"] = 3
    nms = cfg["DENSE_HEAD"]["POST_PROCESSING"]["NMS_CONFIG"]
    nms["NMS_TYPE"], nms["NMS_THRESH"] = "circle_nms", 1.0
    return cfg


MODELS = {"centerpoint_options": (centerpoint_options_cfg, tiny_grid, CLASS_NAMES),
          "second_iou_height": (second_iou_height_cfg, second_grid, CLASSES)}


def _pair(name, seed=1, bn_shift=0.0):
    """(JAX model, flax variables, port model in eval mode)."""
    cfg_fn, grid_fn, classes = MODELS[name]
    jcfg, jgrid = cfg_fn(), grid_fn()
    jmodel = j_build_network(jcfg, classes, jgrid)
    grid = VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size)
    model = build_network(CfgDict(jcfg), classes, grid, device="cpu")
    # the out convs at a tenth of He-normal: box codes O(0.1), whose exp'd
    # dims stay metres wide
    gains = {"dense_head/conv_box/kernel": 0.1,
             **{f"dense_head/head_{h}/{n}_out/kernel": 0.1 for h in range(2)
                for n in ("hm", "center", "center_z", "dim", "rot")}}
    variables = numpy_variables(lambda: flax_variables_like(model), seed=seed, gains=gains)
    if bn_shift:
        variables = _shift_bn_biases(variables, bn_shift)
    params_from_jax(variables, model)
    return jmodel, variables, model


def _port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


def test_detector_match_height_targets_equal(monkeypatch):
    jmodel, variables, model = _pair("second_iou_height")
    jbatch = make_batch(np.random.RandomState(5), b=2, n=512, m=8)
    gt, valid = np.asarray(jbatch.gt_boxes).copy(), np.asarray(jbatch.gt_valid).copy()
    gt[1, :, 7] = np.where(gt[1, :, 7] == 3, 1, gt[1, :, 7])   # frame 1: no Cyclist
    want = jax.device_get(jax.jit(lambda g, v: jmodel.apply(
        variables, g, v, method=lambda m, g, v: m.assign_targets(g, v)))(gt, valid))
    calls, fn = [], iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev", lambda a, b: calls.append(a.shape) or fn(a, b))
    got = model.assign_targets(t(gt), t(valid))
    labels = got.box_cls_labels.numpy()
    np.testing.assert_array_equal(labels, want.box_cls_labels)
    assert (labels > 0).sum() > 3 and not (labels[1] == 3).any()
    np.testing.assert_allclose(got.box_reg_targets.numpy(), want.box_reg_targets, atol=1e-6)
    np.testing.assert_array_equal(got.reg_weights.numpy(), want.reg_weights)
    # the three classes' anchor grids are equal in size: one overlap call
    # over (3 classes x 2 frames) problems
    assert len(calls) == 1 and calls[0][0] == 6


# --------------------------------------------------------------------------
# whole detectors: predict, and SECOND's train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_matches_jax(name):
    jmodel, variables, model = _pair(name)
    jbatch = make_batch(np.random.RandomState(4), b=2, n=512)
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, b: m.predict(b)))(variables, jbatch))
    with torch.no_grad():
        got = model.predict(_port_batch(jbatch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 6
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)


def test_second_iou_height_train_step_matches_jax(monkeypatch):
    jmodel, variables, model = _pair("second_iou_height", seed=2, bn_shift=3.0)
    jbatch = make_batch(np.random.RandomState(7), b=2, n=512, m=8)
    optim_cfg = cfg_from_yaml_file(SECOND_MULTIHEAD_CFG, CfgDict()).OPTIMIZATION
    tx, _ = j_build_optimizer(optim_cfg, TOTAL_STEPS)
    tx = recording(tx)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(state, jbatch))
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})

    model.train()
    tstate = create_train_state(model, optim_cfg, TOTAL_STEPS)
    raw, step_fn = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return step_fn()

    tstate.optimizer.step = snapshot
    calls, fn = [], iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev", lambda a, b: calls.append(a.shape) or fn(a, b))
    metrics = make_train_step(model, tstate.optimizer, device="cpu",
                              dtype=torch.float32)(_port_batch(jbatch))
    assert len(calls) == 1    # MATCH_HEIGHT's assignment; the IoU loss pairs boxes plainly
    assert set(metrics) == set(jmetrics) == {"loss", "rpn_loss", "rpn_loss_cls", "rpn_loss_loc",
                                             "rpn_loss_dir", "iou_loss", "grad_norm"}
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert float(jmetrics["iou_loss"]) > 0 and float(jmetrics["rpn_loss_loc"]) > 0
    assert_grads_close({k: v.numpy() for k, v in raw.items()},
                       {k: v.numpy() for k, v in jgrads.items()})
    assert raw["dense_head.conv_iou.weight"].abs().max() > 0


# --------------------------------------------------------------------------
# reference-checkpoint mappings
# --------------------------------------------------------------------------

def _round_trip(jvariables, jmapping, port_state, port_mapping, seed):
    """A reference-format state holding a random tensor for every reference
    key the port's mapping names, through the JAX package's mapping and
    `params_from_jax`, and through the port's: equal on every key both
    convert. Returns the port's report."""
    rng = np.random.RandomState(seed)
    ref = {}
    for ours, (refs, _) in port_mapping.items():
        if ours not in port_state:
            continue
        shape = tuple(port_state[ours].shape)
        for r in (refs if isinstance(refs, tuple) else (refs,)):
            ref[r] = rng.normal(0, 1, shape).astype(np.float32)
    new, _ = jtc.apply_mapping(jvariables, ref, jmapping)
    via_jax = params_from_jax({k: new[k] for k in ("params", "batch_stats") if k in new})
    got, report = torch_convert.apply_mapping(port_state, {k: t(v) for k, v in ref.items()},
                                              port_mapping)
    return via_jax, got, report


def test_bev_res_backbone_mapping_matches_jax():
    kw = dict(layer_nums=(1, 2), layer_strides=(1, 2), num_filters=(16, 32),
              upsample_strides=(1, 2), num_upsample_filters=(16, 16))
    jmod = jbb.BaseBEVResBackbone(**kw)
    variables = numpy_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)),
                                                  False))
    wrapped = {c: {"backbone_2d": variables[c]} for c in variables}
    port = bb.BaseBEVResBackbone(8, **kw)
    own = {f"backbone_2d.{k}": v for k, v in port.state_dict().items()}
    via_jax, got, report = _round_trip(wrapped, jtc.bev_res_backbone_mapping((1, 2)), own,
                                       torch_convert.bev_res_backbone_mapping((1, 2)), 8)
    assert not report["missing_in_torch"] and not report["unmatched_ours"]
    for k, v in via_jax.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_separate_heads_and_conv_iou_mappings():
    """The per-tower heads: on the 2-conv towers the port's keys read the
    reference keys the JAX package's mapping reads; the 3-conv center tower
    follows the reference SeparateHead's Sequential (hidden blocks .0 and
    .1, the out conv .2), which the JAX package's mapping, written for
    2-conv towers, reads as .1 (ROADMAP Queue C). Then both detectors'
    whole mappings leave no key of theirs unmatched, conv_iou included."""
    jm = jtc.centerpoint_pillar_mapping(num_heads=2)
    heads = [{k: (v["out_channels"], v["num_conv"]) for k, v in HEAD_DICT.items()}
             for _ in range(2)]
    for hd, n in zip(heads, (1, 2)):
        hd["hm"] = (n, 2)
    pm = torch_convert.separate_heads_mapping(heads)
    for (coll, *path, leaf), (ref, _) in jm.items():
        if len(path) < 3 or not path[1].startswith("head_") or (
                path[2].startswith("center_") and not path[2].startswith("center_z")):
            continue
        port_leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                     "var": "running_var"}.get(leaf, leaf)
        assert pm[".".join(path + [port_leaf])][0] == ref
    assert pm["dense_head.head_1.center_conv1.weight"][0] == "dense_head.heads_list.1.center.1.0.weight"
    assert pm["dense_head.head_1.center_bn1.running_var"][0] == \
        "dense_head.heads_list.1.center.1.1.running_var"
    assert pm["dense_head.head_1.center_out.weight"][0] == "dense_head.heads_list.1.center.2.weight"
    assert jm[("params", "dense_head", "head_1", "center_out", "kernel")][0] == \
        "dense_head.heads_list.1.center.1.weight"
    for name in MODELS:
        _, _, model = _pair(name)
        mapping = model.reference_mapping()
        unmatched = [k for k in model.state_dict() if k not in mapping]
        assert not unmatched or all(k.startswith("backbone_3d.") for k in unmatched), unmatched
    assert torch_convert.anchor_head_mapping(use_iou=True)["dense_head.conv_iou.weight"][0] == \
        jtc.anchor_head_mapping(use_iou=True)[("params", "dense_head", "conv_iou", "kernel")][0]
