"""Port parity: the anchor heads and the anchor detectors (PointPillar with
AnchorHeadSingle, SECONDNet with AnchorHeadMulti) against the JAX package,
fp32 on both sides, at tests/test_pointpillar.py's configs and grids
(SECONDNet's head made multi-head: [Car] and [Pedestrian, Cyclist] groups
behind a 16-channel shared conv). Weights are numpy draws in the flax layout
carried across by `params_from_jax`.

* anchors exactly equal, at the test configs and at the two nuScenes anchor
  configs' full grids;
* target labels exactly equal: hand-made anchors where two anchors tie on a
  gt's best IoU (both force-matched below the matched threshold), and the
  detector's per-class assignment over a batch whose second frame has no gt
  of one class and whose first has a gt on a Car anchor; regression targets
  and weights within 1e-6;
* AnchorHeadSingle and AnchorHeadMulti outputs within 1e-5;
* `predict`: keep masks and labels equal, boxes and scores within 1e-4;
* `anchor_head_mapping` carrying a reference-format state across.

One whole train step of each detector against the JAX package's is in
tests/test_torch_port_anchor_train.py, with `_pair`, `_batch`,
`_optim_cfg` and BN_SHIFT from here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.models import anchor_head as jah
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import anchor_head as ah
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
from dfu3d_tpu_torch.zoo import PP_MULTIHEAD_CFG, SECOND_MULTIHEAD_CFG

from test_model import make_batch, tiny_grid
from test_pointpillar import CLASSES, pp_model_cfg, second_grid, second_model_cfg
from test_torch_port_models import numpy_variables
from test_torch_port_train_slice import _shift_bn_biases
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

TOTAL_STEPS = 100


def second_multihead_cfg():
    cfg = second_model_cfg()
    dh = cfg["DENSE_HEAD"]
    dh["NAME"] = "AnchorHeadMulti"
    dh["SHARED_CONV_NUM_FILTER"] = 16
    dh["RPN_HEAD_CFGS"] = [{"HEAD_CLS_NAME": ["Car"]},
                           {"HEAD_CLS_NAME": ["Pedestrian", "Cyclist"]}]
    return cfg


MODELS = {"pointpillar": (pp_model_cfg, tiny_grid),
          "second_multihead": (second_multihead_cfg, second_grid)}
BN_SHIFT = {"pointpillar": 0.0, "second_multihead": 3.0}


def _pair(name, seed=1, bn_shift=0.0):
    """(JAX model, flax variables, port model in eval mode, JAX cfg)."""
    cfg_fn, grid_fn = MODELS[name]
    jcfg, jgrid = cfg_fn(), grid_fn()
    jmodel = j_build_network(jcfg, CLASSES, jgrid)
    batch = make_batch(np.random.RandomState(4), b=2, n=512)
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, batch, train=False,
                            method=lambda m, b, train: m._features(b, train)),
        seed=seed, gains={"dense_head/conv_box/kernel": 0.1})
    if bn_shift:
        variables = _shift_bn_biases(variables, bn_shift)
    grid = VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size)
    model = build_network(CfgDict(jcfg), CLASSES, grid, device="cpu")
    params_from_jax(variables, model)
    return jmodel, variables, model, jcfg


def _batch(seed, b=2, n=512, m=8):
    return make_batch(np.random.RandomState(seed), b=b, n=n, m=m)


def _port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


def test_anchors_equal():
    for cfg_fn, grid_fn in MODELS.values():
        grid = grid_fn()
        acfg = [dict(c) for c in cfg_fn()["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]]
        want = jah.generate_anchors(acfg, grid.grid_size, grid.point_cloud_range)
        got = ah.generate_anchors(acfg, grid.grid_size, grid.point_cloud_range)
        assert got[1] == want[1]
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
    # the nuScenes configs' full grids: 128 x 128 (SECOND), 256 x 256 (pillars)
    for path, grid_size in ((SECOND_MULTIHEAD_CFG, (1024, 1024, 40)),
                            (PP_MULTIHEAD_CFG, (512, 512, 1))):
        cfg = cfg_from_yaml_file(path, CfgDict())
        acfg = [dict(c) for c in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
        pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        want = jah.generate_anchors(acfg, grid_size, pcr)
        got = ah.generate_anchors(acfg, grid_size, pcr)
        assert got[1] == want[1] == [2] * 10
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)


def test_nearest_bev_iou_bit_equal():
    """The anchors' snapped axis-aligned BEV IoU equals JAX's op by op to
    the last bit (the force-match compares IoUs for equality), headings on
    and around the ±45° snap included. Compiled, XLA sometimes contracts
    the union's B-side product into a fused multiply-add: jitted alone, or
    vmapped with the anchors as arguments, ~2 % of these pairs move by one
    ulp; in the detector's own target assignment it does not, and the
    labels there are held equal below."""
    from dfu3d_tpu.core.geometry import boxes as jboxes
    from dfu3d_tpu_torch.core.geometry import boxes

    rng = np.random.RandomState(9)
    a = np.zeros((300, 7), np.float32)
    a[:, :2] = rng.uniform(-10, 10, (300, 2))
    a[:, 3:6] = rng.uniform(0.3, 6, (300, 3))
    a[:, 6] = rng.choice([0.0, 1.57, np.pi / 4, -np.pi / 4, 3.0], 300)
    b = a[rng.permutation(300)[:64]].copy()
    b[:, :2] += rng.normal(0, 0.7, (64, 2))
    b[:, 6] += rng.normal(0, 0.3, 64)
    want = np.asarray(jboxes.boxes3d_nearest_bev_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes.boxes3d_nearest_bev_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 100


def test_assign_targets_force_match_tie():
    """Anchors on a 1 m lattice, 2 x 2 m, heading 0; a gt of the same size at
    x = 0.5 overlaps the anchors at x = 0 and x = 1 by exactly the same IoU
    (0.6, under the 0.7 matched threshold): both are force-matched. A second
    gt slot is masked out, and the second frame has no gt at all."""
    xs = np.arange(-3, 4, dtype=np.float32)
    anchors = np.zeros((len(xs) * 2, 7), np.float32)
    anchors[:, 0] = np.tile(xs, 2)
    anchors[:, 1] = np.repeat([0.0, 5.0], len(xs))
    anchors[:, 3:6] = [2.0, 2.0, 1.5]
    gt = np.zeros((2, 2, 8), np.float32)
    gt[:, :, :7] = [0.5, 0.0, 0.0, 2.0, 2.0, 1.5, 0.0]
    gt[:, :, 7] = 1
    gt[0, 1, :2] = [2.0, 5.0]
    mask = np.array([[True, False], [False, False]])

    def jax_one(g, m):
        return jah.assign_targets_single_class(jnp.asarray(anchors), g[:, :7], m, g[:, -1],
                                               0.7, 0.45)

    want = jax.device_get(jax.vmap(jax_one)(jnp.asarray(gt), jnp.asarray(mask)))
    got = ah.assign_targets_single_class(torch.from_numpy(anchors), torch.from_numpy(gt[..., :7]),
                                         torch.from_numpy(mask), torch.from_numpy(gt[..., -1]),
                                         0.7, 0.45)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert (want[0][0] == 1).sum() == 2 and (want[0][0][[3, 4]] == 1).all()  # the tie
    assert (want[0][1] == 0).all()                                           # no gt
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_detector_targets_equal():
    jmodel, variables, model, _ = _pair("pointpillar")
    jbatch = _batch(5)
    gt, valid = np.asarray(jbatch.gt_boxes).copy(), np.asarray(jbatch.gt_valid).copy()
    gt[1, :, 7] = np.where(gt[1, :, 7] == 3, 1, gt[1, :, 7])   # frame 1: no Cyclist
    cfgs = [dict(c) for c in pp_model_cfg().DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    car = jah.generate_anchors(cfgs, tiny_grid().grid_size, tiny_grid().point_cloud_range)[0][0]
    gt[0, 0, :7], gt[0, 0, 7] = car[0, 16, 8, 0, 1], 1          # on a Car anchor
    want = jax.device_get(jax.jit(lambda g, v: jmodel.apply(
        variables, g, v, method=lambda m, g, v: m.assign_targets(g, v)))(gt, valid))
    got = model.assign_targets(torch.from_numpy(gt), torch.from_numpy(valid))
    labels = got.box_cls_labels.numpy()
    np.testing.assert_array_equal(labels, want.box_cls_labels)
    assert (labels == 1).sum() > 1 and (labels[0] == 3).any() and not (labels[1] == 3).any()
    np.testing.assert_allclose(got.box_reg_targets.numpy(), want.box_reg_targets, atol=1e-6)
    np.testing.assert_array_equal(got.reg_weights.numpy(), want.reg_weights)


def test_heads_match_jax():
    x = np.random.RandomState(6).normal(0, 1, (2, 8, 16, 32)).astype(np.float32)
    counts = (2, 2, 2)
    jsingle = jah.AnchorHeadSingle(num_class=3, num_anchors_per_location=6)
    jmulti = jah.AnchorHeadMulti(num_class=3, class_groups=((0,), (1, 2)),
                                 anchors_per_loc_each_class=counts, shared_conv_channels=16)
    single = ah.AnchorHeadSingle(32, 3, 6)
    multi = ah.AnchorHeadMulti(32, 3, ((0,), (1, 2)), counts, shared_conv_channels=16)
    for jmod, port in ((jsingle, single), (jmulti, multi)):
        variables = numpy_variables(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                    seed=7)
        want = jax.device_get(jmod.apply(variables, jnp.asarray(x)))
        params_from_jax(variables, port)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert set(got) == set(want) == {"cls_preds", "box_preds", "dir_cls_preds"}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
    # AnchorHeadMulti: an anchor's logits outside its class group are pinned
    cls = got["cls_preds"].reshape(2, 8, 16, 6, 3)
    assert (cls[..., 0:2, 1:] == ah.FOREIGN_LOGIT).all()
    assert (cls[..., 2:6, 0] == ah.FOREIGN_LOGIT).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_matches_jax(name):
    jmodel, variables, model, _ = _pair(name)
    jbatch = _batch(4)
    want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, b: m.predict(b)))(variables, jbatch))
    with torch.no_grad():
        got = model.predict(_port_batch(jbatch))
    wb, ws, wl, wv = want
    gb, gs, gl, gv = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 8  # NMS kept a real set
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)


def _optim_cfg():
    return cfg_from_yaml_file(SECOND_MULTIHEAD_CFG, CfgDict()).OPTIMIZATION


def test_anchor_head_mapping_round_trip():
    """A reference-format AnchorHeadSingle state (OIHW conv_cls / conv_box /
    conv_dir_cls) through the JAX package's mapping into flax variables,
    `params_from_jax` into the port, equals the same state through the
    port's mapping; the port's PointPillar mapping covers its pillar VFE, 2D
    backbone and head, and leaves no key of them unmatched."""
    jhead = jah.AnchorHeadSingle(num_class=3, num_anchors_per_location=6)
    x = jnp.zeros((1, 4, 4, 32))
    variables = jax.device_get(jhead.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(8)
    ref = {}
    for name, cout in (("conv_cls", 18), ("conv_box", 42), ("conv_dir_cls", 12)):
        ref[f"dense_head.{name}.weight"] = rng.normal(0, 1, (cout, 32, 1, 1)).astype(np.float32)
        ref[f"dense_head.{name}.bias"] = rng.normal(0, 1, (cout,)).astype(np.float32)
    wrapped = {"params": {"dense_head": variables["params"]}}
    new, report = jtc.apply_mapping(wrapped, ref, jtc.anchor_head_mapping())
    assert not report["missing_in_torch"] and not report["unmatched_ours"]
    via_jax = params_from_jax({"params": new["params"]["dense_head"]})

    port = ah.AnchorHeadSingle(32, 3, 6)
    own = {f"dense_head.{k}": v for k, v in port.state_dict().items()}
    got, preport = torch_convert.apply_mapping(
        own, {k: torch.from_numpy(v) for k, v in ref.items()},
        torch_convert.anchor_head_mapping())
    assert not preport["missing_in_torch"] and not preport["unmatched_ours"]
    for k, v in via_jax.items():
        np.testing.assert_array_equal(got[f"dense_head.{k}"].numpy(), v.numpy())

    _, _, model, _ = _pair("pointpillar")
    mapping = model.reference_mapping()
    assert not [k for k in model.state_dict() if k not in mapping]


def test_anchor_profile_on_the_cpu(monkeypatch):
    """profile_serve.anchor_profile (what `profile_serve --model second` and
    `profile_train --model second` report) on the tiny multi-head SECONDNet,
    its syncs stubbed: every span of an eval step and of a train step, B2
    inside the sparse convs and the backward, B1 inside the NMS and the
    recall IoU, and one keep-scan per step."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    jgrid = second_grid()
    model = build_network(CfgDict(second_multihead_cfg()), CLASSES,
                          VoxelGrid.create(jgrid.point_cloud_range, jgrid.voxel_size),
                          device="cpu")
    batches = [_port_batch(_batch(4))]
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    out = profile_serve.anchor_profile(model, lambda b: profile_serve._run(step, b), batches)
    assert {"vfe", "neighbour_tables", "sparse_convs", "sparse_convs.b2", "backbone_2d",
            "dense_head", "decode", "nms", "nms.b1", "nms.keep_scan", "recall_iou",
            "recall_iou.b1", "rest", "step"} == set(out["phase_ms"])
    assert len(out["keep_scan"]) == 1
    tstate = create_train_state(model, _optim_cfg(), TOTAL_STEPS)
    tstep = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)
    out = profile_serve.anchor_profile(model, lambda b: float(tstep(b)["loss"]), batches,
                                       tstate.optimizer)
    assert {"anchor_targets", "loss", "backward", "backward.b2", "clip_optimizer",
            "sparse_convs.b2"} <= set(out["phase_ms"]) and "nms" not in out["phase_ms"]
