"""Port parity of the train path's pieces against the JAX package, fp32 on
both sides: the losses, gaussian targets, the custom backwards of the VFE's
segment ops, the three BatchNorms in train mode, the one-cycle schedule, one
optimizer update on identical gradients, and the checkpoint contract.

Tolerances: losses and BN outputs 1e-5 relative (sums in another order);
heat-map targets 1e-6 absolute, target indices and masks exact; segment-op
gradients exact (gathers and sums of the same values); schedules within
1e-6 · lr_max (JAX evaluates the cosine in fp32, the port in float64: near
the end of the cycle cos(π·pct) + 1 cancels, so the two differ there by more
than 1e-6 relative); optimizer updates 1e-6 relative on the parameters.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfu3d_tpu.core.voxel import voxelize as jvox
from dfu3d_tpu.models import losses as jlosses
from dfu3d_tpu.models.center_head import CenterHead as JCenterHead
from dfu3d_tpu.models.center_head import gaussian_radius as j_gaussian_radius
from dfu3d_tpu.models.sparse_backbone import SparseBatchNorm as JSparseBatchNorm
from dfu3d_tpu.models.vfe import MaskedBatchNorm as JMaskedBatchNorm
from dfu3d_tpu.train import optimization as jopt
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.flagship import FLAGSHIP_CFG
from dfu3d_tpu_torch.models import losses
from dfu3d_tpu_torch.models.backbone_2d import BatchNorm
from dfu3d_tpu_torch.models.center_head import CenterHead, gaussian_radius
from dfu3d_tpu_torch.models.sparse_backbone import SparseBatchNorm
from dfu3d_tpu_torch.models.vfe import MaskedBatchNorm
from dfu3d_tpu_torch.train import checkpoint, optimization
from dfu3d_tpu_torch.train.train_state import TrainState
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file
from dfu3d_tpu_torch.zoo import VOXEL_CFG


def t(a):
    return torch.from_numpy(np.asarray(a))


class TestLosses:
    def test_focal_and_sigmoid_match_jax(self):
        rng = np.random.RandomState(0)
        logits = rng.normal(0, 3, (2, 16, 8, 3)).astype(np.float32)
        logits[0, 0, 0, 0] = 40.0   # clamped at 1 - 1e-4
        gt = rng.uniform(0, 1, logits.shape).astype(np.float32) ** 4
        gt[:, ::5, ::3] = 1.0
        pred = losses.sigmoid_clamped(t(logits))
        jpred = jlosses.sigmoid_clamped(jnp.asarray(logits))
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-6)
        for g in (gt, np.minimum(gt, 0.99)):   # with positives, and with none
            got = losses.focal_loss_centernet(pred, t(g)).item()
            want = float(jlosses.focal_loss_centernet(jpred, jnp.asarray(g)))
            np.testing.assert_allclose(got, want, rtol=1e-5)
        assert (gt >= 1).any()

    def test_reg_loss_matches_jax(self):
        rng = np.random.RandomState(1)
        feat = rng.normal(0, 1, (2, 40, 10)).astype(np.float32)
        target = rng.normal(0, 1, (2, 6, 10)).astype(np.float32)
        inds = rng.randint(0, 40, (2, 6))
        mask = rng.uniform(0, 1, (2, 6)) > 0.3
        got = losses.reg_loss_centernet(t(feat), t(target), t(inds), t(mask)).numpy()
        want = np.asarray(jlosses.reg_loss_centernet(
            jnp.asarray(feat), jnp.asarray(target), jnp.asarray(inds), jnp.asarray(mask)))
        assert got.shape == (10,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        # a NaN target spreads NaN in both (NaN · 0 is NaN), as in the reference
        target[0, 0, 3] = np.nan
        got = losses.reg_loss_centernet(t(feat), t(target), t(inds), t(mask)).numpy()
        want = np.asarray(jlosses.reg_loss_centernet(
            jnp.asarray(feat), jnp.asarray(target), jnp.asarray(inds), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _heads(width):
    """(port head, JAX head) of the flagship (8-column gt) or of the voxel
    config with its vel branch (10-column gt), on a 12.8 m range."""
    path = FLAGSHIP_CFG if width == 8 else VOXEL_CFG
    cfg, jcfg = cfg_from_yaml_file(path, CfgDict()), j_cfg_from_yaml_file(path, JCfgDict())
    pcr, vs = [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], [0.1, 0.1, 0.2]
    dh, jdh = cfg.MODEL.DENSE_HEAD, jcfg.MODEL.DENSE_HEAD
    ta = dh.TARGET_ASSIGNER_CONFIG
    port = CenterHead(
        in_channels=8, class_names=cfg.CLASS_NAMES,
        class_names_each_head=dh.CLASS_NAMES_EACH_HEAD, shared_conv_channel=8,
        num_hm_conv=dh.NUM_HM_CONV, head_dict=dict(dh.SEPARATE_HEAD_CFG.HEAD_DICT),
        point_cloud_range=pcr, voxel_size=vs, feature_map_stride=ta.FEATURE_MAP_STRIDE,
        head_order=dh.SEPARATE_HEAD_CFG.HEAD_ORDER, gaussian_overlap=ta.GAUSSIAN_OVERLAP,
        min_radius=ta.MIN_RADIUS)
    jhead = JCenterHead(
        class_names=tuple(jcfg.CLASS_NAMES),
        class_names_each_head=tuple(tuple(x) for x in jdh.CLASS_NAMES_EACH_HEAD),
        shared_conv_channel=8, num_hm_conv=jdh.NUM_HM_CONV,
        head_order=tuple(jdh.SEPARATE_HEAD_CFG.HEAD_ORDER),
        head_dict=dict(jdh.SEPARATE_HEAD_CFG.HEAD_DICT), point_cloud_range=tuple(pcr),
        voxel_size=tuple(vs), feature_map_stride=ta.FEATURE_MAP_STRIDE,
        gaussian_overlap=ta.GAUSSIAN_OVERLAP, min_radius=ta.MIN_RADIUS, dtype=jnp.float32)
    stride = ta.FEATURE_MAP_STRIDE
    return port, jhead, (int(128 / stride), int(128 / stride)), len(cfg.CLASS_NAMES)


def _gt(rng, b, m, width, num_classes):
    gt = np.zeros((b, m, width), np.float32)
    gt[..., 0:2] = rng.uniform(-7, 7, (b, m, 2))          # some outside the range
    gt[..., 2] = rng.uniform(-2, 0, (b, m))
    gt[..., 3:6] = rng.uniform(0.3, 5, (b, m, 3))
    gt[:, 3, 3] = 0.0                                     # a zero-length box
    gt[..., 6] = rng.uniform(-3, 3, (b, m))
    if width == 10:
        gt[..., 7:9] = rng.uniform(-5, 5, (b, m, 2))
    gt[..., -1] = rng.randint(0, num_classes + 1, (b, m))  # class 0 is no class
    valid = rng.uniform(0, 1, (b, m)) > 0.2
    return gt, valid


@pytest.mark.parametrize("width", [8, 10])
def test_assign_targets_match_jax(width):
    port, jhead, (h, w), nc = _heads(width)
    rng = np.random.RandomState(width)
    gt, valid = _gt(rng, 2, 24, width, nc)
    want = jhead.apply({}, jnp.asarray(gt), jnp.asarray(valid), (h, w),
                       method=lambda m, g, v, s: m.assign_targets(g, v, s))
    got = port.assign_targets(t(gt), t(valid), (h, w))
    assert len(got) == len(want) == 6
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.heatmap.numpy(), np.asarray(wt.heatmap), atol=1e-6)
        np.testing.assert_array_equal(g.inds.numpy(), np.asarray(wt.inds))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(wt.mask))
        assert g.target_boxes.shape[-1] == width
        np.testing.assert_allclose(g.target_boxes.numpy(), np.asarray(wt.target_boxes),
                                   atol=1e-6)
    assert sum(int(g.mask.sum()) for g in got) > 10
    assert max(float(g.heatmap.max()) for g in got) == 1.0


def test_gaussian_radius_matches_jax():
    rng = np.random.RandomState(2)
    hw = rng.uniform(0.1, 60, (2, 500)).astype(np.float32)
    for overlap in (0.1, 0.7):
        np.testing.assert_allclose(
            gaussian_radius(t(hw[0]), t(hw[1]), overlap).numpy(),
            np.asarray(j_gaussian_radius(jnp.asarray(hw[0]), jnp.asarray(hw[1]), overlap)),
            rtol=1e-6)


class TestSegmentGrads:
    """The custom backwards against jax.vjp: ties, empty segments and ids out
    of range (dropped forward, no gradient)."""

    def _inputs(self, sort):
        rng = np.random.RandomState(3)
        n, s = 400, 50
        ids = rng.randint(0, s + 3, n)                      # s .. s + 2 out of range
        ids[np.isin(ids, [4, 31])] = 7                      # segments 4 and 31 empty
        vals = np.round(rng.normal(0, 1, (n, 5)), 1).astype(np.float32)  # many ties
        if sort:
            order = np.argsort(np.minimum(ids, s), kind="stable")
            ids, vals = np.minimum(ids, s)[order], vals[order]
        return vals, ids, s

    def test_segment_max_fast_grad(self):
        vals, ids, s = self._inputs(False)
        # rows dropped for their id hold the last segment's max, so only the
        # range check keeps them from counting as its winners
        assert (ids == s - 1).any()
        vals[ids >= s] = vals[ids == s - 1].max(0)
        cot = np.random.RandomState(4).normal(0, 1, (s, 5)).astype(np.float32)
        out, vjp = jax.vjp(lambda v: jvox.segment_max_fast(v, jnp.asarray(ids), s),
                           jnp.asarray(vals))
        want = np.asarray(vjp(jnp.asarray(cot))[0])
        tv = t(vals).requires_grad_()
        got = voxel.segment_max_fast(tv, t(ids), s)
        got.backward(t(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
        np.testing.assert_array_equal(tv.grad.numpy(), want)
        # ties: a segment whose max two rows share gives both the full gradient
        winners = (want != 0).sum(0)
        assert (winners > (s - 2)).any()
        assert (want[ids >= s] == 0).all()

    @pytest.mark.parametrize("sort", [False, True])
    def test_segment_broadcast_grad(self, sort):
        vals, ids, s = self._inputs(sort)
        table = np.random.RandomState(5).normal(0, 1, (s, 5)).astype(np.float32)
        cot = np.random.RandomState(6).normal(0, 1, vals.shape).astype(np.float32)
        out, vjp = jax.vjp(lambda tb: jvox.segment_broadcast(tb, jnp.asarray(ids), s, sort),
                           jnp.asarray(table))
        want = np.asarray(vjp(jnp.asarray(cot))[0])
        tt = t(table).requires_grad_()
        got = voxel.segment_broadcast(tt, t(ids), s, sort)
        got.backward(t(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
        np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
        assert (want[[4, 31]] == 0).all()


class _JBN(fnn.Module):
    """flax BatchNorm as the JAX package's 2D backbone and head use it."""
    keep: float
    eps: float

    @fnn.compact
    def __call__(self, x, train):
        return fnn.BatchNorm(use_running_average=not train, momentum=self.keep,
                             epsilon=self.eps, dtype=jnp.float32)(x)


def _bn_case(kind):
    """(port module, JAX module, numpy input, mask or None)."""
    rng = np.random.RandomState({"2d": 7, "head": 8, "masked": 9, "sparse": 10}[kind])
    c = 6
    if kind in ("2d", "head"):
        keep, eps = (0.99, 1e-3) if kind == "2d" else (0.9, 1e-5)
        x = rng.normal(1.5, 2.0, (2, 5, 7, c)).astype(np.float32)   # NHWC
        return BatchNorm(c, eps=eps, keep=keep), _JBN(keep, eps), x, None
    if kind == "masked":
        x = rng.normal(1.5, 2.0, (300, c)).astype(np.float32)
        mask = rng.uniform(0, 1, 300) > 0.3
        return MaskedBatchNorm(c), JMaskedBatchNorm(dtype=jnp.float32), x, mask
    x = rng.normal(1.5, 2.0, (2, 150, c)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 150)) > 0.3
    return SparseBatchNorm(c), JSparseBatchNorm(dtype=jnp.float32), x, mask


@pytest.mark.parametrize("kind", ["2d", "head", "masked", "sparse"])
def test_batchnorm_train_mode_matches_flax(kind):
    """Output, updated running statistics and the gradients of input, scale
    and bias against flax's train mode with mutable=["batch_stats"]."""
    port, jmod, x, mask = _bn_case(kind)
    rng = np.random.RandomState(11)
    c = x.shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.5, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    # the flax BatchNorm of _JBN sits one level down its tree
    wrap = (lambda d: {"BatchNorm_0": d}) if mask is None else (lambda d: d)
    extra = () if mask is None else (jnp.asarray(mask),)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)

    def f(xx, p):
        y, upd = jmod.apply({"params": wrap(p), "batch_stats": wrap(stats)}, xx, *extra,
                            train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, vjp, new_stats = jax.vjp(f, jnp.asarray(x), params, has_aux=True)
    gx, gp = vjp(jnp.asarray(cot))
    if mask is None:
        new_stats = new_stats["BatchNorm_0"]

    port.weight.data, port.bias.data = t(params["scale"]), t(params["bias"])
    port.running_mean.copy_(t(stats["mean"]))
    port.running_var.copy_(t(stats["var"]))
    port.train()
    tx = t(x).requires_grad_()
    if mask is None:   # the port's 2D BN takes NCHW
        out = port(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        out = port(tx, t(mask))
    out.backward(t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(new_stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(new_stats["var"]),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(np.asarray(new_stats["var"]), stats["var"])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(gp["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=1e-4, atol=1e-4)
    # eval: the running statistics, unchanged by the call
    port.eval()
    before = port.running_var.clone()
    with torch.no_grad():
        ev = port(tx.permute(0, 3, 1, 2)) if mask is None else port(tx, t(mask))
    assert torch.equal(before, port.running_var) and torch.isfinite(ev).all()


def _optim_cfg(name):
    cfg = cfg_from_yaml_file(FLAGSHIP_CFG, CfgDict()).OPTIMIZATION
    jcfg = j_cfg_from_yaml_file(FLAGSHIP_CFG, JCfgDict()).OPTIMIZATION
    cfg.OPTIMIZER = jcfg.OPTIMIZER = name
    return cfg, jcfg


def test_onecycle_schedule_matches_jax():
    cfg, _ = _optim_cfg("adam_onecycle")
    lr_max, total = float(cfg.LR), 100
    args = (lr_max, float(cfg.DIV_FACTOR), float(cfg.PCT_START), total)
    lr, jlr = optimization.onecycle_lr_fn(*args), jopt.onecycle_lr_fn(*args)
    mom = optimization.onecycle_mom_fn(cfg.MOMS, float(cfg.PCT_START), total)
    jmom = jopt.onecycle_mom_fn(cfg.MOMS, float(cfg.PCT_START), total)
    steps = range(total + 1)
    got_lr = np.array([lr(s) for s in steps])
    want_lr = np.array([float(jlr(s)) for s in steps])
    np.testing.assert_allclose(got_lr, want_lr, rtol=0, atol=1e-6 * lr_max)
    np.testing.assert_allclose([mom(s) for s in steps], [float(jmom(s)) for s in steps],
                               rtol=0, atol=1e-6)
    assert lr(0) == pytest.approx(lr_max / float(cfg.DIV_FACTOR), rel=1e-12)
    assert got_lr.max() == pytest.approx(lr_max)
    assert mom(0) == cfg.MOMS[0] and min(mom(s) for s in steps) == pytest.approx(cfg.MOMS[1])


@pytest.mark.parametrize("name,scale", [("adam_onecycle", 5.0), ("adam_onecycle", 0.05),
                                        ("adam", 5.0), ("sgd", 5.0)])
def test_optimizer_updates_match_optax(name, scale):
    """Three updates from identical gradients; scale 5 makes the global norm
    exceed GRAD_NORM_CLIP 10 (the clip acts), 0.05 keeps it below."""
    cfg, jcfg = _optim_cfg(name)
    rng = np.random.RandomState(12)
    shapes = {"a": (64, 3, 3, 3), "b": (17,), "c": (5, 7)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx, _ = jopt.build_optimizer(jcfg, total_steps=50)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = optimization.build_optimizer(tparams.values(), cfg, total_steps=50)
    norms = []
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = t(g[k].copy())
        norms.append((opt.step().item(), float(optax.global_norm(g))))
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_allclose(*zip(*norms), rtol=1e-6)
    assert opt.count == 3
    assert (min(n for n, _ in norms) > 10) == (scale == 5.0)


def _tiny_state():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    cfg, _ = _optim_cfg("adam_onecycle")
    opt = optimization.build_optimizer(model.parameters(), cfg, total_steps=20)
    return TrainState(model, opt)


def test_checkpoint_round_trip_and_rotation(tmp_path):
    state = _tiny_state()
    x = torch.randn(8, 3)
    for epoch in range(1, 6):
        state.optimizer.zero_grad()
        state.model(x).square().sum().backward()
        state.optimizer.step()
        checkpoint.save_checkpoint(tmp_path, state, epoch, max_ckpt_save_num=3)
    checkpoint.save_checkpoint(tmp_path, state, 5, name="latest_model")
    assert [e for e, _ in checkpoint.list_checkpoints(tmp_path)] == [3, 4, 5]
    assert (tmp_path / "latest_model.pth").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint_epoch_3.pth", "checkpoint_epoch_4.pth", "checkpoint_epoch_5.pth",
        "latest_model.pth"]

    payload, epoch = checkpoint.load_checkpoint(tmp_path / "checkpoint_epoch_5.pth")
    assert epoch == 5 and payload["it"] == 5
    assert set(payload) == {"model_state", "optimizer_state", "epoch", "it", "version"}
    fresh = _tiny_state()
    loaded, epoch = checkpoint.load_latest(tmp_path, fresh)
    assert loaded is fresh and epoch == 5 and fresh.step == 5
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    want, got = state.optimizer.opt.state_dict(), fresh.optimizer.opt.state_dict()
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(got["state"][i][k])), k
    assert want["param_groups"] == got["param_groups"]

    # a corrupt newest checkpoint is skipped; with none left, (None, -1)
    (tmp_path / "checkpoint_epoch_5.pth").write_bytes(b"not a checkpoint")
    assert checkpoint.load_latest(tmp_path, _tiny_state())[1] == 4
    assert checkpoint.load_latest(tmp_path / "missing") == (None, -1)
