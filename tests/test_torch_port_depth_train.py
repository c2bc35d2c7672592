"""Port parity for depth-completion training (pipeline 2's depth nets) against
the JAX package, on the CPU, fp32 on both sides, from the same numpy inputs
and weights (flax layout, carried by `params_from_jax`), at 32 × 64 with
widths (8, 16):

* ENet in train mode: the outputs, the updated BN statistics, the gradients
  of the stage-weighted masked L2 loss against jax.value_and_grad, and the
  parameters after one Adam step of `tools.train_depth.DepthTrainStep`
  against optax.adam applied to the same gradients;
* PENetC1 / PENetC2 / PENetC4 forward in train and eval mode (and the weight
  bridge with no key left over); PENetC2's gradients of the refined L2
  loss; one PENetC2 step with the backbone frozen: its parameters unchanged
  in both packages (optax.multi_transform's set_to_zero, the port's
  optimizer without them), its BN statistics changed and equal across them;
* `patches` and `cspn_iterate` at dilations 1, 2 and 4, both resize modes
  of PENetC2 (antialiased bilinear and nearest-exact against
  jax.image.resize), `CSPNGuide`'s partition of unity, the masked losses;
* the depth metrics, the meter, the CSV files and the comparison PNG
  against `dfu3d_tpu.eval.depth_metrics`;
* the per-step learning rate against optax.piecewise_constant_schedule for
  both curves and the frozen case, and the JAX script's helpers
  (tools/train_depth.py, imported by path);
* the CLI on 6 synthetic frames for 3 epochs: the JAX script's frames, split
  and per-epoch order from the same seed; val.csv, best.txt and a
  checkpoint that `tools.complete_depth --ckpt` loads; val RMSE improves;
* `spherical_min_range_resample` against JAX on a seeded cloud.

Tolerances: outputs within OUT_TOL of their largest |value|; each gradient
leaf within GRAD_TOL of its largest |entry|; BN running means within 1e-5
and variances within 1e-5 · (|var| + (1 - keep) · mean_b²) (the batch
variance is the one-pass E[x²] - mean²); parameters after Adam within
PARAM_TOL; `patches`, `cspn_iterate` and the resizes within OP_TOL of the
largest |value| (the guides, a conv stack, within OUT_TOL);
metrics within 1e-6 relative; masks, orders and frames exact.
"""
import csv
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from dfu3d_tpu.core.voxel import spherical as jsph
from dfu3d_tpu.eval import depth_metrics as jdm
from dfu3d_tpu.models import depth_completion as jdc
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import spherical as tsph
from dfu3d_tpu_torch.eval import depth_metrics as tdm
from dfu3d_tpu_torch.models import depth_completion as tdc
from dfu3d_tpu_torch.tools import complete_depth as tcd
from dfu3d_tpu_torch.tools import train_depth as ttd

from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

H, W = 32, 64
WIDTHS = (8, 16)
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6
OP_TOL = 1e-6
METRIC_TOL = 1e-6
LR = 1e-3
INTR = (np.float32(31.5), np.float32(15.25), np.float32(720.0), np.float32(700.0))
REPO = Path(__file__).resolve().parents[1]


def jax_script():
    """The JAX package's tools/train_depth.py, imported by path."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("jax_train_depth",
                                                  REPO / "tools" / "train_depth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frame(seed=0, keep=0.1):
    """One synthetic frame from the JAX script's helper: rgb (1, H, W, 3),
    sparse input and supervision (1, H, W, 1)."""
    rng = np.random.RandomState(seed)
    rgb, dense = ttd.synthetic_frame(rng, H, W)
    kept = rng.rand(H, W) < keep
    sd = np.where(kept, dense, 0.0).astype(np.float32)
    sup = np.where(~kept, dense, 0.0).astype(np.float32)
    return rgb[None], sd[None, ..., None], sup[None, ..., None]


def nchw(a):
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max |diff| {err} > {tol} x {scale}"


def check_grads(got, want):
    """Every leaf within GRAD_TOL of its largest |entry|."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close(got[k].numpy(), w.numpy(), GRAD_TOL, f"grad {k}")


def check_bn_stats(model, jstats, old, changed=None):
    """BN buffers against JAX's updated batch_stats (see the module doc);
    `changed` (a key prefix): those must differ from `old`."""
    buffers = dict(model.named_buffers())
    assert set(jstats) == set(buffers)
    keep = tdc.DEPTH_BN_KEEP
    for k, want in jstats.items():
        want = want.numpy()
        tol = 1e-5 * (1 + np.abs(want))
        if k.endswith("running_var"):
            mod = k.rsplit(".", 1)[0]
            mean_b = (jstats[f"{mod}.running_mean"].numpy()
                      - keep * old[f"{mod}.running_mean"].numpy()) / (1 - keep)
            tol = 1e-5 * (np.abs(want) + (1 - keep) * mean_b ** 2)
        assert (np.abs(buffers[k].numpy() - want) <= tol).all(), k
        if changed is not None and k.startswith(changed):
            assert not np.array_equal(want, old[k].numpy()), k


def build_pair(name, seed=0):
    """(the JAX module, its numpy variables, the port model carrying them)."""
    rgb, sd, _ = frame()
    jm = getattr(jdc, name)(widths=WIDTHS)
    v = jax.device_get(numpy_variables(
        lambda: jm.init(jax.random.PRNGKey(0), rgb, sd, *INTR, train=False), seed=seed))
    port = getattr(tdc, name)(widths=WIDTHS, device="cpu")
    state = params_from_jax(v)
    assert set(state) == set(port.state_dict())     # no key left over on either side
    port.load_state_dict(state)
    return jm, v, port


def adam_reference(params, grads):
    """optax.adam(LR) applied once, on {name: numpy} trees."""
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


# ---------------------------------------------------------------------- ENet


def test_enet_train_step_matches_jax():
    """Train-mode outputs, BN statistics and stage-weighted gradients against
    JAX, then one DepthTrainStep against optax.adam on the same gradients."""
    jm, v, port = build_pair("ENet")
    rgb, sd, sup = frame()
    w1, w2 = ttd.stage_weights(0)

    def loss_fn(params):
        (fused, cd, dd), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                        rgb, sd, *INTR, train=True, mutable=["batch_stats"])
        loss = ((1.0 - w1 - w2) * jdc.masked_l2_loss(fused, sup)
                + w1 * jdc.masked_l2_loss(cd, sup) + w2 * jdc.masked_l2_loss(dd, sup))
        return loss, ((fused, cd, dd), upd["batch_stats"])

    (wloss, (wouts, wstats)), wgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])

    port.train()
    outs = port(nchw(rgb), nchw(sd), *INTR)
    for name, g, w in zip(("fused", "cd", "dd"), outs, wouts):
        assert_close(nhwc(g), w, OUT_TOL, name)
    check_bn_stats(port, params_from_jax({"batch_stats": jax.device_get(wstats)}),
                   params_from_jax({"batch_stats": v["batch_stats"]}), changed="")

    # the same step through the CLI's train step, from the carried weights
    _, _, port = build_pair("ENet")
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    step = ttd.DepthTrainStep(port, False, tdc.masked_l2_loss, LR, 4, False, False,
                              torch.device("cpu"), torch.float32)
    loss, pred, _ = step((rgb[0], sd[0, ..., 0], sup[0, ..., 0], INTR), w1, w2)
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=OUT_TOL)
    assert_close(nhwc(pred), wouts[0], OUT_TOL, "pred")
    grads = {k: p.grad for k, p in port.named_parameters()}
    check_grads(grads, params_from_jax({"params": jax.device_get(wgrads)}))
    want = adam_reference({k: p.numpy() for k, p in before.items()},
                          {k: g.numpy() for k, g in grads.items()})
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=PARAM_TOL * (1 + np.abs(want[k]).max()), err_msg=k)
        assert not torch.equal(p, before[k]), k


def test_masked_losses_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.rand(1, 1, H, W).astype(np.float32) * 30
    tgt = np.where(rng.rand(1, 1, H, W) < 0.3, rng.rand(1, 1, H, W) * 30, 0).astype(np.float32)
    for tf, jf in ((tdc.masked_l2_loss, jdc.masked_l2_loss),
                   (tdc.masked_l1_loss, jdc.masked_l1_loss)):
        got = tf(torch.from_numpy(pred), torch.from_numpy(tgt)).item()
        np.testing.assert_allclose(got, float(jf(pred, tgt)), rtol=1e-6)
        # no supervised pixel: the max(Σmask, 1) denominator gives 0, not NaN
        assert tf(torch.from_numpy(pred), torch.zeros(1, 1, H, W)).item() == 0.0


# --------------------------------------------------------------------- PENet


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["PENetC1", "PENetC2", "PENetC4"])
def test_penet_forward_matches_jax(name, train):
    jm, v, port = build_pair(name)
    rgb, sd, _ = frame(1)
    (refined, coarse, (cd, dd)), upd = jm.apply(v, rgb, sd, *INTR, train=train,
                                                mutable=["batch_stats"])
    port.train(train)
    with torch.no_grad():
        got = port(nchw(rgb), nchw(sd), *INTR)
    assert_close(nhwc(got[0]), refined, OUT_TOL, "refined")
    assert_close(nhwc(got[1]), coarse, OUT_TOL, "coarse")
    assert_close(nhwc(got[2][1]), dd, OUT_TOL, "dd")
    if train:
        check_bn_stats(port, params_from_jax({"batch_stats": jax.device_get(upd["batch_stats"])}),
                       params_from_jax({"batch_stats": v["batch_stats"]}), changed="")
    else:
        assert all(torch.equal(b, params_from_jax({"batch_stats": v["batch_stats"]})[k])
                   for k, b in port.named_buffers())


@pytest.fixture(scope="module")
def penet_c2_grads():
    """JAX's refined-L2 loss, gradients and updated BN statistics of PENetC2
    in train mode, and (under --freeze_backbone's multi_transform) the
    parameters after one Adam step."""
    jm, v, _ = build_pair("PENetC2")
    rgb, sd, sup = frame(2)

    def loss_fn(params):
        (refined, _, _), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                        rgb, sd, *INTR, train=True, mutable=["batch_stats"])
        return jdc.masked_l2_loss(refined, sup), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    labels = {k: ("frozen" if k == "backbone" else "train") for k in v["params"]}
    tx = optax.multi_transform({"train": optax.adam(LR), "frozen": optax.set_to_zero()},
                               labels)
    updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    frozen_params = optax.apply_updates(v["params"], updates)
    return {"v": v, "frame": (rgb, sd, sup), "loss": float(loss),
            "grads": params_from_jax({"params": jax.device_get(grads)}),
            "stats": params_from_jax({"batch_stats": jax.device_get(stats)}),
            "frozen_params": params_from_jax({"params": jax.device_get(frozen_params)})}


def test_penet_c2_gradients_match_jax(penet_c2_grads):
    _, _, port = build_pair("PENetC2")
    rgb, sd, sup = penet_c2_grads["frame"]
    port.train()
    refined = port(nchw(rgb), nchw(sd), *INTR)[0]
    loss = tdc.masked_l2_loss(refined, nchw(sup))
    loss.backward()
    np.testing.assert_allclose(loss.item(), penet_c2_grads["loss"], rtol=OUT_TOL)
    check_grads({k: p.grad for k, p in port.named_parameters()}, penet_c2_grads["grads"])


def test_penet_c2_frozen_backbone_step_matches_jax(penet_c2_grads):
    """--freeze_backbone: no update and no Adam state for the backbone, its BN
    statistics still updated (train mode), in both packages."""
    _, _, port = build_pair("PENetC2")
    rgb, sd, sup = penet_c2_grads["frame"]
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    old_stats = params_from_jax({"batch_stats": penet_c2_grads["v"]["batch_stats"]})
    step = ttd.DepthTrainStep(port, True, tdc.masked_l2_loss, LR, 4, False, True,
                              torch.device("cpu"), torch.float32)
    loss, _, _ = step((rgb[0], sd[0, ..., 0], sup[0, ..., 0], INTR))
    np.testing.assert_allclose(loss.item(), penet_c2_grads["loss"], rtol=OUT_TOL)
    in_optimizer = {id(p) for g in step.optimizer.param_groups for p in g["params"]}
    jax_after = penet_c2_grads["frozen_params"]
    trained = {k: p for k, p in port.named_parameters() if not k.startswith("backbone.")}
    want = adam_reference({k: before[k].numpy() for k in trained},
                          {k: p.grad.numpy() for k, p in trained.items()})
    for k, p in port.named_parameters():
        if k.startswith("backbone."):
            assert id(p) not in in_optimizer and p.grad is None, k
            assert torch.equal(p, before[k]) and torch.equal(jax_after[k], before[k]), k
        else:
            assert_close(p.grad.numpy(), penet_c2_grads["grads"][k].numpy(), GRAD_TOL, k)
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                       atol=PARAM_TOL * (1 + np.abs(want[k]).max()), err_msg=k)
            assert not torch.equal(p, before[k]) and not torch.equal(jax_after[k], before[k]), k
    check_bn_stats(port, penet_c2_grads["stats"], old_stats, changed="backbone.")


# ------------------------------------------------------------ CSPN and resize


@pytest.mark.parametrize("k,dilation", [(3, 1), (5, 2), (7, 4), (3, 4)])
def test_patches_and_cspn_iterate_match_jax(k, dilation):
    rng = np.random.RandomState(k + dilation)
    x = rng.rand(2, 9, 11, 1).astype(np.float32) * 10
    np.testing.assert_array_equal(
        nhwc(tdc.patches(nchw(x), k, dilation)), np.asarray(jdc._patches(x, k, dilation)))
    guide = rng.randn(2, 9, 11, k * k).astype(np.float32)
    guide /= np.abs(guide).sum(-1, keepdims=True)
    sparse = np.where(rng.rand(2, 9, 11, 1) < 0.2, x + 1, 0).astype(np.float32)
    valid = (sparse > 1e-3).astype(np.float32)
    want = jdc.cspn_iterate(x, guide, sparse, valid, k, dilation, 6)
    got = tdc.cspn_iterate(nchw(x), nchw(guide), nchw(sparse), nchw(valid), k, dilation, 6)
    assert_close(nhwc(got), want, OP_TOL, "cspn_iterate")
    pinned = valid[..., 0] > 0
    np.testing.assert_array_equal(nhwc(got)[..., 0][pinned], sparse[..., 0][pinned])


@pytest.mark.parametrize("size", [(16, 32), (15, 33)])
def test_resizes_match_jax_image_resize(size):
    """PENetC2's resizes: the half-resolution depth (bilinear, antialiased)
    and sparse map (nearest), and back up (bilinear). torch's defaults
    (nearest, bilinear without antialias) differ on the way down."""
    rng = np.random.RandomState(5)
    x = rng.rand(1, *size, 1).astype(np.float32) * 30
    half = (size[0] // 2, size[1] // 2)
    down = jax.image.resize(x, (1, *half, 1), "bilinear")
    assert_close(nhwc(tdc.resize_bilinear(nchw(x), half)), down, OP_TOL, "bilinear down")
    near = np.asarray(jax.image.resize(x, (1, *half, 1), "nearest"))
    np.testing.assert_array_equal(nhwc(tdc.resize_nearest(nchw(x), half)), near)
    up = jax.image.resize(down, x.shape, "bilinear")
    assert_close(nhwc(tdc.resize_bilinear(nchw(np.asarray(down)), size)), up, OP_TOL,
                 "bilinear up")
    plain = torch.nn.functional.interpolate(nchw(x), size=half, mode="nearest")
    assert not np.array_equal(nhwc(plain), near)


def test_cspn_guide_is_a_partition_of_unity():
    rng = np.random.RandomState(6)
    feats = rng.randn(1, 8, 12, 6).astype(np.float32)
    for k in (3, 5, 7):
        jm = jdc.CSPNGuide(k)
        v = jax.device_get(numpy_variables(lambda: jm.init(jax.random.PRNGKey(0), feats, False)))
        port = tdc.CSPNGuide(6, k)
        port.load_state_dict(params_from_jax(v))
        port.train()
        got = port(nchw(feats))
        want, _ = jm.apply(v, feats, True, mutable=["batch_stats"])
        assert got.dtype == torch.float32 and got.shape[1] == k * k
        assert_close(nhwc(got), want, OUT_TOL, f"guide {k}")
        torch.testing.assert_close(got.sum(1), torch.ones(1, 8, 12), rtol=0, atol=1e-6)


# ------------------------------------------------------------------- metrics


def test_depth_metrics_match_jax():
    rng = np.random.RandomState(7)
    preds = [rng.rand(H, W).astype(np.float32) * 40 + 0.5 for _ in range(3)]
    gts = [np.where(rng.rand(H, W) < 0.4, rng.rand(H, W) * 40, 0).astype(np.float32)
           for _ in range(3)]
    tmeter, jmeter = tdm.DepthAverageMeter(), jdm.DepthAverageMeter()
    for p, g in zip(preds, gts):
        got, want = tdm.evaluate_depth_np(p, g), jdm.evaluate_depth_np(p, g)
        on_tensors = tdm.metrics_to_host(tdm.evaluate_depth(torch.from_numpy(p),
                                                            torch.from_numpy(g)))
        assert set(got) == set(want) == set(tdm.METRIC_KEYS) == set(jdm.METRIC_KEYS)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_TOL, err_msg=k)
            assert on_tensors[k] == got[k], k
        tmeter.update(got)
        jmeter.update(want)
    tavg, javg = tmeter.average(), jmeter.average()
    for k in javg:
        np.testing.assert_allclose(tavg[k], javg[k], rtol=METRIC_TOL, err_msg=k)
    assert tdm.DepthAverageMeter().average() == jdm.DepthAverageMeter().average()


def test_csv_logger_matches_jax(tmp_path):
    assert tdm.DEPTH_CSV_FIELDS == jdm.DEPTH_CSV_FIELDS
    avg = jdm.evaluate_depth_np(np.full((H, W), 10.0, np.float32),
                                np.full((H, W), 12.0, np.float32))
    worse = {k: v * 2 for k, v in avg.items()}
    better = {k: v / 2 for k, v in avg.items()}
    logs = {}
    for name, mod in (("port", tdm), ("jax", jdm)):
        log = mod.DepthCsvLogger(tmp_path / name)
        bests = [log.append("train", 0, avg, gpu_time=1.5), log.append("val", 0, avg),
                 log.append("val", 1, worse), log.append("val", 2, better)]
        logs[name] = (bests, log.best_rmse)
    assert logs["port"] == logs["jax"] and logs["port"][0] == [False, True, False, True]
    for f in ("train.csv", "val.csv", "best.txt"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f
    with open(tmp_path / "port" / "val.csv") as f:
        assert list(csv.DictReader(f).fieldnames) == jdm.DEPTH_CSV_FIELDS


def test_comparison_png_matches_jax(tmp_path):
    rgb, sd, sup = frame(8)
    pred = np.random.RandomState(8).rand(H, W).astype(np.float32) * 30
    rows = {"port": [tdm.comparison_row(rgb[0], sd[0, ..., 0], pred, sup[0, ..., 0])] * 2,
            "jax": [jdm.comparison_row(rgb[0], sd[0, ..., 0], pred, sup[0, ..., 0])] * 2}
    np.testing.assert_array_equal(rows["port"][0], rows["jax"][0])
    tdm.save_img_comparison(tmp_path / "port.png", rows["port"])
    jdm.save_img_comparison(tmp_path / "jax.png", rows["jax"])
    got = np.asarray(Image.open(tmp_path / "port.png").convert("RGB"))
    assert got.shape == (2 * H, 4 * W, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax.png")))


# ------------------------------------------------------- schedule and the CLI


def test_schedule_matches_optax_and_the_jax_helpers():
    """lr_at_step against the JAX script's optax schedule (its decay dicts,
    tools/train_depth.py:211-212) at every epoch boundary and the steps
    beside it, for the 'pe' curve (a CSPN net trained whole) and the 'e'
    curve (ENet, or a CSPN net with its backbone frozen)."""
    jscript = jax_script()
    spe = 3
    for model in ("enet", "penet_c1", "penet_c2"):
        for freeze in (False, True):
            cspn = model != "enet"
            pe = cspn and not freeze
            decay = ({10: 0.5, 20: 0.2, 30: 0.1, 40: 0.05, 50: 0.02} if pe
                     else {10: 0.5, 15: 0.2, 25: 0.1})
            sched = optax.piecewise_constant_schedule(LR, {e * spe: f for e, f in decay.items()})
            for epoch in range(60):
                for s in (epoch * spe - 1, epoch * spe, epoch * spe + 1):
                    if s >= 0:
                        np.testing.assert_allclose(ttd.lr_at_step(LR, s, spe, pe),
                                                   float(sched(s)), rtol=1e-6)
                np.testing.assert_allclose(ttd.lr_at_step(LR, epoch * spe, spe, pe),
                                           jscript.lr_for_epoch(LR, epoch, pe), rtol=1e-6)
                assert ttd.lr_for_epoch(LR, epoch, pe) == jscript.lr_for_epoch(LR, epoch, pe)
                assert ttd.stage_weights(epoch) == jscript.stage_weights(epoch)


def test_init_is_seeded_and_the_cli_needs_a_card(monkeypatch):
    a = ttd.build_model("penet_c2", WIDTHS, 3, "cpu").state_dict()
    b = ttd.build_model("penet_c2", WIDTHS, 3, "cpu").state_dict()
    c = ttd.build_model("penet_c2", WIDTHS, 4, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["guide7_s2.gen.Conv_0.weight"], c["guide7_s2.gen.Conv_0.weight"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttd.main(["--synthetic", "2", "--epochs", "1", "--height", "32", "--width", "64"])
    for cls in (tdc.PENetC1, tdc.PENetC2, tdc.PENetC4):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(widths=WIDTHS)


def test_cli_trains_and_complete_depth_loads_its_checkpoint(tmp_path):
    """The JAX test's run (6 synthetic frames, 3 epochs, 32 × 64, widths
    (8, 16), lr 3e-3) through the port's CLI on the CPU in fp32."""
    jscript = jax_script()
    out = tmp_path / "run"
    res = ttd.train(["--synthetic", "6", "--epochs", "3", "--height", str(H), "--width", str(W),
                     "--widths", *map(str, WIDTHS), "--lr", "3e-3", "--out", str(out),
                     "--seed", "0", "--device", "cpu", "--dtype", "float32"])
    # the JAX script's draws from RandomState(seed): frames, then each epoch's order
    rng = np.random.RandomState(0)
    want = []
    for _ in range(6):
        rgb, dense = jscript.synthetic_frame(rng, H, W)
        keep = rng.rand(H, W) < 0.05
        want.append((rgb, np.where(keep, dense, 0.0), np.where(~keep, dense, 0.0)))
    orders = [rng.permutation(5) for _ in range(3)]
    val, train = res["frames"]
    assert len(val) == 1 and len(train) == 5
    for got, w in zip(val + train, want):
        for g, x in zip(got[:3], w):
            np.testing.assert_array_equal(g, x.astype(np.float32))
    for got, w in zip(res["orders"], orders):
        np.testing.assert_array_equal(got, w)

    with open(out / "val.csv") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == jdm.DEPTH_CSV_FIELDS and len(rows) == 3
    assert np.isfinite(res["best_rmse"]) and res["best_rmse"] < float(rows[0]["rmse"])
    assert (out / "best.txt").read_text().startswith("epoch=")
    assert all(np.isfinite(s["loss"]) for s in res["steps"]) and len(res["steps"]) == 15
    assert (out / "comparison_best.png").exists() and (out / "comparison_2.png").exists()

    from dfu3d_tpu_torch.pseudo import synthetic

    root = tmp_path / "root"
    synthetic.make_dataset(root, n_train=1, n_val=0, n_instances=2)
    done = tcd.main(["--detpath", str(root), "--ckpt", str(res["ckpt"]), "--widths",
                     *map(str, WIDTHS), "--out_dir", str(tmp_path / "depth"), "--device", "cpu",
                     "--dtype", "float32"])
    (path,) = done["written"]
    depth = np.load(path)
    assert depth.shape == (352, 1216) and np.isfinite(depth).all() and (depth > 0).any()


def test_kitti_frames_match_jax(tmp_path):
    """--detpath: each frame's bottom-centre crop, LiDAR sparse depth and
    intrinsics against the JAX script's load_kitti_frame (PIL, its own
    calibration), and the input / supervision split from the same draws."""
    from types import SimpleNamespace

    from dfu3d_tpu_torch.pseudo import synthetic

    jscript = jax_script()
    root = tmp_path / "root"
    synthetic.make_dataset(root, n_train=2, n_val=0, n_instances=2)
    h, w = 96, 320
    args = SimpleNamespace(synthetic=0, detpath=str(root), gt_dir=None, height=h, width=w,
                           keep_frac=0.8)
    got = ttd.make_frames(args, np.random.RandomState(0))
    rng = np.random.RandomState(0)
    assert len(got) == 2
    for idx, frame in zip(("000000", "000001"), got):
        rgb, sd, gt, intr = jscript.load_kitti_frame(root, idx, h, w, None)
        assert gt is None and (sd > 0).sum() > 100
        keep = rng.rand(h, w) < 0.8
        np.testing.assert_array_equal(frame[0], rgb)
        np.testing.assert_array_equal(frame[1], np.where(keep & (sd > 0), sd, 0.0))
        np.testing.assert_array_equal(frame[2], np.where(~keep & (sd > 0), sd, 0.0))
        np.testing.assert_allclose(frame[3], intr, rtol=1e-6)


# ------------------------------------------------------------------ spherical


@pytest.mark.parametrize("keep", ["min_range", "first"])
def test_spherical_resample_matches_jax(keep):
    rng = np.random.RandomState(9)
    n = 3000
    pts = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-3, 2, (n, 1))],
                         1).astype(np.float32)
    pts[:800] = pts[800:1600] * np.float32(0.5)     # the same directions, nearer
    pts[2000:2100] = pts[2100:2200]                 # exact duplicates: the first index wins
    valid = rng.rand(n) < 0.9
    for res in (0.002, 0.02):
        want = np.asarray(jsph.spherical_min_range_resample(
            jnp.asarray(pts), jnp.asarray(valid), res, res, keep))
        got = tsph.spherical_min_range_resample(torch.from_numpy(pts), torch.from_numpy(valid),
                                                res, res, keep).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid.sum()
