"""Port parity for PointRCNN training against the JAX package, on the CPU,
fp32 on both sides, from the same numpy inputs and weights (flax layout,
carried by `params_from_jax`), at tests/test_pointrcnn.py's tiny widths:

* the point head's losses and coder (`sigmoid_focal_loss`,
  `weighted_smooth_l1`, `point_encode` and its round trip through
  `point_decode`), `boxes_to_corners_3d` and `assign_point_targets`;
* the proposal target layer (`_subsample_rois`, `assign_roi_targets` in both
  SAMPLE_ROI_BY_EACH_CLASS branches and both CLS_SCORE_TYPEs) with JAX's own
  draws handed in, `canonicalize_gt_of_rois`, the RoI losses and the FC
  stacks' dropout;
* the whole train forward and its gradients against jax.value_and_grad of
  the JAX model's apply(train=True), and one `make_train_step` (clip and
  adam_onecycle included) against JAX's;
* the shipped config built for training at full width, `tools.train` on it
  from a synthetic root, the reference checkpoint mappings of the two heads,
  and the train step's span profile;
* the workload of `profile_train --model pointrcnn` and chip_smoke.py's
  train steps: `zoo.proposal_gt` (every frame gets a RoI over
  REG_FG_THRESH) and `zoo.write_pointrcnn_root(training=True)` read in train
  mode.

JAX's draws (threefry) cannot be reproduced in torch: the tests read the key
JAX's model hands `assign_roi_targets` (a debug callback) and compute from it
the uniforms JAX draws, `split(key, B)`, then `split(k)` and `uniform(k1|k2,
(P,))`, and hand those to the port.

Tolerances: labels, masks, gathers and sampled RoI indices are exact (the
targets test accepts a differing index only where an IoU lies within
STRADDLE of a threshold, on either side of it in the two packages, and
prints such cases); geometry within GEOM_TOL (cos / sin may differ by an
ulp); losses within LOSS_TOL relative; each gradient leaf within GRAD_TOL of
that leaf's largest |entry| (sums in another order); BN running statistics
within 1e-5, the variances within 1e-5 of var + (1 - keep) · mean_b² (the
batch variance is the one-pass E[x²] - mean_b²); parameters after the
optimizer step within PARAM_TOL.

The two whole-model tests run at weight seeds 3 and 4. The scene clusters
points at the gt centres (so that RoIs lie over REG_FG_THRESH), and the RoI
head's grouped maxes then see near-ties between neighbouring points: at
seeds 4 and 7 the two packages' pooled inputs, ~1e-5 apart, break one such
tie differently, and even from equal inputs the head's MLPs round
differently (at seed 4 two candidates of a sa1 max lie 4e-7 apart), which
moves the stage-2 gradients by 0.4-0.6 %. So inside these tests the port's
RoI head reads JAX's four pooled inputs (each first checked within POOL_TOL
of the port's own, the pooled samples equal; gradients still flow through
the port's graph, `ReplaceValue`) and takes each of its grouped maxes where
JAX takes it: the values stay the port's own MLP outputs, checked within
POOL_TOL of JAX's, and only the choice among near-tied candidates is JAX's.
`test_roi_head_gradients_match_jax_on_the_models_inputs` holds the head
alone at seed 4 from the model's own inputs. JAX's whole-model programs
are traced and compiled once, with the weights as arguments, and run at
both seeds.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.core.geometry import boxes as jboxes
from dfu3d_tpu.core.geometry.iou import pairwise_iou3d as j_pairwise_iou3d
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import losses as jlosses
from dfu3d_tpu.models import pointrcnn as jprcnn
from dfu3d_tpu.models import roi_head as jroi
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch import profile_serve
from dfu3d_tpu_torch.convert import load_torch_state, params_from_jax
from dfu3d_tpu_torch.core.geometry import boxes as pboxes
from dfu3d_tpu_torch.core.geometry import pairwise_iou3d
from dfu3d_tpu_torch.data import kitti_synthetic
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.flagship import seeded_weights_
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import losses as plosses
from dfu3d_tpu_torch.models import pointrcnn as pprcnn
from dfu3d_tpu_torch.models.pointnet2_backbone import masked_max
from dfu3d_tpu_torch.models import roi_head as proi
from dfu3d_tpu_torch.tools import create_infos, train as train_cli
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict
from dfu3d_tpu_torch.zoo import (POINTRCNN_CFG, pointrcnn, pointrcnn_batches, proposal_gt,
                                  write_pointrcnn_root)

from test_model import CLASS_NAMES, make_batch, tiny_grid
from test_pointrcnn import prcnn_cfg
from test_torch_port_models import numpy_variables

GEOM_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
STRADDLE = 1e-5
POOL_TOL = 1e-4     # of the largest |entry|: JAX's pooled inputs and grouped-max candidates vs the port's
WEIGHT_SEEDS = [3, 4]
TOTAL_STEPS = 100
TINY_MEAN = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, b, n, extent=8.0, size=(0.5, 3.0)):
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0:2] = rng.uniform(0, extent, (b, n, 2))
    bx[..., 2] = rng.uniform(-1, 1, (b, n))
    bx[..., 3:6] = rng.uniform(*size, (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    return bx


def jax_draws(key, b, p):
    """The (B, 2, P) uniforms assign_roi_targets and _subsample_rois draw
    from `key` (roi_head.py:219, :226, :299)."""
    out = []
    for k in jax.random.split(jnp.asarray(key), b):
        k1, k2 = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(k1, (p,))),
                    np.asarray(jax.random.uniform(k2, (p,)))])
    return torch.from_numpy(np.asarray(out, np.float32))


def grad_of(fn, *arrays):
    """fn's value and its gradients with respect to the torch leaves made
    from `arrays`."""
    leaves = [t(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    out.backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def test_point_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (2, 50, 3)).astype(np.float32)
    logits[0, :3] = 0.0   # the BCE's max at its kink
    onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 50))][..., 1:]
    w = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    jfocal = jax.value_and_grad(lambda x: jnp.sum(jlosses.sigmoid_focal_loss(x, onehot, w)))
    want, wgrad = jfocal(logits)
    got, (ggrad,) = grad_of(lambda x: plosses.sigmoid_focal_loss(x, t(onehot), t(w)).sum(),
                            logits)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    np.testing.assert_allclose(ggrad, wgrad, rtol=LOSS_TOL, atol=1e-7)

    pred = rng.normal(0, 0.3, (2, 50, 8)).astype(np.float32)
    target = pred + rng.normal(0, 0.15, pred.shape).astype(np.float32)  # both sides of β
    code_w = [1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 3.0, 1.0]
    for cw in (None, code_w):
        jsl1 = jax.value_and_grad(lambda p: jnp.sum(
            jlosses.weighted_smooth_l1(p, target, w, code_weights=cw)))
        want, wgrad = jsl1(pred)
        got, (ggrad,) = grad_of(lambda p: plosses.weighted_smooth_l1(
            p, t(target), t(w), code_weights=cw).sum(), pred)
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
        np.testing.assert_allclose(ggrad, wgrad, rtol=LOSS_TOL, atol=1e-7)


def test_point_encode_and_corners_match_jax():
    rng = np.random.RandomState(1)
    gt = random_boxes(rng, 2, 40)
    gt[0, :2, 3] = 0.0          # a size floored at 1e-5
    pts = gt[..., :3] + rng.normal(0, 0.5, (2, 40, 3)).astype(np.float32)
    cls = rng.randint(1, 4, (2, 40))
    want = np.asarray(jprcnn.point_encode(*map(jnp.asarray, (gt, pts, cls)), TINY_MEAN))
    got = pprcnn.point_encode(t(gt), t(pts), t(cls), TINY_MEAN).numpy()
    np.testing.assert_allclose(got, want, **GEOM_TOL)
    back = pprcnn.point_decode(t(got), t(pts), t(cls), TINY_MEAN).numpy()
    np.testing.assert_allclose(back[..., :3], gt[..., :3], **GEOM_TOL)
    np.testing.assert_allclose(back[..., 3:6], np.maximum(gt[..., 3:6], 1e-5), rtol=1e-5)
    np.testing.assert_allclose(back[..., 6], gt[..., 6], **GEOM_TOL)   # gt in (-π, π)

    flat = gt.reshape(-1, 7)
    np.testing.assert_allclose(pboxes.boxes_to_corners_3d(t(flat)).numpy(),
                               np.asarray(jboxes.boxes_to_corners_3d(jnp.asarray(flat))),
                               **GEOM_TOL)
    unit = pboxes.boxes_to_corners_3d(torch.tensor([[0.0, 0, 0, 2, 4, 6, 0]]))[0]
    np.testing.assert_array_equal(unit[0].numpy(), [1, 2, -3])
    np.testing.assert_array_equal(unit[6].numpy(), [-1, -2, 3])


def test_assign_point_targets_matches_jax():
    """A box face, the enlarged ring (-1), invalid points, an invalid gt and
    overlapping boxes (the first one wins), then random scenes."""
    gt = np.zeros((2, 4, 8), np.float32)
    gt[0, 0] = [0, 0, 0, 2, 2, 2, 0, 2]
    gt[0, 1] = [0.5, 0, 0, 2, 2, 2, 0.3, 3]     # overlaps box 0
    gt[0, 2] = [4, 4, 0, 2, 2, 2, 0, 1]         # invalid
    gt[1, :, :7] = random_boxes(np.random.RandomState(2), 1, 4, extent=3.0)[0]
    gt[1, :, 7] = [1, 2, 3, 1]
    gvalid = np.array([[True, True, False, False], [True, True, True, False]])
    pts = np.random.RandomState(3).uniform(-1.5, 4.5, (2, 300, 3)).astype(np.float32)
    pts[0, :6] = [[0.2, 0.1, 0.0],     # in boxes 0 and 1: class of box 0
                  [-1.0, 0.0, 0.0],    # on box 0's face, outside box 1
                  [-1.1, 0.0, 0.0],    # in box 0's enlarged ring only
                  [4.0, 4.0, 0.0],     # inside the invalid box
                  [0.0, 0.0, 0.0],     # invalid point inside box 0
                  [-1.0, 0.5, 1.0]]    # on an edge of box 0
    pvalid = np.ones((2, 300), bool)
    pvalid[0, 4] = False
    pvalid[:, -20:] = False
    jt = jax.vmap(jprcnn.assign_point_targets)
    wl, wm = (np.asarray(a) for a in jt(*map(jnp.asarray, (pts, pvalid, gt, gvalid))))
    gl, gm = pprcnn.assign_point_targets(t(pts), t(pvalid), t(gt), t(gvalid))
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert wl[0, :6].tolist() == [2, 2, -1, 0, -1, 2]
    assert (wl == 0).any() and (wl == -1).any() and (wl[1] > 0).sum() > 3


def roi_scene(rng, scenario, b=2, p=64, g=6):
    """Proposals jittered around gt boxes and background ones; the jitter
    sets the IoUs. Scenarios: "fg_starved" (a few fg RoIs, many hard and easy
    bg), "all_background" (no RoI near a gt), "few_candidates" (fewer
    proposals than ROI_PER_IMAGE)."""
    gt = np.zeros((b, g, 8), np.float32)
    gt[..., :7] = random_boxes(rng, b, g, extent=20.0, size=(1.0, 4.0))
    gt[..., 7] = rng.randint(1, 4, (b, g))
    gvalid = np.ones((b, g), bool)
    gvalid[:, -1] = False
    if scenario == "few_candidates":
        p = 20
    pick = rng.randint(0, g, (b, p))
    rois = np.take_along_axis(gt[..., :7], pick[..., None], 1).copy()
    jitter = {"fg_starved": 0.6, "all_background": 0.0, "few_candidates": 0.25}[scenario]
    rois[..., 0:3] += rng.normal(0, jitter, (b, p, 3))
    rois[..., 3:6] *= rng.uniform(0.8, 1.25, (b, p, 3))
    rois[..., 6] += rng.normal(0, 0.2, (b, p))
    if scenario == "all_background":
        rois[..., 0:2] += 40.0
    n_far = p // 4
    rois[:, -n_far:] = random_boxes(rng, b, n_far, extent=60.0)
    labels = np.where(rng.uniform(size=(b, p)) < 0.7,
                      np.take_along_axis(gt[..., 7], pick, 1), rng.randint(1, 4, (b, p)))
    scores = rng.uniform(size=(b, p)).astype(np.float32)
    return rois.astype(np.float32), labels.astype(np.int32), scores, gt, gvalid


def _tcfg(by_class, cls_type):
    cfg = jroi.roi_head_target_cfg(prcnn_cfg()["ROI_HEAD"])
    cfg.update(ROI_PER_IMAGE=32, SAMPLE_ROI_BY_EACH_CLASS=by_class, CLS_SCORE_TYPE=cls_type)
    assert cfg == proi.roi_head_target_cfg(CfgDict(prcnn_cfg()["ROI_HEAD"])) | dict(
        ROI_PER_IMAGE=32, SAMPLE_ROI_BY_EACH_CLASS=by_class, CLS_SCORE_TYPE=cls_type)
    return cfg


def _straddles(a, b, thresholds):
    """Entries whose two IoUs lie within STRADDLE of a threshold and on its
    two sides."""
    hit = np.zeros(a.shape, bool)
    for th in thresholds:
        near = (np.abs(a - th) <= STRADDLE) & (np.abs(b - th) <= STRADDLE)
        hit |= near & ((a >= th) != (b >= th))
    return hit


def _overlaps(rois, labels, gt, gvalid, by_class):
    """Each proposal's max IoU as JAX's and the port's targets compute it."""
    if by_class:
        want = jax.jit(jax.vmap(lambda r, rl, g, gv: jroi.max_iou_with_same_class(
            r, rl, g, g[:, -1].astype(jnp.int32), gv)[0]))(rois, labels, gt, gvalid)
        got = proi.max_iou_with_same_class(t(rois), t(labels).long(), t(gt), t(gt[..., -1]).long(),
                                           t(gvalid))[0]
    else:
        want = jnp.max(jnp.where(gvalid[:, None, :], jax.jit(jax.vmap(j_pairwise_iou3d))(
            rois, gt[..., :7]), 0.0), axis=2)
        got = torch.where(t(gvalid)[:, None, :], pairwise_iou3d(t(rois), t(gt[..., :7])),
                          0.0).amax(-1)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("scenario", ["fg_starved", "all_background", "few_candidates"])
def test_roi_targets_match_jax(scenario):
    """Both SAMPLE_ROI_BY_EACH_CLASS branches and both CLS_SCORE_TYPEs per
    scenario (every pairing across the three), JAX's draws handed in.
    `_subsample_rois` from JAX's own IoUs is exact; the whole layer's
    sampled indices are exact unless an IoU straddles a sampling threshold
    (0.1, REG_FG_THRESH), and its labels unless one straddles a label
    threshold; such cases are counted and printed."""
    rng = np.random.RandomState({"fg_starved": 4, "all_background": 5, "few_candidates": 6}
                                [scenario])
    rois, labels, scores, gt, gvalid = roi_scene(rng, scenario)
    b, p = labels.shape
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key, b, p)
    keys = jax.random.split(key, b)
    flips = 0
    # each scenario runs both branches and both score types, paired in turn
    pairs = {"fg_starved": ((True, "cls"), (False, "roi_iou")),
             "all_background": ((True, "roi_iou"), (False, "cls")),
             "few_candidates": ((True, "cls"), (False, "roi_iou"))}[scenario]
    for by_class, cls_type in pairs:
        tcfg = _tcfg(by_class, cls_type)
        want = {k: np.asarray(v) for k, v in jax.jit(
            lambda *a: jroi.assign_roi_targets(key, *a, tcfg))(
            rois, labels, scores, gt, gvalid).items()}
        got = {k: v.numpy() for k, v in proi.assign_roi_targets(
            draws, t(rois), t(labels).long(), t(scores), t(gt), t(gvalid), tcfg).items()}
        assert set(got) == set(want)
        port_o, jax_o = _overlaps(rois, labels, gt, gvalid, by_class)
        # the sampler alone, from JAX's IoUs, per frame: exact
        alone = np.asarray(jax.jit(jax.vmap(lambda k, o: jroi._subsample_rois(k, o, tcfg)))(
            keys, jax_o))
        np.testing.assert_array_equal(alone, want["sampled_idx"])
        np.testing.assert_array_equal(proi._subsample_rois(draws, t(jax_o), tcfg).numpy(),
                                      alone)
        # the whole layer
        sampling = (0.1, tcfg["REG_FG_THRESH"])
        same = (got["sampled_idx"] == want["sampled_idx"]).all(axis=1)
        for i in np.flatnonzero(~same):
            assert _straddles(port_o[i], jax_o[i], sampling).any(), (scenario, by_class,
                                                                      cls_type, i)
            flips += 1
        label_th = sampling + (tcfg["CLS_BG_THRESH"], tcfg["CLS_FG_THRESH"])
        ok = same[:, None] & ~_straddles(got["gt_iou_of_rois"], want["gt_iou_of_rois"],
                                         label_th)
        flips += int((same[:, None] & ~ok).sum())
        for k in ("roi_labels", "roi_scores", "reg_valid_mask"):
            np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=k)
        for k in ("rcnn_cls_labels", "rois", "gt_iou_of_rois", "gt_of_rois",
                  "gt_of_rois_src"):
            np.testing.assert_allclose(got[k][ok], want[k][ok], err_msg=k, **GEOM_TOL)
        fg = want["gt_iou_of_rois"] >= 0.55
        if scenario == "fg_starved":
            assert 0 < fg.sum(1).max() < 16 and (want["gt_iou_of_rois"] < 0.1).any()
            assert ((want["gt_iou_of_rois"] >= 0.1) & ~fg).any()       # hard bg
        elif scenario == "all_background":
            assert not fg.any() and (want["gt_iou_of_rois"] < 0.1).all()
        else:
            assert p < tcfg["ROI_PER_IMAGE"]
            # the refill wraps: some proposal is sampled twice
            assert all(len(set(s)) < len(s) for s in want["sampled_idx"])
    print(f"{scenario}: {flips} sampled frames or labels differ by a straddled threshold")


def test_canonicalize_gt_of_rois_matches_jax():
    """RoI and gt headings near ±π/2 (the flip), π and the 2π seam."""
    rng = np.random.RandomState(8)
    special = np.array([np.pi / 2, -np.pi / 2, np.pi, -np.pi, 2 * np.pi, 0.0, 3 * np.pi / 2],
                       np.float32)
    eps = np.array([-1e-3, -1e-6, 0.0, 1e-6, 1e-3], np.float32)
    heads = (special[:, None] + eps[None, :]).reshape(-1)
    n = heads.size
    rois = random_boxes(rng, 1, n * n)[0]
    gt = np.concatenate([random_boxes(rng, 1, n * n)[0], rng.randint(1, 4, (n * n, 1))], -1)
    rois[:, 6] = np.repeat(heads, n)
    gt[:, 6] = np.tile(heads, n) + rng.choice([0.0, np.pi / 2, np.pi], n * n)
    gt = gt.astype(np.float32)
    want = np.asarray(jroi.canonicalize_gt_of_rois(jnp.asarray(rois), jnp.asarray(gt)))
    got = proi.canonicalize_gt_of_rois(t(rois), t(gt)).numpy()
    np.testing.assert_allclose(got, want, **GEOM_TOL)
    assert np.abs(got[:, 6]).max() <= np.pi / 2 and (np.abs(want[:, 6]) > 1.5).any()


def roi_loss_inputs(rng, cls_loss, b=2, m=24):
    """RoIs, their gt (half of them turned by π) in both frames, labels and
    random network outputs: one logit per RoI for BinaryCrossEntropy, two
    for CrossEntropy (one makes it 0)."""
    rois = random_boxes(rng, b, m)
    src = rois.copy()
    src[..., 0:3] += rng.normal(0, 0.2, (b, m, 3))
    src[..., 3:6] *= rng.uniform(0.9, 1.1, (b, m, 3))
    src[..., 6] += rng.choice([0.0, np.pi], (b, m)) + rng.normal(0, 0.1, (b, m))
    src = np.concatenate([src, np.ones((b, m, 1))], -1).astype(np.float32)
    ct = np.asarray(jroi.canonicalize_gt_of_rois(jnp.asarray(rois), jnp.asarray(src)))
    labels = rng.choice([-1.0, 0.0, 0.3, 0.8, 1.0], (b, m)).astype(np.float32)
    targets = {"rois": rois, "gt_of_rois": ct, "gt_of_rois_src": src,
               "reg_valid_mask": (rng.uniform(size=(b, m)) < 0.5).astype(np.int32),
               "rcnn_cls_labels": labels}
    shape = (b, m) if cls_loss == "BinaryCrossEntropy" else (b, m, 2)
    cls = rng.normal(0, 2, shape).astype(np.float32)
    reg = rng.normal(0, 0.3, (b, m, 7)).astype(np.float32)
    return targets, cls, reg


@pytest.mark.parametrize("cls_loss", ["BinaryCrossEntropy", "CrossEntropy"])
def test_roi_losses_match_jax(cls_loss):
    rng = np.random.RandomState(9)
    targets, cls, reg = roi_loss_inputs(rng, cls_loss)
    lcfg = jroi.roi_head_loss_cfg({"LOSS_CONFIG": {
        "CLS_LOSS": cls_loss, "LOSS_WEIGHTS": {"code_weights": [1.0, 1, 1, 2, 1, 1, 0.5],
                                               "rcnn_corner_weight": 2.0}}})
    assert lcfg == proi.roi_head_loss_cfg(CfgDict({"LOSS_CONFIG": {
        "CLS_LOSS": cls_loss, "LOSS_WEIGHTS": {"code_weights": [1.0, 1, 1, 2, 1, 1, 0.5],
                                               "rcnn_corner_weight": 2.0}}}))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    pt = {k: t(v) for k, v in targets.items()}

    def jfn(c, r):
        total, tb = jroi.roi_head_loss(c, r, jt, lcfg)
        return total, tb

    (wtotal, wtb), wgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        cls, reg)
    c, r = t(cls).requires_grad_(True), t(reg).requires_grad_(True)
    total, tb = proi.roi_head_loss(c, r, pt, lcfg)
    total.backward()
    assert set(tb) == set(wtb) == {"rcnn_loss_reg", "rcnn_loss_corner", "rcnn_loss_reg_total",
                                   "rcnn_loss_cls", "rcnn_loss"}
    for k in tb:
        np.testing.assert_allclose(tb[k].item(), float(wtb[k]), rtol=LOSS_TOL, err_msg=k)
    assert float(wtb["rcnn_loss_corner"]) > 0 and float(wtb["rcnn_loss_cls"]) > 0
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(wgrads[0]), rtol=LOSS_TOL, atol=1e-7)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(wgrads[1]), rtol=1e-4, atol=1e-6)


def test_roi_reg_loss_skips_overflowed_bg_rois():
    """A RoI outside reg_valid_mask whose size overflows the corner
    distances (1e20 m, as an untrained RPN can propose) changes neither the
    loss nor any gradient, as in the reference, which indexes the fg RoIs;
    the JAX package's mask product gives NaN there."""
    rng = np.random.RandomState(10)
    targets, cls, reg = roi_loss_inputs(rng, "BinaryCrossEntropy")
    lcfg = jroi.roi_head_loss_cfg({})
    bg = np.argwhere(targets["reg_valid_mask"] == 0)[0]
    huge = {k: v.copy() for k, v in targets.items()}
    huge["rois"][tuple(bg)][3:6] = 1e20
    huge["gt_of_rois"] = np.asarray(jroi.canonicalize_gt_of_rois(
        jnp.asarray(huge["rois"]), jnp.asarray(huge["gt_of_rois_src"])))
    jtotal, _ = jroi.roi_head_loss(jnp.asarray(cls), jnp.asarray(reg),
                                   {k: jnp.asarray(v) for k, v in huge.items()}, lcfg)
    assert np.isnan(float(jtotal))
    out = []
    for tg in (targets, huge):
        r = t(reg).requires_grad_(True)
        total, tb = proi.roi_head_loss(t(cls), r, {k: t(v) for k, v in tg.items()}, lcfg)
        total.backward()
        out.append((total.detach(), r.grad))
    assert torch.isfinite(out[1][0]) and torch.isfinite(out[1][1]).all()
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert out[1][1][tuple(bg)].abs().max() == 0


def test_fc_stack_dropout():
    """Identity in eval and without a generator; in training, inverted
    dropout after block 0: zeros at about rate p, the kept units scaled by
    1 / (1 - p), the same mask from the same seed."""
    torch.manual_seed(0)
    p = 0.3
    stack = proi.FCStack(16, (256, 64), None, dp_ratio=p)
    plain = proi.FCStack(16, (256, 64), None)
    plain.load_state_dict(stack.state_dict())
    x = torch.randn(512, 16)
    stack.eval(), plain.eval()
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(stack(x, gen), plain(x))
    block0 = torch.relu(stack.bn0(stack.fc0(x)))
    seen = {}

    def spy(module, args):
        seen["h"] = args[0]

    stack.train()
    handle = stack.fc1.register_forward_pre_hook(spy)
    try:
        assert torch.equal(stack(x), stack(x))     # no generator: no dropout
        stack(x, torch.Generator().manual_seed(2))
        h = seen["h"]
        stack(x, torch.Generator().manual_seed(2))
        assert torch.equal(seen["h"], h)
    finally:
        handle.remove()
    stack.train()
    block0 = torch.relu(stack.bn0(stack.fc0(x)))
    live = block0 > 0
    dropped = (h == 0) & live
    rate = dropped.sum().item() / live.sum().item()
    assert abs(rate - p) < 0.01, rate
    kept = (h != 0)
    torch.testing.assert_close(h[kept], block0[kept] / (1 - p))


def fg_scene(rng, b=2, n=256, m=8):
    """make_batch's scene with gt boxes of their class's mean size, heading
    0, and 12 points within 8 % of each valid box's centre: with the point
    head's reg_out at 0 every point proposes a mean-size box at itself, so
    RoIs of a matching class lie over REG_FG_THRESH."""
    pts, pvalid, gt, gvalid = make_batch(rng, b=b, n=n, m=m)
    gt[..., 6] = 0.0
    gt[..., 3:6] = np.asarray(TINY_MEAN, np.float32)[gt[..., 7].astype(int) - 1]
    k = 0
    for i in range(b):
        for j in np.flatnonzero(gvalid[i]):
            off = rng.uniform(-0.08, 0.08, (12, 3)) * gt[i, j, 3:6]
            pts[i, k:k + 12, :3] = gt[i, j, :3] + off
            k = (k + 12) % (n - 40)
    return PointBatch.from_numpy(pts, pvalid, gt, gvalid)


def tiny_variables(jmodel, jbatch, seed):
    """numpy weights of the tiny model, the point head's reg_out at 0."""
    variables = numpy_variables(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch, train=False), seed=seed)
    head = variables["params"]["point_head"]["reg_out"]
    head["kernel"], head["bias"] = np.zeros_like(head["kernel"]), np.zeros_like(head["bias"])
    return variables


class CaptureTargets:
    """Wraps JAX's assign_roi_targets and reads, through debug callbacks,
    the key the model hands it and its sampled indices and reg masks."""

    def __init__(self, monkeypatch, seen=None):
        self.seen = {} if seen is None else seen
        orig = jroi.assign_roi_targets

        def wrapped(key, *a, **k):
            jax.debug.callback(lambda kk: self.seen.__setitem__("key", np.asarray(kk)), key)
            out = orig(key, *a, **k)
            jax.debug.callback(lambda s, r: self.seen.update(sampled_idx=np.asarray(s),
                                                             reg_valid_mask=np.asarray(r)),
                               out["sampled_idx"], out["reg_valid_mask"])
            return out

        monkeypatch.setattr(jroi, "assign_roi_targets", wrapped)


def capture_port_targets(monkeypatch):
    seen = {}
    orig = proi.assign_roi_targets

    def wrapped(*a, **k):
        seen.update(orig(*a, **k))
        return seen

    monkeypatch.setattr(proi, "assign_roi_targets", wrapped)
    return seen


def one_thread_grads(model_fn, batch, draws):
    """The port's gradients of the same forward run on one thread: the
    other fp32 summation order that check_grads measures rounding by."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = model_fn()
        loss, _ = model(batch, roi_uniforms=draws)
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    return {k: p.grad for k, p in model.named_parameters()}


def check_grads(got, want, reordered):
    """Every gradient leaf within GRAD_TOL of its largest |entry| or, where
    fp32 rounding alone moves it more, within 4x what summing in another
    order moves the port's own (`reordered`: the same step on one thread;
    a BN bias behind a grouped max sums thousands of rows that nearly
    cancel). With the point head's reg_out at 0 nothing flows into its
    reg_fc stack: those leaves are exactly 0 on both sides, and only
    those."""
    assert set(got) == set(want)
    widened = []
    for k, w in want.items():
        w = w.numpy()
        scale = np.abs(w).max()
        if k.startswith("point_head.reg_fc."):
            assert scale == 0 and not got[k].any(), k
            continue
        assert scale > 0, k
        err = np.abs(got[k].numpy() - w).max()
        spread = np.abs(got[k].numpy() - reordered[k].numpy()).max()
        assert err <= max(GRAD_TOL * scale, 4 * spread), (k, err / scale, spread / scale)
        widened += [k] if err > GRAD_TOL * scale else []
    print(f"{len(widened)} gradient leaves beyond {GRAD_TOL:g} of their largest entry, within "
          f"4x the port's own reordering: {widened}")


def check_bn_stats(model, jstats, old_stats):
    buffers, modules = dict(model.named_buffers()), dict(model.named_modules())
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
        assert not np.array_equal(want, old_stats[k].numpy()), k


@pytest.fixture(scope="module")
def tiny():
    jmodel = j_build_network(prcnn_cfg(), CLASS_NAMES, tiny_grid())
    batch = fg_scene(np.random.RandomState(12))
    jbatch = JPointBatch(*(x.numpy() for x in batch))
    return jmodel, batch, jbatch


class ReplaceValue(torch.autograd.Function):
    """`value` in the forward pass, the identity for x's gradient."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replaced(name, got, want):
    """JAX's `want` in place of the port's `got` (checked within POOL_TOL)."""
    scale = np.abs(want).max()
    assert np.abs(got.detach().numpy() - want).max() <= POOL_TOL * scale, name
    return ReplaceValue.apply(got, torch.from_numpy(np.array(want)))


def jax_tie_break_max(name, g, mask, dim, want):
    """The port's grouped max over `dim` of its own candidates `g`, taken
    where JAX's candidates `want` (checked within POOL_TOL of g) have their
    maximum: the mean of the port's values at JAX's maxima (JAX's max sends
    its gradient in equal parts to exact ties), 0 for a group with no valid
    entry. The values stay the port's, only the choice is JAX's; each chosen
    value lies within POOL_TOL of the port's own max."""
    scale = np.abs(want).max()
    assert np.abs(g.detach().numpy() - want).max() <= POOL_TOL * scale, name
    valid = np.broadcast_to(mask.numpy(), want.shape)
    jg = np.where(valid, want, -np.inf)
    chosen = torch.from_numpy(valid & (jg == jg.max(axis=dim, keepdims=True)))
    count = chosen.sum(dim).clamp(min=1)
    h = torch.where(chosen, g, 0.0).sum(dim) / count
    own = masked_max(g, mask, dim).detach()
    assert (h.detach() - own).abs().max() <= POOL_TOL * scale, name
    return h


def hand_jax_roi_inputs(model, seen, monkeypatch):
    """Make the port's RoI head read JAX's pooled inputs (`seen` of the same
    weights and batch; the samples must be the same, the values within
    POOL_TOL of the port's own) and take each of its grouped maxes where JAX
    takes it (`jax_tie_break_max`, candidates matched by shape). Returns the
    model."""
    pool = model.pool_rois

    def pooled(*a, **k):
        got = pool(*a, **k)
        names = ("local", "prefix", "feats", "valid")
        np.testing.assert_array_equal(got[3].numpy(), seen["roi_inputs"][3])
        return tuple(g if n == "valid" else replaced(n, g, w)
                     for n, g, w in zip(names, got, seen["roi_inputs"]))

    def grouped_max(g, mask, dim):
        (name,) = [n for n, w in seen["roi_sa"].items() if w.shape == tuple(g.shape)]
        return jax_tie_break_max(name, g, mask, dim, seen["roi_sa"][name])

    model.pool_rois = pooled
    monkeypatch.setattr(pprcnn, "masked_max", grouped_max)
    return model


@pytest.fixture(scope="module")
def jax_programs(tiny):
    """JAX's whole train forward with its gradients (jax.value_and_grad of
    apply(train=True)) and one make_train_step (the shipped config's
    adam_onecycle over TOTAL_STEPS, clip 10) of the tiny model, each traced
    and compiled once with the weights as arguments. Debug callbacks read,
    into `seen`, the key the model hands assign_roi_targets, its sampled
    indices and reg masks, the RoI head's four inputs and its SA levels'
    MLP outputs (the candidates of its grouped maxes)."""
    jmodel, _, jbatch = tiny
    variables = tiny_variables(jmodel, jbatch, seed=WEIGHT_SEEDS[0])
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        CaptureTargets(mp, seen)
        head_call = jprcnn.PointRCNNRoIHead.__call__

        def recording(self, local_xyz, prefix, feats, sample_valid, train):
            jax.debug.callback(
                lambda *xs: seen.__setitem__("roi_inputs", [np.asarray(x) for x in xs]),
                local_xyz, prefix, feats, sample_valid)
            return head_call(self, local_xyz, prefix, feats, sample_valid, train)

        mp.setattr(jprcnn.PointRCNNRoIHead, "__call__", recording)
        mlp = jprcnn.PointRCNNRoIHead._mlp

        def recording_mlp(self, x, mask, widths, name, train, bn=None):
            out = mlp(self, x, mask, widths, name, train, bn=bn)
            if name.startswith("sa"):
                jax.debug.callback(
                    lambda v, n=name: seen.setdefault("roi_sa", {}).__setitem__(n, np.asarray(v)),
                    out)
            return out

        mp.setattr(jprcnn.PointRCNNRoIHead, "_mlp", recording_mlp)

        def loss_fn(params, batch_stats):
            (loss, tb), upd = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, jbatch, train=True,
                mutable=["batch_stats"], rngs={"sampler": jax.random.PRNGKey(5)})
            return loss, (tb, upd["batch_stats"])

        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            variables["params"], variables["batch_stats"]).compile()

        import optax
        jcfg = j_cfg_from_yaml_file(POINTRCNN_CFG, JCfgDict())
        tx, _ = j_build_optimizer(jcfg.OPTIMIZATION, TOTAL_STEPS)
        grads_seen = {}

        def recording_update(grads, state, params=None):
            grads_seen["g"] = grads
            return tx.update(grads, state, params)

        rtx = optax.GradientTransformation(tx.init, recording_update)
        step = j_make_train_step(jmodel, rtx)

        def run(st, b):
            new, metrics = step(st, b)
            return new, metrics, grads_seen["g"]

        train = jax.jit(run).lower(jax_state(rtx, variables), jbatch).compile()
    return {"seen": seen, "grad": grad, "train": train, "rtx": rtx}


def jax_state(rtx, variables):
    return JTrainState(jnp.zeros((), jnp.int32), variables["params"],
                       variables["batch_stats"], rtx.init(variables["params"]))


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
def test_train_forward_and_gradients_match_jax(tiny, jax_programs, monkeypatch, seed):
    """The whole train forward (B=2, 256 points, fp32) and its gradients
    against jax.value_and_grad of the JAX model's apply(train=True), with
    JAX's sampler draws and the RoI head's values handed in; BN running
    statistics after it."""
    jmodel, batch, jbatch = tiny
    variables = tiny_variables(jmodel, jbatch, seed=seed)
    seen = jax_programs["seen"]
    seen.clear()
    (wloss, (wtb, wstats)), wgrads = jax_programs["grad"](variables["params"],
                                                          variables["batch_stats"])
    assert seen["reg_valid_mask"].sum() > 0          # fg RoIs: reg and corner losses act
    assert float(wtb["rcnn_reg_loss"]) > 0

    def model_fn():
        return hand_jax_roi_inputs(params_from_jax(variables, build_network(
            CfgDict(prcnn_cfg()), CLASS_NAMES, tiny_grid(), device="cpu", train=True)), seen,
            monkeypatch)

    draws = jax_draws(seen["key"], 2, 32)
    model = model_fn()
    ported = capture_port_targets(monkeypatch)
    loss, tb = model(batch, roi_uniforms=draws)
    loss.backward()
    np.testing.assert_array_equal(ported["sampled_idx"].numpy(), seen["sampled_idx"])
    np.testing.assert_array_equal(ported["reg_valid_mask"].numpy(), seen["reg_valid_mask"])
    assert set(tb) == set(wtb) == {"point_cls_loss", "point_reg_loss", "rcnn_cls_loss",
                                   "rcnn_reg_loss", "rpn_loss"}
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=LOSS_TOL)
    for k in tb:
        np.testing.assert_allclose(tb[k].item(), float(wtb[k]), rtol=LOSS_TOL, err_msg=k)
    check_grads({k: p.grad for k, p in model.named_parameters()},
                params_from_jax({"params": wgrads}), one_thread_grads(model_fn, batch, draws))
    check_bn_stats(model, params_from_jax({"batch_stats": wstats}),
                   params_from_jax({"batch_stats": variables["batch_stats"]}))


def test_roi_head_gradients_match_jax_on_the_models_inputs(tiny):
    """The RoI head in train mode (masked BN, the grouped maxes, the FC
    stacks) on the pooled inputs the whole model gives it, at weight seed 4:
    its parameter gradients and the gradient it sends back into the pooled
    backbone features, against JAX's PointRCNNRoIHead on the same inputs.
    At this seed the two whole models' pooled inputs differ by ~1e-5 (fp32
    sums in another order) and a near-tie in a grouped max over the
    clustered fg points then goes the other way, which moves the whole
    model's stage-2 gradients by ~0.6 %; from equal inputs they agree
    within GRAD_TOL."""
    jmodel, batch, jbatch = tiny
    variables = tiny_variables(jmodel, jbatch, seed=4)
    model = build_network(CfgDict(prcnn_cfg()), CLASS_NAMES, tiny_grid(), device="cpu",
                          train=True)
    params_from_jax(variables, model)
    seen, head = {}, model.roi_head.forward

    def recording(*a):
        seen["in"] = [x.detach().clone() for x in a[:4]]
        return head(*a)

    model.roi_head.forward = recording
    model(batch, roi_uniforms=torch.rand(2, 2, 32, generator=torch.Generator().manual_seed(0)))
    del model.roi_head.forward
    local, prefix, feats, valid = (x.numpy() for x in seen["in"])
    assert valid.any(axis=1).sum() > 8
    rh, sa = prcnn_cfg()["ROI_HEAD"], prcnn_cfg()["ROI_HEAD"]["SA_CONFIG"]
    jhead = jprcnn.PointRCNNRoIHead(
        num_samples=local.shape[1], xyz_up=tuple(rh["XYZ_UP_LAYER"]),
        sa_npoints=tuple(sa["NPOINTS"]), sa_radii=tuple(sa["RADIUS"]),
        sa_nsamples=tuple(sa["NSAMPLE"]), sa_mlps=tuple(tuple(m) for m in sa["MLPS"]),
        cls_fc=tuple(rh["CLS_FC"]), reg_fc=tuple(rh["REG_FC"]), use_bn=False)
    rng = np.random.RandomState(0)
    w_cls = rng.normal(size=local.shape[0]).astype(np.float32)
    w_reg = rng.normal(size=(local.shape[0], 7)).astype(np.float32)
    stats = variables["batch_stats"]["roi_head"]

    def jfn(params, f):
        (c, r), _ = jhead.apply({"params": params, "batch_stats": stats}, local, prefix, f,
                                valid, True, mutable=["batch_stats"])
        return jnp.sum(c * w_cls) + jnp.sum(r * w_reg)

    want, (wparams, wfeats) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        variables["params"]["roi_head"], feats)
    f = t(feats).requires_grad_(True)
    model.roi_head.zero_grad()
    c, r = model.roi_head(t(local), t(prefix), f, t(valid))
    got = (c * t(w_cls)).sum() + (r * t(w_reg)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    jg = params_from_jax({"params": wparams})
    for k, p in model.roi_head.named_parameters():
        scale = np.abs(jg[k].numpy()).max()
        assert scale > 0, k
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)
    wfeats = np.asarray(wfeats)
    np.testing.assert_allclose(f.grad.numpy(), wfeats, rtol=0,
                               atol=GRAD_TOL * np.abs(wfeats).max())


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
def test_train_step_matches_jax(tiny, jax_programs, monkeypatch, seed):
    """One make_train_step of each package from the same weights, with the
    shipped config's adam_onecycle (clip 10) over 100 steps: metrics, the
    raw gradients, the updated parameters and BN statistics. The port's
    sampler draws are JAX's, read from the key its train step's fold_in
    makes, and its RoI head reads JAX's values."""
    jmodel, batch, jbatch = tiny
    variables = tiny_variables(jmodel, jbatch, seed=seed)
    seen = jax_programs["seen"]
    seen.clear()
    new_state, jmetrics, jgrads = jax.device_get(
        jax_programs["train"](jax_state(jax_programs["rtx"], variables), jbatch))
    assert seen["reg_valid_mask"].sum() > 0

    def model_fn():
        return hand_jax_roi_inputs(params_from_jax(variables, build_network(
            CfgDict(prcnn_cfg()), CLASS_NAMES, tiny_grid(), device="cpu", train=True)), seen,
            monkeypatch)

    model = model_fn()
    cfg = yaml.safe_load(POINTRCNN_CFG.read_text())
    tstate = create_train_state(model, CfgDict(cfg["OPTIMIZATION"]), TOTAL_STEPS)
    draws = jax_draws(seen["key"], 2, 32)
    monkeypatch.setattr(pprcnn, "draw_roi_uniforms", lambda gen, shape, device: draws)
    raw, opt_step = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return opt_step()

    tstate.optimizer.step = snapshot
    ported = capture_port_targets(monkeypatch)
    metrics = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)(batch)
    np.testing.assert_array_equal(ported["sampled_idx"].numpy(), seen["sampled_idx"])
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=LOSS_TOL, err_msg=k)
    assert float(metrics["grad_norm"]) > 10     # the clip acted
    check_grads(raw, params_from_jax({"params": jgrads}), one_thread_grads(model_fn, batch, draws))
    # Adam's first step moves an entry by lr·g / (|g| + eps), about ±lr
    # whatever the gradient's size: where the two packages' gradients differ
    # by more than 2 % of it (rounding noise on a gradient near 0) the
    # parameters may differ by up to 2 lr; everywhere else within PARAM_TOL
    want = params_from_jax({"params": new_state.params})
    jg = params_from_jax({"params": jgrads})
    lr0 = tstate.optimizer.lr_fn(0)
    unsure = 0
    for k, p in model.named_parameters():
        got, w = p.detach().numpy(), want[k].numpy()
        g, wg = raw[k].numpy(), jg[k].numpy()
        sure = np.abs(g - wg) <= 0.02 * np.abs(wg)
        tol = PARAM_TOL * (1 + np.abs(w).max())
        np.testing.assert_allclose(got[sure], w[sure], rtol=0, atol=tol, err_msg=k)
        assert (np.abs(got - w)[~sure] <= 2 * lr0 + tol).all(), k
        unsure += int((~sure & (wg != 0)).sum())
    n = sum(p.numel() for p in model.parameters())
    print(f"{unsure} of {n} parameters with a gradient that rounding moves by more than 2 %")
    assert unsure < 1e-3 * n
    check_bn_stats(model, params_from_jax({"batch_stats": new_state.batch_stats}),
                   params_from_jax({"batch_stats": variables["batch_stats"]}))
    assert tstate.step == 1


def test_step_generators_follow_the_update_count():
    """Each step's sampler and dropout generators are seeded from (17 | 23,
    the update count): a resumed run draws what an uninterrupted one draws."""
    from dfu3d_tpu_torch.train import train_state

    dev = torch.device("cpu")
    a = torch.rand(8, generator=train_state.step_generator(dev, train_state.SAMPLER_SEED, 3))
    b = torch.rand(8, generator=train_state.step_generator(dev, train_state.SAMPLER_SEED, 3))
    c = torch.rand(8, generator=train_state.step_generator(dev, train_state.SAMPLER_SEED, 4))
    d = torch.rand(8, generator=train_state.step_generator(dev, train_state.DROPOUT_SEED, 3))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_shipped_config_trains_at_full_width():
    """build_network(train=True) of the shipped config: the published widths
    (4,040,104 parameters) in train mode; one train step on a small input
    (B=1, 512 points, so every FPS level repeats points) gives finite losses
    under JAX's keys and a gradient on every parameter. Without a card, the
    default device raises."""
    cfg, _, model = pointrcnn(device="cpu", train=True)
    assert model.training and sum(p.numel() for p in model.parameters()) == 4_040_104
    assert model.train_proposal_nms == dict(pre_max=4096, post_max=128, thresh=0.8,
                                            score_thresh=None)
    assert model.target_cfg["CLS_FG_THRESH"] == 0.6 and model.target_cfg["ROI_PER_IMAGE"] == 128
    seeded_weights_(model, seed=0)
    pts, pvalid, gt, gvalid = make_batch(np.random.RandomState(5), b=1, n=512)
    gt[..., 7] = np.random.RandomState(6).randint(1, 9, gt.shape[:2])
    state = create_train_state(model, cfg.OPTIMIZATION, 10)
    metrics = make_train_step(model, state.optimizer, device="cpu", dtype=torch.float32)(
        PointBatch.from_numpy(pts, pvalid, gt, gvalid))
    assert {"loss", "point_cls_loss", "point_reg_loss", "rcnn_cls_loss", "rcnn_reg_loss",
            "rpn_loss", "grad_norm"} == set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pointrcnn(train=True)


def _ref_shape(key, port_shape):
    """The reference tensor's shape for a port weight: Conv2d (k=1) in the
    RoI head's xyz_up / merge_down / SA stacks, Conv1d (k=1) in its
    cls / reg layers, Linear elsewhere."""
    if key.endswith(".weight") and len(port_shape) == 2:
        if re.search(r"(xyz_up_layer|merge_down_layer|SA_modules)\.", key):
            return tuple(port_shape) + (1, 1)
        if re.search(r"roi_head\.(cls|reg)_layers\.", key):
            return tuple(port_shape) + (1,)
    return tuple(port_shape)


def reference_state(model, seed=0):
    """A reference-keyed PointRCNN model_state for `model`'s heads, of the
    reference's shapes: numpy draws of N(0, 0.05), running variances
    U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    own = model.state_dict()
    state = {}
    for ours, (ref, _) in model.reference_mapping().items():
        shape = _ref_shape(ref, own[ours].shape)
        w = (rng.uniform(0.5, 1.5, shape) if ref.endswith("running_var")
             else rng.normal(0, 0.05, shape))
        state[ref] = torch.from_numpy(w.astype(np.float32))
    return state


def test_reference_mappings_match_jax(tiny, tmp_path):
    """point_head_box_mapping + pointrcnn_head_mapping at the tiny widths,
    against the JAX package's on a synthetic reference-keyed state dict:
    every tensor equal after the overlay, the reports equal, the backbone
    reported unconverted on both sides."""
    jmodel, _, jbatch = tiny
    variables = tiny_variables(jmodel, jbatch, seed=6)
    model = build_network(CfgDict(prcnn_cfg()), CLASS_NAMES, tiny_grid(), device="cpu")
    params_from_jax(variables, model)
    state = reference_state(model, seed=7)
    path = tmp_path / "ref.pth"
    torch.save({"model_state": state, "epoch": 3, "optimizer_state": None}, path)
    assert torch_convert.is_reference_state(state)
    assert not torch_convert.is_reference_state(model.state_dict())

    jmapping = {**jtc.point_head_box_mapping(cls_fc=(64, 64), reg_fc=(64, 64),
                                             ours_prefix=("point_head",)),
                **jtc.pointrcnn_head_mapping(xyz_up=(16, 16), sa_mlps=((16, 16), (16, 32),
                                                                          (32, 32)),
                                             cls_fc=(16,), reg_fc=(16,), use_bn=False,
                                             ours_prefix=("roi_head",))}
    j_vars, j_report = jtc.apply_mapping(variables, jtc.load_torch_checkpoint(path), jmapping)
    want = params_from_jax(j_vars)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = torch_convert.load_reference_state(model, load_torch_state(path))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert report["converted"] == j_report["converted"]
    assert report["missing_in_torch"] == j_report["missing_in_torch"] == []
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
    assert sorted(report["unmatched_ours"]) == sorted(
        ".".join([*p[1:-1], leaf[p[-1]]]) for p in j_report["unmatched_ours"])
    assert report["unmatched_ours"] and all(k.startswith("backbone.")
                                            for k in report["unmatched_ours"])
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {k for k in got if not k.startswith("backbone.")}


def test_tools_train_trains_the_pointrcnn_config(tmp_path, monkeypatch):
    """tools.train --cfg_file cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml
    --pretrained_model <a reference checkpoint of the heads>, fp32 on the
    CPU, one epoch of 1 step (2 train frames, B=2) from a synthetic root laid
    out as the config expects, with its augmentations (gt sampling, flip,
    rotation, scaling, translation), sample_points to 16,384 and shuffle:
    a finite loss, a checkpoint, two B1 calls in the step (proposal NMS,
    RoI targets), and the overlay's counts in the log, the backbone's keys
    unconverted. Cut to the CPU by --set: SA npoints 256/64/32/16 (published
    4096/1024/256/64) and proposal NMS pre 256 (published 4096); the widths
    stay published."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel

    work = tmp_path
    (work / "cfgs").symlink_to(Path(__file__).resolve().parents[1] / "tools" / "cfgs")
    classes = yaml.safe_load(POINTRCNN_CFG.read_text())["CLASS_NAMES"]
    root = work / "train_28130"
    kitti_synthetic.write_root(root, 2, 0, classes, seed=2, num_points=(800, 1200),
                               num_boxes=(4, 7), near_cars=2)
    cfg_file = "cfgs/kitti_models/pointrcnn_nuscenes2kitti.yaml"
    monkeypatch.chdir(work)
    out = create_infos.main(["--cfg_file", cfg_file, "--data_path", str(root),
                             "--splits", "train"])
    out["dbinfos"].rename(root / "nuscenes2kitti_dbinfos_train_28130.pkl")
    _, _, model = pointrcnn(device="cpu")
    ref = work / "ref.pth"
    torch.save({"model_state": reference_state(model, seed=8), "epoch": 5}, ref)
    mapping = model.reference_mapping()
    n_backbone = sum(k.startswith("backbone.") for k in model.state_dict())
    calls = []
    plain = iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev",
                        lambda a, b: calls.append(tuple(a.shape[:2]) + (b.shape[1],))
                        or plain(a, b))
    res = train_cli.main([
        "--cfg_file", cfg_file, "--epochs", "1", "--batch_size", "2", "--workers", "1",
        "--pretrained_model", str(ref), "--device", "cpu", "--dtype", "float32",
        "--set", "DATA_CONFIG.DATA_PATH", str(root),
        "DATA_CONFIG.INFO_PATH.train", "['kitti_infos_train.pkl']",
        "MODEL.BACKBONE_3D.SA_CONFIG.NPOINTS", "[256,64,32,16]",
        "MODEL.ROI_HEAD.NMS_PRE_MAXSIZE", "256"])
    (epoch,) = res["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["loss"])
    assert (res["ckpt_dir"] / "checkpoint_epoch_1.pth").exists()
    assert calls == [(2, 256, 256), (2, 128, 256)]    # proposal NMS, RoI targets (G=256)
    log = next((work / res["output_dir"]).glob("log_train_*.txt")).read_text()
    assert (f"{len(mapping)} keys converted, 0 missing and {n_backbone} of the model's "
            "unmatched") in log


def test_pointrcnn_train_profile_on_the_cpu(monkeypatch):
    """profile_serve.pointrcnn_profile with a train step and its optimizer
    (what `profile_train --model pointrcnn` and chip_smoke.py's PointRCNN
    train phase report) on the tiny config, its device syncs made no-ops:
    the train spans beside the serving ones, each keyed under its outer
    span, exclusive times that add up to the step, one keep-scan per step
    (the proposal NMS), and every wrapped function restored."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = prcnn_cfg()
    model = build_network(CfgDict(cfg), CLASS_NAMES, tiny_grid(), device="cpu", train=True)
    seeded_weights_(model, seed=0)
    state = create_train_state(model, CfgDict(yaml.safe_load(POINTRCNN_CFG.read_text())
                                              ["OPTIMIZATION"]), 10)
    step = make_train_step(model, state.optimizer, device="cpu", dtype=torch.float32)
    batches = [fg_scene(np.random.RandomState(s)) for s in (1, 2)]
    backward, opt_step = torch.Tensor.backward, state.optimizer.step
    out = profile_serve.pointrcnn_profile(model, step, batches, state.optimizer)
    assert torch.Tensor.backward is backward and state.optimizer.step == opt_step
    assert pprcnn.assign_point_targets.__module__ == pprcnn.__name__
    assert "forward" not in vars(model.roi_head) and "step" not in vars(state.optimizer)
    phase_ms = out["phase_ms"]
    for key in ("backbone.sa_0.fps", "backbone.fp_0.three_nn", "point_head", "point_targets",
                "point_loss", "proposal_layer.b1", "proposal_layer.keep_scan",
                "roi_targets.b1", "roi_targets", "pool_rois", "roi_head.fps", "rcnn_loss",
                "backward", "clip_optimizer", "rest"):
        assert phase_ms[key] > 0, key
    assert "final_nms" not in phase_ms and "recall_iou" not in phase_ms
    assert abs(sum(v for k, v in phase_ms.items() if k != "step") - phase_ms["step"]) < 1e-6
    assert 0 < out["fps_share"] < 1
    assert [c["shape"] for c in out["keep_scan"]] == [[2, 128, 128]] * 2
    assert state.step == 4     # two spans runs and two keep-scan runs


def test_proposal_gt_gives_every_frame_a_fg_roi(monkeypatch):
    """zoo.proposal_gt on the tiny config with seeded random weights (the
    point head's reg_out not zeroed): the batch's own gt kept, 16 gt per
    frame appended, the BN running statistics put back, no overlap call;
    the train forward on the result then has a RoI over REG_FG_THRESH in
    every frame and a reg loss above 0."""
    from dfu3d_tpu_torch.core.geometry import iou_kernel

    model = build_network(CfgDict(prcnn_cfg()), CLASS_NAMES, tiny_grid(), device="cpu",
                          train=True)
    seeded_weights_(model, seed=3)
    batch = PointBatch.from_numpy(*make_batch(np.random.RandomState(5), b=2, n=256))
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    calls = []
    plain = iou_kernel.overlap_bev
    monkeypatch.setattr(iou_kernel, "overlap_bev", lambda a, b: calls.append(1) or plain(a, b))
    out = proposal_gt(model, batch)
    assert not calls
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())
    g = batch.gt_boxes.shape[1]
    assert out.gt_boxes.shape == (2, g + 16, 8) and out.gt_valid[:, g:].all()
    assert torch.equal(out.gt_boxes[:, :g], batch.gt_boxes)
    assert torch.equal(out.gt_valid[:, :g], batch.gt_valid)
    seen = capture_port_targets(monkeypatch)
    _, tb = model(out, sampler=torch.Generator().manual_seed(0))
    assert (seen["reg_valid_mask"].sum(1) > 0).all()
    assert tb["rcnn_reg_loss"].item() > 0


def test_write_pointrcnn_root_reads_in_train_mode(tmp_path):
    """zoo.write_pointrcnn_root(training=True): the train split with its gt
    database under the name the config's gt sampling reads, so that
    pointrcnn_batches(training=True) reads it with the augmentations: B=4
    frames of 16,384 points with valid gt."""
    cfg = pointrcnn(device="cpu")[0]
    info = write_pointrcnn_root(cfg, tmp_path, 2, training=True)
    assert info.exists() and (tmp_path / "nuscenes2kitti_dbinfos_train_28130.pkl").exists()
    (batch,) = pointrcnn_batches(cfg, tmp_path, info, 1, training=True)
    assert batch.points.shape == (4, 16384, 4) and batch.points_valid.all()
    assert batch.gt_valid.sum(1).min() > 0
