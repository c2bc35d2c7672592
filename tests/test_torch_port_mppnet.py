"""Port parity: MPPNet and MPPNetE2E (the trajectory head and its parts, the
two detectors' predictions, the E2E memory bank) against the JAX package,
on the CPU, fp32 on both sides, from the same numpy inputs and weights
(flax layout, carried across by `params_from_jax`), at narrow widths:
HIDDEN 16, 4 heads, DIM_FEEDFORWARD 32, MIXER_HIDDEN 4, GRID_SIZE 2 (8
proxies), NUM_LIDAR_POINTS 16, NSAMPLE 8, NUM_LAYERS 2 (so that the
inter-group fusion runs), the proposal NMS 128 → 8, on tests/test_pvrcnn.py's
grid with B=2 and a few hundred points of 5 channels (x, y, z, intensity,
time lag). Frame settings: 4 frames in 4 groups, and 8 frames in 4 groups
(the fusion of frames into groups, where frames 5-7 feed no group).

* `spherical_corner_feature`, `proxy_points_of_roi` and
  `generate_trajectory` on JAX's own cases (9-wide moving boxes and the
  7-wide static case): within TOL, the trajectory's valid equal;
* the crop against JAX's `crop_roi_frame_points` over every point of the
  sample: the cropped points exactly equal (so their indices are), with a
  RoI of more than k hits, one of none, an invalid one, lags on half steps;
* SpatialMixerBlock, TrajectoryPointNet, MPPNetEncoderLayer with and
  without the inter-group fusion, MPPNetHead on given RoIs and
  trajectories without a bank (4 and 8 frames) and with a bank partly
  invalid: within TOL of the larger of 1 and the reference's largest entry;
* the JAX-side fault at 8 frames: frames 5-7's points moved change neither
  package's head output;
* `MPPNet.predict` and two steps of `MPPNetE2E.predict_with_bank`: valid
  masks and labels (all 1, the JAX-side fault) equal, boxes and scores
  within 1e-4, the rolled bank's RoIs and validity equal and its features
  within TOL;
* the flax tree of the head equals the port's state_dict leaf for leaf.

The train step is in tests/test_torch_port_mppnet_train.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.data.dataset import PointBatch as JPointBatch
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import mppnet as jmppnet
from dfu3d_tpu.models import mppnet_head as jmh
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import mppnet_head as pmh
from dfu3d_tpu_torch.models.mppnet import MemoryBank, MPPNetE2E
from dfu3d_tpu_torch.utils.config import CfgDict

from test_model import CLASS_NAMES
from test_pvrcnn import pv_cfg
from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR, VS = [0, -6.4, -3, 6.4, 6.4, 1], [0.2, 0.2, 0.25]   # tests/test_pvrcnn.py's pv_grid
MAX_VOXELS = 512
HIDDEN, HEADS, FFN, MIXER, GRID, K, NSAMPLE, LAYERS = 16, 4, 32, 4, 2, 16, 8, 2
TOL = 1e-5
HEAD_TOL = 1e-4
# the RPN's box conv and the joint regression's out layer at 0.1 of
# He-normal: at full scale the decoded sizes reach 11 m on 1-4 m boxes, where
# the exp turns JAX's own fp32 rounding of the regression (1e-5 relative)
# into 1.5e-4 m
GAINS = {"dense_head/conv_box/kernel": 0.1, "roi_head/jointembed/fc3/kernel": 0.1}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def mppnet_cfg(name="MPPNet", frames=4, groups=None):
    """tests/test_zoo_variants.py's MPPNet config at the widths above."""
    cfg = pv_cfg()
    cfg["NAME"] = name
    for key in ("PFE", "POINT_HEAD"):
        del cfg[key]
    rh = {"NAME": "MPPNetHead", "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 8,
          "NMS_THRESH": 0.8, "NUM_FRAMES": frames, "NSAMPLE": NSAMPLE, "HIDDEN": HIDDEN,
          "NUM_LAYERS": LAYERS, "NHEADS": HEADS, "DIM_FEEDFORWARD": FFN,
          "MIXER_HIDDEN": MIXER, "GRID_SIZE": GRID, "NUM_LIDAR_POINTS": K,
          "TARGET_CONFIG": dict(cfg["ROI_HEAD"]["TARGET_CONFIG"], ROI_PER_IMAGE=8),
          "LOSS_CONFIG": cfg["ROI_HEAD"]["LOSS_CONFIG"]}
    if groups:
        rh["NUM_GROUPS"] = groups
    cfg["ROI_HEAD"] = rh
    return cfg


def variables_like(model):
    """`flax_variables_like` with the attentions' DenseGeneral kernels
    (q / k / v (C, H, D) with (H, D) biases, out (H, D, C))."""
    v = flax_variables_like(model)
    for path, mod in model.named_modules():
        if not isinstance(mod, pmh.MultiHeadAttention):
            continue
        node = v["params"]
        for key in path.split(".") if path else ():
            node = node[key]
        h = mod.heads
        c = node["q"]["kernel"].shape[0]
        for name in ("q", "k", "v"):
            node[name]["kernel"] = jnp.zeros((c, h, c // h))
            node[name]["bias"] = jnp.zeros((h, c // h))
        node["out"]["kernel"] = jnp.zeros((h, c // h, c))
    return v


def points(seed, frames=4, b=2, n=384, m=8):
    """Points of 5 channels: per frame, a third in 6 clusters (their centres
    the same in every frame, moved 0.3 m a frame), the rest uniform in the
    range; lags f · 0.1 of frame f, a tenth of them on a half step (0.05,
    0.15, ...: the round-half-even frame), the last 16 of each sample
    invalid; m gt boxes of the three classes, the last 2 invalid."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 5), np.float32)
    for i in range(b):
        ctr = rng.uniform([1, -5, -2], [5.4, 5, 0], (6, 3))
        frame = rng.randint(0, frames, n)
        near = rng.uniform(size=n) < 0.33
        pts[i, :, :3] = rng.uniform([0, -6.4, -2.5], [6.4, 6.4, 0.5], (n, 3))
        pick = ctr[rng.randint(0, 6, n)] + rng.normal(0, 0.6, (n, 3))
        pick[:, 0] += 0.3 * frame
        pts[i, near, :3] = pick[near]
        lag = frame * 0.1
        half = rng.uniform(size=n) < 0.1
        lag[half] = np.maximum(frame[half] - 0.5, 0.0) * 0.1
        pts[i, :, 3] = rng.uniform(0, 1, n)
        pts[i, :, 4] = lag
    valid = np.ones((b, n), bool)
    valid[:, -16:] = False
    gt = np.zeros((b, m, 8), np.float32)
    gt[..., 0] = rng.uniform(1, 5, (b, m))
    gt[..., 1] = rng.uniform(-4, 4, (b, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (b, m))
    gt[..., 3:6] = rng.uniform(0.5, 3, (b, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    gt[..., 7] = rng.randint(1, 4, (b, m))
    gt_valid = np.ones((b, m), bool)
    gt_valid[:, -2:] = False
    return pts, valid, gt, gt_valid


def boxes(rng, shape, width=7):
    """Random boxes over the point range, 0.8-4 m long."""
    out = np.zeros(shape + (width,), np.float32)
    out[..., 0] = rng.uniform(1, 5.4, shape)
    out[..., 1] = rng.uniform(-5, 5, shape)
    out[..., 2] = rng.uniform(-1.5, -0.5, shape)
    out[..., 3:6] = rng.uniform([0.8, 0.6, 1.0], [4.0, 2.0, 2.0], shape + (3,))
    out[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    return out


def head_kw(frames, groups=None):
    return dict(num_frames=frames, num_groups=groups or frames, grid_size=GRID,
                num_lidar_points=K, hidden=HIDDEN, enc_layers=LAYERS, nheads=HEADS,
                ffn_hidden=FFN, mixer_hidden=MIXER, pool_nsample=NSAMPLE)


def head_pair(frames, groups=None, seed=0):
    """(JAX MPPNetHead, flax variables, port MPPNetHead with them)."""
    port = pmh.MPPNetHead(5, **head_kw(frames, groups)).eval()
    variables = numpy_variables(lambda: variables_like(port), seed=seed)
    params_from_jax(variables, port)
    return jmh.MPPNetHead(**head_kw(frames, groups), dtype=jnp.float32), variables, port


def head_inputs(seed, frames, r=6):
    """RoIs, their valid (the last one invalid), a trajectory (B, T, R, 7)
    drifting 0.3 m a frame along x with one frame's match lost, points."""
    rng = np.random.RandomState(seed)
    pts, valid, *_ = points(seed + 1, frames)
    rois = boxes(rng, (2, r))
    roi_valid = np.ones((2, r), bool)
    roi_valid[:, -1] = False
    traj = np.repeat(rois[:, None], frames, axis=1)
    traj[..., 0] += 0.3 * np.arange(frames)[None, :, None]
    traj_valid = np.repeat(roi_valid[:, None], frames, axis=1)
    traj_valid[:, 2, 1] = False
    return rois, roi_valid, traj, traj_valid, pts, valid


def run_jax_head(jhead, variables, inputs, bank=None):
    """JAX's head on `inputs`, eval mode, with the (features, valid) `bank`."""
    if bank is None:
        return jax.device_get(jax.jit(lambda v, *a: jhead.apply(v, *a, False))(
            variables, *inputs))
    fn = jax.jit(lambda v, bk, bv, *a: jhead.apply(v, *a, False, geometry_bank=bk,
                                                   bank_valid=bv))
    return jax.device_get(fn(variables, *bank, *inputs))


def port_head(port, inputs, **bank):
    """The port's head on `inputs` in fp32, and the same module in fp64."""
    ref = copy.deepcopy(port).double()
    with torch.no_grad():
        got = port(*(t(a) for a in inputs), **{k: t(v) for k, v in bank.items()})
        want = ref(*(t(a).double() if t(a).is_floating_point() else t(a) for a in inputs),
                   **{k: t(v).double() if t(v).is_floating_point() else t(v)
                      for k, v in bank.items()})
    return got, want


def compare_head(got, want, fp64):
    """The port's fp32 head within TOL of its fp64 run and within HEAD_TOL
    of JAX's: JAX's fp32 head lies 2-5e-5 of the largest entry from the
    fp64 head here (its one-pass LayerNorms over 16 channels sum in another
    order, 2 x 7 of them deep), the port's within 8e-6."""
    for k in ("rcnn_cls", "cls_layers", "rcnn_reg", "point_reg", "box_reg", "geometry_memory"):
        close(got[k].numpy(), fp64[k].numpy(), err_msg=k)
        close(got[k].numpy(), want[k], HEAD_TOL, err_msg=k)


# --------------------------------------------------------------------------
# geometry: JAX's own cases
# --------------------------------------------------------------------------

def _box(x, y, z=0.0, dx=4.0, dy=2.0, dz=1.5, ry=0.0, vx=0.0, vy=0.0):
    return [x, y, z, dx, dy, dz, ry, vx, vy]


def trajectory_cases():
    """tests/test_mppnet_head.py's two cases: a moving roi matched in frames
    1 and 2 beside a static roi with no match (9-wide), and a 7-wide roi
    holding station."""
    cur = np.asarray([[_box(10.0, 0.0, vx=-1.0), _box(0.0, 5.0)]], np.float32)
    props = np.zeros((1, 3, 2, 9), np.float32)
    props[0, 1, 0] = _box(9.1, 0.0)
    props[0, 1, 1] = _box(50.0, 50.0)
    props[0, 2, 0] = _box(8.2, 0.0)
    props[0, 2, 1] = _box(50.0, 50.0)
    cur7 = np.asarray([[_box(3.0, 1.0)[:7]]], np.float32)
    return [(cur, np.ones((1, 2), bool), props, np.ones((1, 3, 2), bool)),
            (cur7, np.ones((1, 1), bool), np.repeat(cur7[:, None], 4, axis=1),
             np.ones((1, 4, 1), bool))]


@pytest.mark.parametrize("case", [0, 1], ids=["moving_9wide", "static_7wide"])
def test_generate_trajectory_matches_jax(case):
    args = trajectory_cases()[case]
    want_traj, want_valid = jax.device_get(jax.jit(jmh.generate_trajectory)(*args))
    traj, valid = pmh.generate_trajectory(*(t(a) for a in args))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    close(traj.numpy(), want_traj)
    if case == 0:
        np.testing.assert_allclose(traj[0, 1:3, 0, :2].numpy(), [[9.1, 0.0], [8.2, 0.0]],
                                   atol=1e-5)
        assert not valid[0, 1:, 1].any()


def test_spherical_and_proxy_points_match_jax():
    rng = np.random.RandomState(0)
    rois = boxes(rng, (3, 2))
    xyz = (rois[..., None, :3] + rng.normal(0, 1.5, (3, 2, 11, 3))).astype(np.float32)
    xyz[0, 0, 0] = rois[0, 0, :3]   # at the centre: a 0/0 direction
    want = jax.jit(jmh.spherical_corner_feature)(xyz, rois)
    got = pmh.spherical_corner_feature(t(xyz), t(rois))
    assert got.shape == (3, 2, 11, 27) and torch.isfinite(got).all()
    close(got.numpy(), want)
    for g in (2, 4):
        wg, wl = jax.jit(jmh.proxy_points_of_roi, static_argnums=1)(rois, g)
        gg, gl = pmh.proxy_points_of_roi(t(rois), g)
        close(gg.numpy(), wg)
        close(gl.numpy(), wl)


def test_crop_matches_jax():
    """The per-frame crop against JAX's top_k over every point of the
    sample: RoI 0 holds more than k points of a frame, RoI 3 none, RoI 4 is
    invalid; channel 3 is each point's index, so equal points are equal
    indices."""
    frames, k = 4, 6
    pts, valid, *_ = points(3, frames)
    pts[..., 3] = np.arange(pts.shape[1])
    rng = np.random.RandomState(4)
    rois = boxes(rng, (2, frames, 5))
    rois[:, :, 0, :2] = pts[:, :1, :2]
    rois[:, :, 0, 3:5] = 6.0
    rois[:, :, 3, :2] = [30.0, 30.0]
    roi_valid = np.ones((2, frames, 5), bool)
    roi_valid[:, :, 4] = False
    head = pmh.MPPNetHead(5, **head_kw(frames))
    frame_of = head.frame_of(t(pts))
    want_frame = np.clip(np.round(pts[..., -1] / np.float32(0.1)), 0, frames - 1)
    np.testing.assert_array_equal(frame_of.numpy(), want_frame)
    got, got_ne = pmh.crop_frame_points(t(pts), t(valid), frame_of, t(rois), t(roi_valid), k,
                                        frames)
    fvalid = valid[:, None, :] & (frame_of.numpy()[:, None, :] == np.arange(frames)[None, :,
                                                                                     None])
    crop = jax.vmap(jax.vmap(lambda p, fv, r, rv: jmh.crop_roi_frame_points(p, fv, r, rv, k),
                             in_axes=(None, 0, 0, 0)))
    want, want_ne = jax.device_get(jax.jit(crop)(pts, fvalid, rois, roi_valid))
    np.testing.assert_array_equal(got_ne.numpy(), np.asarray(want_ne))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hits = (fvalid[:, :, None, :] & (np.linalg.norm(
        pts[:, None, None, :, :2] - rois[..., None, :2], axis=-1) <= 1.1 * np.sqrt(
        (rois[..., 3:4] / 2) ** 2 + (rois[..., 4:5] / 2) ** 2))).sum(-1)
    assert (hits[:, :, 0] > k).any() and not got_ne[:, :, 3].any() and not got_ne[:, :, 4].any()
    assert ((hits[:, :, 1:3] > 0) & (hits[:, :, 1:3] < k)).any()


# --------------------------------------------------------------------------
# the modules
# --------------------------------------------------------------------------

def module_pair(port, jmod, seed):
    variables = numpy_variables(lambda: variables_like(port), seed=seed)
    params_from_jax(variables, port)
    return jmod, variables


def test_mixer_and_trajectory_pointnet_match_jax():
    rng = np.random.RandomState(5)
    x = rng.normal(0, 1, (2, 3, 4, GRID ** 3, HIDDEN)).astype(np.float32)
    port = pmh.SpatialMixerBlock(MIXER, GRID, HIDDEN)
    jmod, variables = module_pair(port, jmh.SpatialMixerBlock(MIXER, GRID, HIDDEN), 6)
    close(port(t(x)).detach().numpy(), jax.jit(jmod.apply)(variables, x))
    seq = rng.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
    port = pmh.TrajectoryPointNet(HIDDEN)
    jmod, variables = module_pair(port, jmh.TrajectoryPointNet(HIDDEN), 7)
    (wreg, wfeat), (reg, feat) = jax.jit(jmod.apply, static_argnums=2)(variables, seq,
                                                                         False), port(t(seq))
    close(reg.detach().numpy(), wreg)
    close(feat.detach().numpy(), wfeat)


@pytest.mark.parametrize("inter_group", [False, True], ids=["token_only", "inter_group"])
def test_encoder_layer_matches_jax(inter_group):
    rng = np.random.RandomState(8)
    p = GRID ** 3
    tok = rng.normal(0, 1, (2, 3, 4, 1, HIDDEN)).astype(np.float32)
    grp = rng.normal(0, 1, (2, 3, 4, p, HIDDEN)).astype(np.float32)
    pos = rng.normal(0, 1, (p, HIDDEN)).astype(np.float32)
    kw = dict(hidden=HIDDEN, heads=HEADS, ffn_hidden=FFN, mixer_hidden=MIXER, grid_size=GRID,
              num_groups=4, inter_group=inter_group)
    port = pmh.MPPNetEncoderLayer(**kw)
    jmod, variables = module_pair(port, jmh.MPPNetEncoderLayer(**kw), 9)
    wtok, wgrp = jax.jit(jmod.apply)(variables, tok, grp, pos)
    gtok, ggrp = port(t(tok), t(grp), t(pos))
    close(gtok.detach().numpy(), wtok)
    close(ggrp.detach().numpy(), wgrp)


@pytest.fixture(scope="module")
def head4():
    jhead, variables, port = head_pair(4)
    inputs = head_inputs(10, 4)
    return jhead, variables, port, inputs


def test_head_matches_jax(head4):
    """4 frames in 4 groups, no bank; an invalid RoI and a trajectory frame
    without its match."""
    jhead, variables, port, inputs = head4
    want = run_jax_head(jhead, variables, inputs)
    got, fp64 = port_head(port, inputs)
    compare_head(got, want, fp64)
    assert np.abs(np.asarray(want["geometry_memory"])).max() > 0


def test_head_with_bank_matches_jax(head4):
    """The E2E form: frame 0 from points, frames 1-3 from a bank whose
    entries are partly invalid (zeroed before the motion stream)."""
    jhead, variables, port, inputs = head4
    rng = np.random.RandomState(11)
    bank = rng.normal(0, 1, (2, 3, 6, GRID ** 3, HIDDEN)).astype(np.float32)
    bank_valid = rng.uniform(size=(2, 3, 6)) > 0.4
    want = run_jax_head(jhead, variables, inputs, (bank, bank_valid))
    got, fp64 = port_head(port, inputs, geometry_bank=bank, bank_valid=bank_valid)
    compare_head(got, want, fp64)
    with torch.no_grad():
        nobank = port(*(t(a) for a in inputs))
    # the fresh frame's memory is the bank-free head's
    close(got["geometry_memory"].numpy(), nobank["geometry_memory"].numpy())


def test_head_8_frames_and_dead_frames_match_jax():
    """8 frames in 4 groups of 2 (stride 1): groups read frames (0, 1) ..
    (3, 4), so frames 5-7 feed nothing: moving their points changes neither
    package's output, moving frame 4's does."""
    jhead, variables, port = head_pair(8, groups=4, seed=12)
    inputs = head_inputs(13, 8)
    pts = inputs[4]
    frame = np.clip(np.round(pts[..., -1] / np.float32(0.1)), 0, 7)
    moved = pts.copy()
    moved[..., 0] += np.where(frame >= 5, 1.5, 0.0).astype(np.float32)
    moved4 = pts.copy()
    moved4[..., 0] += np.where(frame == 4, 1.5, 0.0).astype(np.float32)
    fn = jax.jit(lambda v, *a: jhead.apply(v, *a, False))
    want = jax.device_get(fn(variables, *inputs))
    want_moved = jax.device_get(fn(variables, *inputs[:4], moved, inputs[5]))
    assert port.frame_groups() == [[0, 1], [1, 2], [2, 3], [3, 4]]
    got, fp64 = port_head(port, inputs)
    compare_head(got, want, fp64)
    with torch.no_grad():
        got_moved = port(*(t(a) for a in inputs[:4]), t(moved), t(inputs[5]))
        got_moved4 = port(*(t(a) for a in inputs[:4]), t(moved4), t(inputs[5]))
    for k in ("rcnn_cls", "rcnn_reg", "point_reg", "box_reg"):
        np.testing.assert_array_equal(np.asarray(want_moved[k]), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got_moved[k].numpy(), got[k].numpy(), err_msg=k)
    assert not torch.equal(got_moved4["rcnn_reg"], got["rcnn_reg"])


def test_head_flax_tree_matches_state_dict():
    """The flax tree of JAX's head init has exactly the port state_dict's
    leaves in flax shapes (the pool MLPs' Dense_0 .. Dense_3 in the head's
    own scope, the raw token, the attentions' DenseGenerals,
    fusion_all_group and fusion_norm at 8 frames)."""
    for frames in (4, 8):
        jhead, _, port = head_pair(frames, groups=4)
        inputs = head_inputs(14, frames, r=2)
        shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), *inputs, False))

        def leaves(tree):
            return {"/".join(k.key for k in p): tuple(v.shape)
                    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

        assert leaves(shapes) == leaves(variables_like(port))


# --------------------------------------------------------------------------
# the detectors
# --------------------------------------------------------------------------

def detector_pair(name, frames=4, groups=None, seed=1, train=False):
    """(JAX model, flax variables, port model with those weights)."""
    cfg = mppnet_cfg(name, frames, groups)
    jmodel = j_build_network(cfg, CLASS_NAMES, JVoxelGrid.create(PCR, VS), max_voxels=MAX_VOXELS)
    model = build_network(CfgDict(cfg), CLASS_NAMES, VoxelGrid.create(PCR, VS), device="cpu",
                          train=train, max_voxels=MAX_VOXELS, num_point_features=5)
    variables = numpy_variables(lambda: variables_like(model), seed=seed, gains=GAINS)
    params_from_jax(variables, model)
    return jmodel, variables, model


def jax_batch(seed, frames=4, **kw):
    return JPointBatch(*points(seed, frames, **kw))


def port_batch(jbatch):
    return PointBatch.from_numpy(*(np.asarray(x) for x in jbatch))


def compare_predictions(got, want):
    boxes_, scores, labels, keep = (x.numpy() for x in got)
    np.testing.assert_array_equal(keep, np.asarray(want[3]))
    np.testing.assert_array_equal(labels[keep], np.asarray(want[2])[keep])
    assert (labels[keep] == 1).all()
    np.testing.assert_allclose(boxes_, np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-4)
    assert keep.sum() >= 8 and np.isfinite(boxes_).all()


def test_mppnet_predict_matches_jax():
    jmodel, variables, model = detector_pair("MPPNet", seed=2)
    jbatch = jax_batch(15)
    want = jax.device_get(jax.jit(
        lambda v, b: jmodel.apply(v, b, method=lambda m, bb: m.predict(bb)))(variables, jbatch))
    with torch.no_grad():
        got = model.eval().predict(port_batch(jbatch))
    compare_predictions(got, want)


def test_e2e_bank_steps_match_jax():
    """Two requests through the memory bank from an empty one: the second
    reads the first's entries (frame 1 matches the RoIs it served). The
    predictions and the rolled banks agree."""
    jmodel, variables, model = detector_pair("MPPNetE2E", seed=3)
    assert isinstance(model, MPPNetE2E)
    step = jax.jit(lambda v, b, bank: jmodel.apply(
        v, b, bank, method=lambda m, bb, bk: m.predict_with_bank(bb, bk)))
    bank = model.empty_bank(2)
    jbank = jmppnet.MemoryBank(*(jnp.asarray(x.numpy()) for x in bank))
    matched = []
    for seed in (16, 16):
        jbatch = jax_batch(seed)
        want, jbank = jax.device_get(step(variables, jbatch, jbank))
        orig = model.match_bank
        with torch.no_grad():
            model.match_bank = lambda *a: matched.append(orig(*a)) or matched[-1]
            got, bank = model.eval().predict_with_bank(port_batch(jbatch), bank)
            del model.match_bank
        compare_predictions(got, want)
        np.testing.assert_array_equal(bank.valid.numpy(), np.asarray(jbank.valid))
        close(bank.rois.numpy(), jbank.rois)
        close(bank.feats.numpy(), jbank.feats)
    assert not matched[0][1].any() and matched[1][1][:, 0].any()
    assert not matched[1][1][:, 1:].any()
    assert isinstance(bank, MemoryBank)
