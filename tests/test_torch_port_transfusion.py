"""Port parity: TransFusion-L (TransFusionHead and the TransFusion detector)
against the JAX package, on the CPU, fp32 on both sides, from the same
numpy inputs and weights (flax layout, carried across by `params_from_jax`),
at tests/test_camera_branch.py's sizes (hidden 16, 2 heads, 16-64
proposals, 3 or 10 classes, with and without the velocity branch):

* the learned position embedding, flax's attention and LayerNorm;
* the interior local max exactly equal; the head's queries (class and
  cell) exactly equal, its branches, dense heat map and query scores within
  1e-5, in eval and train mode with the BN statistics;
* `decode`, `gaussian_heatmap_targets` and the loss with either matcher;
* the numpy Hungarian against scipy's linear_sum_assignment and JAX's
  `hungarian_match`, the greedy matcher against JAX's: indices equal;
* the whole TransFusion (the plain trunk JAX builds) predict and loss;
* the reference-key mapping against JAX's `transfusion_head_mapping`.

The shipped config's VoxelResBackBone8x trunk, held against JAX's own
VoxelResBackBone8x → height_compression → BaseBEVBackbone →
TransFusionHead applied as flax modules (`ResTrunkTransFusion` here: JAX's
TransFusion builds VoxelBackBone8x whatever BACKBONE_3D names), is in
tests/test_torch_port_transfusion_trunk.py; the train step and the CLIs
are in tests/test_torch_port_transfusion_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from scipy.optimize import linear_sum_assignment as scipy_lsa

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.core.voxel.sparse_ops import SparseGrid as JSparseGrid
from dfu3d_tpu.models import bevfusion as jbev
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models import center_head as jch
from dfu3d_tpu.models import transfusion_head as jth
from dfu3d_tpu.models.backbone_2d import BaseBEVBackbone as JBaseBEVBackbone
from dfu3d_tpu.models.sparse_backbone import VoxelResBackBone8x as JVoxelResBackBone8x
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.data.batch import PointBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models import transfusion_head as pth
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.utils.config import CfgDict

from test_torch_port_models import flax_variables_like, numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR = [0, -6.4, -3, 12.8, 6.4, 1]      # tests/test_camera_branch.py's grid
VOXEL = [0.2, 0.2, 0.25]
NUSC = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
        "bicycle", "pedestrian", "traffic_cone"]
NAMES3 = ["Car", "Pedestrian", "Cyclist"]
MAX_VOXELS = 512
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, err_msg=""):
    """Within TOL of the larger of 1 and the largest |entry| of `want`:
    the position embeddings read raw cell coordinates (up to 40 here) and
    reach 1e2, where fp32 rounds at 1e-5."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def variables_like(model):
    """`flax_variables_like` with flax's attention layout: query / key /
    value kernels (C, H, D) and biases (H, D), out kernels (H, D, C)."""
    v = flax_variables_like(model)
    for path, mod in model.named_modules():
        if not isinstance(mod, pth.MultiHeadAttention):
            continue
        node = v["params"]
        for key in path.split("."):
            node = node[key]
        h = mod.num_heads
        for name in ("query", "key", "value"):
            c = node[name]["kernel"].shape[0]
            node[name]["kernel"] = jnp.zeros((c, h, c // h))
            node[name]["bias"] = jnp.zeros((h, c // h))
        c = node["out"]["kernel"].shape[0]
        node["out"]["kernel"] = jnp.zeros((h, c // h, c))
    return v


def tf_cfg(vel=False, proposals=16, matcher=None, res_trunk=False):
    """tests/test_camera_branch.py's TransFusion config; `res_trunk` names
    VoxelResBackBone8x with four CHANNELS, as the shipped config does."""
    bb3d = ({"NAME": "VoxelResBackBone8x", "CHANNELS": [4, 8, 8, 8], "OUT_CHANNELS": 16}
            if res_trunk else {"CHANNELS": [4, 4, 8, 8, 8], "OUT_CHANNELS": 16})
    dh = {"NAME": "TransFusionHead", "NUM_PROPOSALS": proposals, "HIDDEN_CHANNEL": 16,
          "NUM_HEADS": 2, "FFN_CHANNEL": 64, "TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 8}}
    if vel:
        dh["SEPARATE_HEAD_CFG"] = {"HEAD_ORDER": ["center", "height", "dim", "rot", "vel"]}
        dh["LOSS_CONFIG"] = {"LOSS_WEIGHTS": {"cls_weight": 1.0, "bbox_weight": 0.25,
                                              "hm_weight": 1.0,
                                              "code_weights": [1.0] * 8 + [0.2, 0.2]}}
    if matcher:
        dh["MATCHER"] = matcher
    return {"NAME": "TransFusion", "BACKBONE_3D": bb3d,
            "BACKBONE_2D": {"LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [16],
                            "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [16]},
            "DENSE_HEAD": dh}


def tf_batch(seed, names, b=2, n=1024, m=8, vel=False):
    """Points in the grid's range and gt of `names`' classes (10 columns
    with `vel`); the last two gt slots of each frame are invalid."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.5, 12.3, (b, n))
    pts[..., 1] = rng.uniform(-6, 6, (b, n))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, -40:] = False
    cols = 10 if vel else 8
    gt = np.zeros((b, m, cols), np.float32)
    gt[..., 0] = rng.uniform(1, 11, (b, m))
    gt[..., 1] = rng.uniform(-5, 5, (b, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (b, m))
    gt[..., 3:6] = rng.uniform(0.5, 4, (b, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    if vel:
        gt[..., 7:9] = rng.uniform(-2, 2, (b, m, 2))
    gt[..., -1] = rng.randint(1, len(names) + 1, (b, m))
    gt_valid = np.ones((b, m), bool)
    gt_valid[:, -2:] = False
    return pts, valid, gt, gt_valid


def jax_batch(arrays):
    from dfu3d_tpu.data.dataset import PointBatch as JPointBatch

    return JPointBatch(*(jnp.asarray(a) for a in arrays))


# --------------------------------------------------------------------------
# the head's parts
# --------------------------------------------------------------------------

HEAD_PCR = [0, -4.8, -3, 12.8, 4.8, 1]   # a 32 x 24 (x by y) map at stride 2


def head_pair(num_class, vel, proposals, seed=0, matcher="hungarian", in_ch=8):
    """(JAX TransFusionHead, flax variables, port head with them) on
    HEAD_PCR at stride 2."""
    kw = dict(num_proposals=proposals, hidden=16, num_heads=2, ffn_channel=64, use_vel=vel,
              point_cloud_range=tuple(HEAD_PCR), voxel_size=tuple(VOXEL), feature_map_stride=2)
    jhead = jth.TransFusionHead(num_class=num_class, matcher=matcher, **kw)
    head = pth.TransFusionHead(in_ch, num_class, HEAD_PCR, VOXEL, num_proposals=proposals,
                               hidden=16, num_heads=2, ffn_channel=64, use_vel=vel,
                               feature_map_stride=2, matcher=matcher)
    variables = numpy_variables(lambda: variables_like(head), seed=seed)
    params_from_jax(variables, head)
    return jhead, variables, head


def bev_input(seed, b=2, h=24, w=32, c=8):
    return np.random.RandomState(seed).normal(0, 1, (b, h, w, c)).astype(np.float32)


def head_gt(seed, num_class, vel, b=2, m=9):
    rng = np.random.RandomState(seed)
    cols = 10 if vel else 8
    gt = np.zeros((b, m, cols), np.float32)
    gt[..., 0] = rng.uniform(0.5, 12.3, (b, m))
    gt[..., 1] = rng.uniform(-4.5, 4.5, (b, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (b, m))
    gt[..., 3:6] = rng.uniform(0.4, 5, (b, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    if vel:
        gt[..., 7:9] = rng.uniform(-3, 3, (b, m, 2))
    gt[..., -1] = rng.randint(1, num_class + 1, (b, m))
    gv = np.ones((b, m), bool)
    gv[0, -3:] = False
    return gt, gv


def test_position_embedding_attention_layernorm_match_flax():
    """PositionEmbeddingLearned (eval and train, with its BN statistics),
    flax's MultiHeadDotProductAttention and LayerNorm, each within 1e-5."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 40, (2, 50, 2)).astype(np.float32)
    jpe = jth.PositionEmbeddingLearned(16)
    pe = pth.PositionEmbeddingLearned(16)
    variables = numpy_variables(lambda: flax_variables_like(pe), seed=1)
    params_from_jax(variables, pe)
    for train in (False, True):
        pe.train(train)
        want, stats = jpe.apply(variables, jnp.asarray(xy), train, mutable=["batch_stats"])
        close(pe(t(xy)).detach(), want)
    np.testing.assert_allclose(pe.bn.running_var.numpy(),
                               np.asarray(stats["batch_stats"]["bn"]["var"]), rtol=TOL)

    q = rng.normal(0, 1, (2, 7, 16)).astype(np.float32)
    kv = rng.normal(0, 1, (2, 40, 16)).astype(np.float32)
    jmha = jnn.MultiHeadDotProductAttention(num_heads=2, param_dtype=jnp.float32)
    mha = pth.MultiHeadAttention(16, 2)
    variables = numpy_variables(lambda: jmha.init(jax.random.PRNGKey(0), q, kv, kv), seed=2)
    params_from_jax(variables, mha)
    want = jmha.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    np.testing.assert_allclose(mha(t(q), t(kv), t(kv)).detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)

    x = (rng.normal(3, 2, (2, 7, 16))).astype(np.float32)
    jln = jnn.LayerNorm(epsilon=1e-5, param_dtype=jnp.float32)
    ln = pth.LayerNorm(16)
    variables = numpy_variables(lambda: jln.init(jax.random.PRNGKey(0), x), seed=3)
    params_from_jax(variables, ln)
    np.testing.assert_allclose(ln(t(x)).detach().numpy(),
                               np.asarray(jln.apply(variables, jnp.asarray(x))), rtol=0, atol=TOL)


@pytest.mark.parametrize("num_class", [3, 10])
def test_local_max_matches_jax(num_class):
    """The interior local max on a heat map with exact ties (values on a
    grid of 1/8): equal, borders 0, nuScenes' classes 8 and 9 (with 10
    classes) at kernel 1; and the query mask hm == local max equal."""
    rng = np.random.RandomState(num_class)
    hm = (rng.randint(0, 9, (2, 24, 32, num_class)) / 8).astype(np.float32)
    jhead = jth.TransFusionHead(num_class=num_class)
    want = np.asarray(jhead.apply({}, jnp.asarray(hm), method=lambda m, x: m._local_max(x)))
    head = pth.TransFusionHead(8, num_class, HEAD_PCR, VOXEL)
    got = head.local_max(t(hm).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hm == got, hm == want)
    assert head.small_classes == ((8, 9) if num_class == 10 else ())


@pytest.mark.parametrize("num_class, vel, proposals", [(3, False, 16), (10, True, 64)])
@pytest.mark.parametrize("train", [False, True])
def test_head_matches_jax(num_class, vel, proposals, train):
    """The head on one BEV map (B=2, 24 x 32 cells, x by y unequal): the
    queries' classes and cells exactly equal, every branch (center, height,
    dim, rot, vel, heatmap), the dense heat map and the query scores within
    1e-5; in train mode the BN statistics too."""
    jhead, variables, head = head_pair(num_class, vel, proposals, seed=num_class)
    bev = bev_input(num_class)
    head.train(train)
    if train:
        want, stats = jhead.apply(variables, jnp.asarray(bev), True, mutable=["batch_stats"])
    else:
        want = jhead.apply(variables, jnp.asarray(bev), False)
    got = head(t(bev))
    np.testing.assert_array_equal(got["q_cls"].numpy(), np.asarray(want["q_cls"]))
    np.testing.assert_array_equal(got["q_pos"].numpy(), np.asarray(want["q_pos"]))
    w = bev.shape[2]
    np.testing.assert_array_equal(got["q_cell"].numpy(),
                                  (np.asarray(want["q_pos"]) - 0.5) @ np.array([1, w]))
    for k in want:
        if k not in ("q_cls", "q_pos"):
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                       atol=TOL, err_msg=k)
    assert set(want) | {"q_cell"} == set(got)
    if train:
        flat = params_from_jax({"batch_stats": stats["batch_stats"]})
        own = head.state_dict()
        for k, v in flat.items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("num_class, vel", [(3, False), (10, True)])
def test_decode_matches_jax(num_class, vel):
    """decode from the same predictions: boxes (7 or 9 columns) and scores
    within 1e-5, labels (first maximal class) equal."""
    jhead, variables, head = head_pair(num_class, vel, 16, seed=1)
    preds = jhead.apply(variables, jnp.asarray(bev_input(5)), False)
    want = jhead.apply({}, preds, method=lambda m, p: m.decode(p))
    got = head.decode({k: t(v) for k, v in preds.items()})
    assert got[0].shape[-1] == (9 if vel else 7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("num_class", [3, 10])
def test_gaussian_heatmap_targets_match_jax(num_class):
    """The class-flat splat on a 24 x 32 map: invalid gt, class 0, a class
    id past num_class (clipped) and boxes outside the map included; within
    1e-6."""
    gt, gv = head_gt(7, num_class, vel=False, m=12)
    gt[1, 0, -1] = 0
    gt[1, 1, -1] = num_class + 2
    gt[1, 2, :2] = [-3.0, 9.0]
    want = jch.gaussian_heatmap_targets(jnp.asarray(gt), jnp.asarray(gv), num_class, (24, 32),
                                        tuple(HEAD_PCR), tuple(VOXEL), 2)
    got = pth.gaussian_heatmap_targets(t(gt), t(gv), num_class, (24, 32), HEAD_PCR, VOXEL, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert (got.numpy() == 1.0).sum() > 0


def detection_costs(seed, q=200, m=40):
    """tests/test_camera_branch.py's detection-like costs: queries scattered
    around 3-40 valid gt centres."""
    rng = np.random.default_rng(seed)
    nvalid = int(rng.integers(3, m + 1))
    gv = np.zeros(m, bool)
    gv[rng.permutation(m)[:nvalid]] = True
    centers = rng.uniform(0, 100, (m, 2))
    qpos = centers[rng.choice(np.flatnonzero(gv), q)] + rng.normal(0, 5, (q, 2))
    d = np.linalg.norm(qpos[:, None] - centers[None], axis=-1)
    cost = (0.25 * d + 0.15 * rng.uniform(0, 1, (q, m))).astype(np.float32)
    return np.where(gv[None], cost, 1e6).astype(np.float32), gv


def test_hungarian_matches_scipy_and_jax():
    """20 seeded (200, 40) costs with 3-40 valid gt: the port's indices equal
    JAX's hungarian_match and scipy's linear_sum_assignment on the valid
    columns; plus integer costs full of exact ties, rectangular both ways,
    against scipy (the tie-breaking of its algorithm)."""
    for seed in range(20):
        cost, gv = detection_costs(seed)
        got = pth.hungarian_match(t(cost)[None], t(gv)[None])[0].numpy()
        want = np.asarray(jth.hungarian_match(jnp.asarray(cost), jnp.asarray(gv)))
        np.testing.assert_array_equal(got, want)
        cols = np.flatnonzero(gv)
        rows, cc = scipy_lsa(cost[:, cols].astype(np.float64))
        expect = np.full(200, -1)
        expect[rows] = cols[cc]
        np.testing.assert_array_equal(got, expect)
    rng = np.random.RandomState(0)
    for shape in ((6, 6), (12, 5), (5, 12), (30, 30), (1, 4), (4, 1)):
        for _ in range(5):
            cost = rng.randint(0, 3, shape).astype(np.float64)
            for a, b in zip(pth.linear_sum_assignment(cost), scipy_lsa(cost)):
                np.testing.assert_array_equal(a, b)


def test_greedy_matches_jax():
    """greedy_match against JAX's on the 20 seeded costs and on costs with
    exact ties (the first index of the flattened argmin), batched: indices
    equal."""
    costs, gvs = zip(*(detection_costs(seed) for seed in range(20)))
    rng = np.random.RandomState(1)
    for _ in range(4):
        costs += ((rng.randint(0, 4, (200, 40)) / 4).astype(np.float32),)
        gvs += (rng.uniform(0, 1, 40) > 0.3,)
    got = pth.greedy_match(t(np.stack(costs)), t(np.stack(gvs))).numpy()
    for i, (cost, gv) in enumerate(zip(costs, gvs)):
        np.testing.assert_array_equal(
            got[i], np.asarray(jth.greedy_match(jnp.asarray(cost), jnp.asarray(gv))))


@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
@pytest.mark.parametrize("num_class, vel", [(3, False), (10, True)])
def test_loss_matches_jax(matcher, num_class, vel):
    """The loss from the same predictions and gt: the total and each term
    within 1e-5 relative, for either matcher."""
    jhead, variables, head = head_pair(num_class, vel, 64, seed=2, matcher=matcher)
    preds = jhead.apply(variables, jnp.asarray(bev_input(6)), False)
    gt, gv = head_gt(8, num_class, vel)
    lw = {"code_weights": [1.0] * 8 + [0.2, 0.2]} if vel else {}
    want, wtb = jhead.apply({}, preds, jnp.asarray(gt), jnp.asarray(gv), lw,
                            method=lambda m, *a: m.loss(*a))
    got, tb = head.loss({k: t(v) for k, v in preds.items()}, t(gt), t(gv), lw)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    for k in wtb:
        np.testing.assert_allclose(float(tb[k]), float(wtb[k]), rtol=TOL, err_msg=k)
    assert float(tb["tf_reg_loss"]) > 0


# --------------------------------------------------------------------------
# the detector
# --------------------------------------------------------------------------

def model_pair(cfg, names, seed=1, train=False):
    grid = VoxelGrid.create(PCR, VOXEL)
    model = build_network(CfgDict(cfg), names, grid, device="cpu", train=train,
                          max_voxels=MAX_VOXELS)
    variables = numpy_variables(lambda: variables_like(model), seed=seed)
    params_from_jax(variables, model)
    return variables, model


def compare_model(jmodel, variables, model, arrays):
    """predict (keep masks and labels equal, boxes within 1e-5 absolute or
    relative, scores within 1e-5, the queries exactly) and the train-mode loss (terms within 1e-5
    relative) of `model` against `jmodel` on the batch `arrays`; JAX's
    three programs in one jit."""
    def run(v, b):
        def features_and_decode(m, b):
            feats = m._features(b, False)
            return feats, m.dense_head.decode(feats)

        feats, decoded = jmodel.apply(v, b, method=features_and_decode)
        (loss, tb), _ = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return feats, decoded, loss, tb

    feats, (boxes, scores, labels), jloss, jtb = jax.jit(run)(variables, jax_batch(arrays))
    batch = PointBatch.from_numpy(*arrays)
    model.eval()
    with torch.no_grad():
        got_feats = model.features(batch)
        got = model.predict(batch)
    np.testing.assert_array_equal(got_feats["q_cls"].numpy(), np.asarray(feats["q_cls"]))
    np.testing.assert_array_equal(got_feats["q_pos"].numpy(), np.asarray(feats["q_pos"]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(scores) > 0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(labels))
    # boxes within 1e-5 absolute or relative: the dims are exponentials
    # (8 m here, where fp32 rounds at 1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(boxes), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(scores), rtol=0, atol=TOL)
    model.train()
    loss, tb = model(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=TOL, err_msg=k)


def test_transfusion_matches_jax():
    """JAX's TransFusion (VoxelBackBone8x, 10 classes, the vel branch, 32
    proposals) and the port from the same weights: the flax tree of JAX's
    init is the port's state_dict leaf for leaf; predict and the loss
    agree (`compare_model`)."""
    cfg = tf_cfg(vel=True, proposals=32)
    jmodel = j_build_network(JCfgDict(cfg), NUSC, JVoxelGrid.create(PCR, VOXEL),
                             max_voxels=MAX_VOXELS)
    variables, model = model_pair(cfg, NUSC)
    arrays = tf_batch(3, NUSC, vel=True)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jax_batch(arrays), train=False))
    assert (jax.tree_util.tree_map(lambda s: s.shape, shapes)
            == jax.tree_util.tree_map(lambda a: a.shape, variables))
    assert type(model.backbone_3d).__name__ == "VoxelBackBone8x"
    compare_model(jmodel, variables, model, arrays)


class ResTrunkTransFusion(jbev.TransFusion):
    """JAX's TransFusion with the trunk BACKBONE_3D names
    (VoxelResBackBone8x, as JAX's CenterPoint builds it): JAX's own
    modules, assembled here; the rest of the class is JAX's."""

    def setup(self):
        cfg = self.cfg
        nx, ny, nz = self.grid.grid_size
        bb3d = cfg.BACKBONE_3D
        self.backbone_3d = JVoxelResBackBone8x(
            grid=JSparseGrid(nx, ny, nz), voxel_cap=self.max_voxels,
            channels=tuple(bb3d.CHANNELS), out_channels=bb3d.OUT_CHANNELS, dtype=self.dtype)
        bb = cfg.BACKBONE_2D
        self.backbone_2d = JBaseBEVBackbone(
            layer_nums=tuple(bb.LAYER_NUMS), layer_strides=tuple(bb.LAYER_STRIDES),
            num_filters=tuple(bb.NUM_FILTERS), upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
            num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS), dtype=self.dtype)
        dh = cfg.DENSE_HEAD
        tac = dh.get("TARGET_ASSIGNER_CONFIG", {})
        self.dense_head = jth.TransFusionHead(
            num_class=len(self.class_names),
            num_proposals=int(dh.get("NUM_PROPOSALS", 200)),
            hidden=int(dh.get("HIDDEN_CHANNEL", 128)), num_heads=int(dh.get("NUM_HEADS", 8)),
            ffn_channel=int(dh.get("FFN_CHANNEL", 256)),
            num_hm_conv=int(dh.get("NUM_HM_CONV", 2)),
            nms_kernel_size=int(dh.get("NMS_KERNEL_SIZE", 3)),
            use_vel="vel" in list(dh.get("SEPARATE_HEAD_CFG", {}).get("HEAD_ORDER", [])),
            dataset_name=str(tac.get("DATASET", "nuScenes")),
            use_bias_before_norm=bool(dh.get("USE_BIAS_BEFORE_NORM", False)),
            bn_momentum=1.0 - float(dh.get("BN_MOMENTUM", 0.1)),
            point_cloud_range=tuple(self.grid.point_cloud_range),
            voxel_size=tuple(self.grid.voxel_size),
            feature_map_stride=int(tac.get("FEATURE_MAP_STRIDE", 8)),
            matcher=str(dh.get("MATCHER", "auto")), dtype=self.dtype)


def reference_state(model, seed=0):
    """A reference-keyed state for `model`'s reference mapping: Conv1d
    weights (out, in, 1), the attentions' packed in_proj (3C, C) and (3C,),
    the rest as the port holds them; N(0, 0.05), running variances
    U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    own = model.state_dict()
    state = {}
    for ours, (ref, fn) in model.reference_mapping().items():
        if ours not in own or ref in state:
            continue
        shape = tuple(own[ours].shape)
        if ref.endswith(("in_proj_weight", "in_proj_bias")):
            shape = (3 * shape[0],) + shape[1:]
        elif fn is torch_convert.t_fc:
            shape += (1,)
        w = (rng.uniform(0.5, 1.5, shape) if ref.endswith("running_var")
             else rng.normal(0, 0.05, shape))
        state[ref] = torch.from_numpy(w.astype(np.float32))
    return state


@pytest.mark.parametrize("vel", [False, True])
def test_reference_mapping_matches_jax(vel):
    """A reference TransFusion state loaded through the port's mapping
    equals JAX's `transfusion_head_mapping` on every head key (the packed
    attention split in three, the Conv1d stacks); the 2D backbone loads too
    and exactly the sparse trunk stays unmatched."""
    cfg = tf_cfg(vel=vel)
    names = NUSC if vel else NAMES3
    variables, model = model_pair(cfg, names, seed=5)
    state = reference_state(model, seed=6)
    assert torch_convert.is_reference_state(state)
    assert not torch_convert.is_reference_state(model.state_dict())
    j_mapping = jtc.transfusion_head_mapping(num_heads=2, use_vel=vel)
    j_vars, j_report = jtc.apply_mapping(variables, {k: v.numpy() for k, v in state.items()},
                                         j_mapping)
    assert not j_report["missing_in_torch"]
    want = params_from_jax(j_vars)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = torch_convert.load_reference_state(model, state)
    got = model.state_dict()
    assert not report["missing_in_torch"]
    head = [k for k in got if k.startswith("dense_head.")]
    for k in head:
        assert torch.equal(got[k], want[k]), k
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {k for k in got if not k.startswith("backbone_3d.")}
    assert sorted(report["unmatched_ours"]) == sorted(k for k in got
                                                      if k.startswith("backbone_3d."))


def test_shipped_config_builds_the_named_trunk(monkeypatch):
    """transfusion_lidar.yaml names VoxelResBackBone8x with four CHANNELS.
    JAX's TransFusion builds VoxelBackBone8x whatever the name and reads
    its fifth channel: its init raises IndexError. The port, built as the
    CLIs build it (`zoo.transfusion`), has the named trunk at the published
    widths, the grid and voxel caps of the config, in eval or train mode."""
    from pathlib import Path

    from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from dfu3d_tpu_torch import zoo

    monkeypatch.chdir(Path(__file__).resolve().parents[1] / "tools")
    jcfg = j_cfg_from_yaml_file("cfgs/nuscenes_models/transfusion_lidar.yaml", JCfgDict())
    (vox,) = [p for p in jcfg.DATA_CONFIG.DATA_PROCESSOR
              if p.NAME == "transform_points_to_voxels"]
    jmodel = j_build_network(jcfg.MODEL, jcfg.CLASS_NAMES,
                             JVoxelGrid.create(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE, vox.VOXEL_SIZE),
                             max_voxels=2048)
    pts, valid, gt, gv = tf_batch(0, NUSC, b=1, n=256, vel=True)
    pts = np.concatenate([pts, np.zeros(pts.shape[:2] + (1,), np.float32)], axis=-1)
    with pytest.raises(IndexError):
        jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                           jax_batch((pts, valid, gt, gv)), train=False))
    for train, cap in ((False, 160000), (True, 120000)):
        cfg, grid, model = zoo.transfusion(device="cpu", train=train)
        assert type(model.backbone_3d).__name__ == "VoxelResBackBone8x"
        assert model.training == train and model.vfe.max_voxels == cap
        assert tuple(grid.grid_size) == (1440, 1440, 40)
        assert model.backbone_2d.out_channels == 512 and model.dense_head.num_proposals == 200
        assert sum(p.numel() for p in model.parameters()) == 8_453_486
    with pytest.raises(RuntimeError):   # no card here: the default device raises
        zoo.transfusion()
