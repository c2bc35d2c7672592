"""Port parity: the camera branch and BEVFusion against the JAX package, on
the CPU, fp32 on both sides, from the same numpy inputs and weights (flax
layout, carried across by `params_from_jax`), at narrow widths (Swin embed
12, depths (2, 2), window 4 on 40 x 72 images; a 64 x 64 x 16 grid):

* `bev_pool`, the dense and the compacted form, a cap that truncates
  included: within 1e-5 (its sums are order-free on the card);
* the resizes: jax.image.resize "nearest" at CaDDN's 375 x 1242 → 94 x 311
  exactly, "bilinear" upsamplings at DeepLab's 47 x 156 → 94 x 311 and the
  FPN's 2x, and a shrink (antialiased), within 1e-6;
* Swin on a map that needs padding, shifted blocks included; the FPN;
  DepthLSS's geometry (1e-5 of the metres), depth net and BEV output;
* BEVFusion's predict and loss with the shipped config's trunk
  (VoxelResBackBone8x, JAX's own modules assembled: JAX's BevFusion builds
  VoxelBackBone8x whatever BACKBONE_3D names) and its predict with a
  config without a NAME (the two JAX programs compile side by side);
* the Swin, LSS FPN and DeepLab reference mappings against JAX's on one
  seeded reference-layout state dict; `params_from_jax` on each camera
  model (the flax tree of JAX's init is the port's state_dict).

Tolerance: 1e-4 of the output's scale (its largest |entry|, at least 1)
unless a test says otherwise. CaDDN is in tests/test_torch_port_camera_train.py,
the focal Voxel R-CNN in tests/test_torch_port_focal.py; both import the
batches and pairs made here.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.core.voxel.bev_pool import bev_pool as j_bev_pool
from dfu3d_tpu.data.dataset import MultimodalBatch as JMultimodalBatch
from dfu3d_tpu.models import bevfusion as jbev
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models.image import DepthLSSTransform as JDepthLSS
from dfu3d_tpu.models.image import GeneralizedLSSFPN as JFPN
from dfu3d_tpu.models.image import SwinTransformer as JSwin
from dfu3d_tpu.models.sparse_backbone import VoxelResBackBone8x as JVoxelResBackBone8x
from dfu3d_tpu.train import torch_convert as jtc
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import VoxelGrid
from dfu3d_tpu_torch.core.voxel.bev_pool import bev_pool
from dfu3d_tpu_torch.data.batch import MultimodalBatch
from dfu3d_tpu_torch.models import build_network
from dfu3d_tpu_torch.models.image import common as pcommon
from dfu3d_tpu_torch.models.image.depth_lss import DepthLSSTransform
from dfu3d_tpu_torch.models.image.fpn import GeneralizedLSSFPN
from dfu3d_tpu_torch.models.image.swin import SwinTransformer
from dfu3d_tpu_torch.train import torch_convert
from dfu3d_tpu_torch.utils.config import CfgDict
from dfu3d_tpu_torch.zoo import project_depth

from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR = [0, -6.4, -3, 12.8, 6.4, 1]
VOXEL = [0.2, 0.2, 0.25]
NAMES3 = ["Car", "Pedestrian", "Cyclist"]
IMG = (40, 72)          # Swin tokens 10 x 18, padded to 12 x 20; 5 x 9 after the merge
FEAT = (10, 18)
TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, err_msg=""):
    """Within `tol` of the larger of 1 and the largest |entry| of `want`."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=err_msg)


def variables_like(model, seed=0, gains=None):
    """numpy weights in the flax tree of the port model's state_dict (flax's
    attention layout for TransFusionHead's), without an empty collection."""
    from test_torch_port_transfusion import variables_like as attention_variables_like

    v = numpy_variables(lambda: attention_variables_like(model), seed=seed, gains=gains)
    return {k: c for k, c in v.items() if c}


# --------------------------------------------------------------------------
# test batches: a camera rig, points, gt, depth maps projected from the points
# --------------------------------------------------------------------------

def camera_rig_arrays(n_cam, image_size):
    """(intrinsics, cam2lidar rots, cam2lidar trans, lidar_to_cam,
    cam_to_img) of n_cam cameras at the lidar's origin looking along yaws
    0, 180, 90, -90 degrees, focal length 0.6 of the image width."""
    h, w = image_size
    f = 0.6 * w
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    out = [[] for _ in range(5)]
    for yaw in np.deg2rad([0.0, 180.0, 90.0, -90.0][:n_cam]):
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        rot = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        trans = np.array([0.1, -0.05, 0.2])
        l2c = np.eye(4)
        l2c[:3, :3], l2c[:3, 3] = rot.T, -rot.T @ trans
        for lst, a in zip(out, (k, rot, trans, l2c, np.concatenate([k, np.zeros((3, 1))], 1))):
            lst.append(a)
    return [np.asarray(a, np.float32) for a in out]


def mm_arrays(seed, b=2, n_cam=1, image_size=(64, 64), n=768, m=8, pcr=PCR):
    """The numpy fields of a MultimodalBatch: points in `pcr`'s range (4
    features; the last 32 slots invalid), m gt of 3 classes (the last two
    invalid), the rig of `camera_rig_arrays`, depth maps of the points projected
    into each camera, normalised uniform images (mean 0, std 1)."""
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(pcr[:3], np.float32), np.asarray(pcr[3:], np.float32)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., :3] = rng.uniform(lo + 0.2, hi - 0.2, (b, n, 3))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, -32:] = False
    gt = np.zeros((b, m, 8), np.float32)
    gt[..., 0] = rng.uniform(lo[0] + 1, hi[0] - 1, (b, m))
    gt[..., 1] = rng.uniform(lo[1] + 1, hi[1] - 1, (b, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (b, m))
    gt[..., 3:6] = rng.uniform(0.8, 3, (b, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    gt[..., 7] = rng.randint(1, 4, (b, m))
    gt_valid = np.ones((b, m), bool)
    gt_valid[:, -2:] = False
    rig = camera_rig_arrays(n_cam, image_size)
    depth = np.stack([project_depth(pts[i][valid[i]], rig[3], rig[4], image_size)
                      for i in range(b)])
    # normalised as the datasets' image_normalization leaves them: on
    # images of mean 0.5 the image BNs' one-pass variances cancel to 1e-2
    images = ((rng.uniform(0, 1, (b, n_cam) + tuple(image_size) + (3,)) - 0.5) / 0.29).astype(
        np.float32)
    per_frame = [np.ascontiguousarray(np.broadcast_to(a, (b,) + a.shape)) for a in rig]
    return (pts, valid, gt, gt_valid, images, *per_frame, depth)


def jax_batch(arrays):
    return JMultimodalBatch(*(jnp.asarray(a) for a in arrays))


def port_batch(arrays):
    return MultimodalBatch.from_numpy(*arrays)


# --------------------------------------------------------------------------
# bev_pool and the resizes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0, 200, 37])
def test_bev_pool_matches_jax(cap):
    """The dense form (cap 0), the compacted one covering every pooled
    cell (200) and one that truncates (37 of the ~150 cells: the later
    cells' points dropped), out-of-grid and invalid points included."""
    rng = np.random.RandomState(0)
    p, c, b, nz, ny, nx = 600, 6, 2, 2, 8, 8
    feats = rng.randn(p, c).astype(np.float32)
    coords = np.stack([rng.randint(0, b, p), rng.randint(-1, nz + 1, p), rng.randint(0, ny, p),
                       rng.randint(-1, nx + 1, p)], axis=1).astype(np.int32)
    valid = rng.rand(p) > 0.1
    want = np.asarray(j_bev_pool(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                                 b, nz, ny, nx, max_cells=cap))
    got = bev_pool(t(feats), t(coords), t(valid), b, nz, ny, nx, max_cells=cap)
    close(got.numpy(), want, 1e-5)
    if cap == 37:
        assert (np.abs(want).sum(-1) > 0).sum() == 37


def test_resizes_match_jax():
    """jax.image.resize "nearest" (CaDDN's depth targets, 375 x 1242 →
    94 x 311, where nearest-exact would pick column 620 for 621) exactly,
    and "bilinear": the upsamplings (DeepLab's logits 47 x 156 → 94 x 311,
    the FPN's 2x) and an antialiased shrink (a camera BEV onto a coarser
    lidar BEV) within 1e-6."""
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 50, (2, 375, 1242)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 94, 311), "nearest"))
    np.testing.assert_array_equal(pcommon.resize_nearest(t(x), (94, 311)).numpy(), want)
    assert pcommon.nearest_indices(1242, 311)[155] == 621
    for src, dst in (((47, 156), (94, 311)), ((5, 9), (10, 18)), ((24, 20), (8, 8))):
        y = rng.randn(2, *src, 3).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(y), (2, *dst, 3), "bilinear"))
        close(pcommon.resize_bilinear(t(y), dst).numpy(), want, 1e-6)


# --------------------------------------------------------------------------
# Swin, the FPN, DepthLSS
# --------------------------------------------------------------------------

SWIN_KW = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 4), window_size=4, patch_size=4,
               out_indices=(0, 1))


def test_swin_matches_jax():
    """Swin on 40 x 72 images: 10 x 18 tokens padded to 12 x 20 windows,
    the odd blocks shifted by 2 with the mask of the padded map; the merge
    pads 10 x 18 → 5 x 9, which stage 1 pads to 8 x 12. Both stages' maps
    within 1e-4; the flax tree of JAX's init is the port's state_dict."""
    port = SwinTransformer(**SWIN_KW)
    jmod = JSwin(**SWIN_KW)
    images = np.random.RandomState(2).uniform(0, 1, (2,) + IMG + (3,)).astype(np.float32)
    variables = variables_like(port, seed=3)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(images)))
    assert (jax.tree_util.tree_map(lambda s: s.shape, shapes)
            == jax.tree_util.tree_map(lambda a: a.shape, variables))
    want = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(images))
    params_from_jax(variables, port)
    with torch.no_grad():
        got = port(t(images))
    assert [tuple(g.shape) for g in got] == [(2, 10, 18, 12), (2, 5, 9, 24)]
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("train", [False, True])
def test_fpn_matches_jax(train):
    """Three levels (two processed, the raw coarsest upsampled 2x), in eval
    and in train mode (BN batch statistics)."""
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, 20 // s, 36 // s, c).astype(np.float32)
             for s, c in ((1, 12), (2, 24), (4, 48))]
    port = GeneralizedLSSFPN((12, 24, 48), 16, num_outs=2).train(train)
    jmod = JFPN(in_channels=(12, 24, 48), out_channels=16, num_outs=2)
    variables = variables_like(port, seed=5)
    want, _ = jax.jit(lambda v, f: jmod.apply(v, f, train, mutable=["batch_stats"]))(
        variables, [jnp.asarray(f) for f in feats])
    params_from_jax(variables, port)
    with torch.no_grad():
        got = port([t(f) for f in feats])
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w))


LSS_KW = dict(in_channel=16, out_channel=8, image_size=IMG, feature_size=FEAT,
              xbound=[0.0, 12.8, 0.8], ybound=[-6.4, 6.4, 0.8], zbound=[-3.0, 1.0, 2.0],
              dbound=[1.0, 13.0, 1.0])


@pytest.mark.parametrize("downsample", [1, 2])
def test_depth_lss_matches_jax(downsample):
    """Two cameras looking ahead and back: the geometry within 1e-5 of its
    largest coordinate, the depth net's output and the BEV map (two z
    cells, folded into channels; with DOWNSAMPLE 2 the three convs) within
    1e-4; the depth maps reach the net through the dtransform convs and a
    bilinear upsampling (5 x 9 → 10 x 18)."""
    arrays = mm_arrays(6, n_cam=2, image_size=IMG)
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 2, *FEAT, 16).astype(np.float32)
    kw = dict(LSS_KW, downsample=downsample)
    port = DepthLSSTransform(**kw)
    jmod = JDepthLSS(**kw)
    variables = variables_like(port, seed=8)
    depth, rots, trans, intr = arrays[-1], arrays[6], arrays[7], arrays[5]

    def run(v):
        geom = jmod.apply(v, jnp.asarray(rots), jnp.asarray(trans), jnp.asarray(intr),
                          method=lambda m, r, tr, k: m.get_geometry(r, tr, k))
        out = jmod.apply(v, jnp.asarray(feats), jnp.asarray(depth[..., None]),
                         jnp.asarray(rots), jnp.asarray(trans), jnp.asarray(intr))
        return geom, out

    geom, want = jax.jit(run)(variables)
    params_from_jax(variables, port.eval())
    with torch.no_grad():
        got_geom = port.get_geometry(t(rots), t(trans), t(intr))
        got = port(t(feats), t(depth), t(rots), t(trans), t(intr))
    close(got_geom.numpy(), np.asarray(geom), 1e-5)
    assert tuple(got.shape) == np.asarray(want).shape
    close(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 0


# --------------------------------------------------------------------------
# BEVFusion
# --------------------------------------------------------------------------

def bevfusion_cfg(named_trunk=True):
    """BEVFusion at narrow widths: the shipped config's trunk kind
    (VoxelResBackBone8x with four CHANNELS), or none named (VoxelBackBone8x);
    Swin-T's layout cut to two stages, the LSS FPN, DepthLSS with 12 depth
    bins and DOWNSAMPLE 2 onto the lidar's 8 x 8 BEV, 16 proposals."""
    bb3d = ({"NAME": "VoxelResBackBone8x", "CHANNELS": [4, 8, 8, 8], "OUT_CHANNELS": 16}
            if named_trunk else {"CHANNELS": [4, 4, 8, 8, 8], "OUT_CHANNELS": 16})
    return {"NAME": "BevFusion", "BACKBONE_3D": bb3d,
            "BACKBONE_2D": {"LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [16],
                            "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [16]},
            "DENSE_HEAD": {"NAME": "TransFusionHead", "NUM_PROPOSALS": 16,
                           "HIDDEN_CHANNEL": 16, "NUM_HEADS": 2, "FFN_CHANNEL": 32,
                           "TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 8}},
            "IMAGE_BACKBONE": {"EMBED_DIMS": 12, "DEPTHS": [2, 2], "NUM_HEADS": [2, 4],
                               "WINDOW_SIZE": 4, "PATCH_SIZE": 4, "OUT_INDICES": [0, 1]},
            "NECK": {"IN_CHANNELS": [12, 24], "OUT_CHANNELS": 16},
            "VTRANSFORM": {"OUT_CHANNEL": 8, "IMAGE_SIZE": list(IMG), "FEATURE_SIZE": list(FEAT),
                           "XBOUND": [0.0, 12.8, 0.8], "YBOUND": [-6.4, 6.4, 0.8],
                           "ZBOUND": [-3.0, 1.0, 4.0], "DBOUND": [1.0, 13.0, 1.0],
                           "DOWNSAMPLE": 2},
            "FUSER": {"OUT_CHANNEL": 16}}


def model_pair(cfg, seed=1, max_voxels=512, gains=None, **kw):
    """(port model, numpy variables in its flax tree)."""
    grid = VoxelGrid.create(PCR, VOXEL)
    model = build_network(CfgDict(cfg), NAMES3, grid, device="cpu", max_voxels=max_voxels, **kw)
    variables = variables_like(model, seed=seed, gains=gains)
    params_from_jax(variables, model)
    return model, variables


class Compiling(threading.Thread):
    """jax.jit(fn) traced and lowered at once, then compiled in a thread of
    its own (XLA compiles with the GIL released), so that a test's JAX
    programs compile side by side; `result()` joins and returns the
    executable."""

    def __init__(self, fn, *args):
        super().__init__()
        self.lowered, self.out, self.error = jax.jit(fn).lower(*args), None, None
        self.start()

    def run(self):
        try:
            self.out = self.lowered.compile()
        except Exception as e:  # raised again in result()
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.out


class ResTrunkBevFusion(jbev.BevFusion):
    """JAX's BevFusion with the trunk BACKBONE_3D names, JAX's own
    VoxelResBackBone8x (JAX's builds VoxelBackBone8x whatever the name):
    `select_backbone8x` hands it over while the setup runs."""

    def setup(self):
        select = jbev.select_backbone8x
        jbev.select_backbone8x = lambda bb3d: JVoxelResBackBone8x
        try:
            super().setup()
        finally:
            jbev.select_backbone8x = select


def bevfusion_programs(jmodel, with_loss):
    """JAX's features and decode of a batch and (with_loss) its train-mode
    loss, as two programs (they compile side by side)."""
    def predict(v, b):
        def features_and_decode(m, b):
            feats = m._features(b, False)
            return feats, m.dense_head.decode(feats)

        return jmodel.apply(v, b, method=features_and_decode)

    def loss(v, b):
        (total, tb), _ = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return total, tb

    return (predict, loss) if with_loss else (predict,)


@pytest.fixture(scope="module")
def bevfusion_pairs():
    """{"shipped", "unnamed"}: (JAX programs compiled, variables, port model,
    batch arrays). "shipped": the shipped config's trunk
    (`ResTrunkBevFusion`), predict and loss; "unnamed": a BACKBONE_3D without
    a NAME (VoxelBackBone8x on both sides), predict. All compile at once."""
    shipped = ResTrunkBevFusion(JCfgDict(bevfusion_cfg()), NAMES3,
                                JVoxelGrid.create(PCR, VOXEL), max_voxels=512)
    unnamed = j_build_network(JCfgDict(bevfusion_cfg(named_trunk=False)), NAMES3,
                              JVoxelGrid.create(PCR, VOXEL), max_voxels=512)
    out = {}
    for name, jmodel, seed, loss in (("shipped", shipped, 4, True),
                                     ("unnamed", unnamed, 6, False)):
        model, variables = model_pair(bevfusion_cfg(name == "shipped"), seed=seed)
        arrays = mm_arrays(seed + 1, n_cam=2, image_size=IMG)
        out[name] = [[Compiling(fn, variables, jax_batch(arrays))
                      for fn in bevfusion_programs(jmodel, loss)], variables, model, arrays]
    for entry in out.values():
        entry[0] = [c.result() for c in entry[0]]
    return out


def compare_bevfusion(programs, variables, model, arrays):
    """predict (queries exactly, keep masks and labels equal, boxes within
    1e-4 absolute or relative, scores within 1e-4) and, where a loss
    program is given, the train-mode loss (terms within 1e-4 relative)."""
    feats, (boxes, scores, labels) = programs[0](variables, jax_batch(arrays))
    batch = port_batch(arrays)
    model.eval()
    with torch.no_grad():
        got_feats = model.features(batch)
        got = model.predict(batch)
    np.testing.assert_array_equal(got_feats["q_cls"].numpy(), np.asarray(feats["q_cls"]))
    np.testing.assert_array_equal(got_feats["q_pos"].numpy(), np.asarray(feats["q_pos"]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(scores) > 0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(labels))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(boxes), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(scores), rtol=0, atol=TOL)
    if len(programs) == 1:
        return
    jloss, jtb = programs[1](variables, jax_batch(arrays))
    model.train()
    loss, tb = model(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=TOL, err_msg=k)


def test_bevfusion_shipped_trunk_matches_jax(bevfusion_pairs):
    """The shipped config's trunk: JAX's own VoxelResBackBone8x →
    height_compression → Swin → FPN → DepthLSS → ConvFuser →
    BaseBEVBackbone → TransFusionHead against the port's BevFusion:
    predict and the loss."""
    programs, variables, model, arrays = bevfusion_pairs["shipped"]
    assert type(model.backbone_3d).__name__ == "VoxelResBackBone8x"
    compare_bevfusion(programs, variables, model, arrays)


def test_bevfusion_without_a_trunk_name_matches_jax(bevfusion_pairs):
    """A BACKBONE_3D without a NAME: VoxelBackBone8x on both sides, JAX's
    BevFusion as it builds itself: predict (the loss path is the shipped
    trunk test's)."""
    programs, variables, model, arrays = bevfusion_pairs["unnamed"]
    assert type(model.backbone_3d).__name__ == "VoxelBackBone8x"
    compare_bevfusion(programs, variables, model, arrays)


# --------------------------------------------------------------------------
# reference mappings
# --------------------------------------------------------------------------

def reference_state(model, mapping, seed=0):
    """A reference-keyed state for `mapping` onto `model`: each reference
    tensor in the reference's layout (the port's, as the transforms are
    identities or permutations), N(0, 0.05), running variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    own = model.state_dict()
    state = {}
    for ours, (ref, _) in mapping.items():
        if ours not in own:
            continue
        w = (rng.uniform(0.5, 1.5, own[ours].shape) if ref.endswith("running_var")
             else rng.normal(0, 0.05, own[ours].shape))
        state[ref] = torch.from_numpy(w.astype(np.float32))
    return state


def check_mapping(model, variables, mapping, j_mapping, prefix=""):
    """The reference state loaded through the port's mapping equals JAX's
    mapping applied to the flax tree, carried across, key for key; every
    key of both converts."""
    state = reference_state(model, mapping)
    j_vars, j_report = jtc.apply_mapping(variables, {k: v.numpy() for k, v in state.items()},
                                         j_mapping)
    assert not j_report["missing_in_torch"]
    want = params_from_jax(j_vars)
    new, report = torch_convert.apply_mapping(model.state_dict(), state, mapping)
    assert not report["missing_in_torch"] and not report["unmatched_ours"]
    assert sorted(report["converted"]) == sorted(j_report["converted"])
    for k, v in new.items():
        assert torch.equal(v, want[prefix + k]), k


def test_swin_and_fpn_mappings_match_jax():
    swin = SwinTransformer(**SWIN_KW)
    variables = variables_like(swin, seed=9)
    wrap = {c: {"image_backbone": variables[c]} for c in variables}
    check_mapping(swin, wrap, {k.split(".", 1)[1]: v for k, v in
                               torch_convert.swin_mapping((2, 2), (0, 1)).items()},
                  jtc.swin_mapping(depths=(2, 2), out_indices=(0, 1)), "image_backbone.")
    fpn = GeneralizedLSSFPN((12, 24, 48), 16)
    variables = variables_like(fpn, seed=10)
    wrap = {c: {"image_neck": variables[c]} for c in variables}
    check_mapping(fpn, wrap, {k.split(".", 1)[1]: v for k, v in
                              torch_convert.lss_fpn_mapping(3).items()},
                  jtc.lss_fpn_mapping(num_levels=3), "image_neck.")


def test_deeplab_mapping_matches_jax():
    from dfu3d_tpu_torch.models.image.deeplab import DDNDeepLabV3

    ddn = DDNDeepLabV3(13, (1, 1, 1, 1))
    variables = variables_like(ddn, seed=11)
    check_mapping(ddn, variables, torch_convert.deeplab_ddn_mapping((1, 1, 1, 1)),
                  jtc.deeplab_ddn_mapping(layers=(1, 1, 1, 1)))


def test_camera_models_have_no_reference_mapping():
    """JAX composes no model-level mapping for BevFusion or CaDDN."""
    from test_torch_port_camera_train import caddn_cfg

    for cfg in (bevfusion_cfg(), caddn_cfg()):
        model = build_network(CfgDict(cfg), NAMES3, VoxelGrid.create(PCR, VOXEL), device="cpu")
        with pytest.raises(NotImplementedError, match="JAX package composes none"):
            model.reference_mapping()
