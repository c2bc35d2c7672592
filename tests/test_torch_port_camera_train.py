"""Port parity: CaDDN against the JAX package, on the CPU, fp32 on both
sides, from the same numpy inputs and weights (flax layout), at
tests/test_camera_branch.py's sizes (a 64 x 64 x 16 grid, 64 x 64 images
from one camera, 12 depth bins):

* `bin_depths_lid`, `frustum_to_voxel` (voxels behind the camera and
  outside the frustum included, the `ok` mask exactly), `ddn_depth_loss`
  and its gradient;
* DDNDeepLabV3 at ResNet layers (1, 1, 1, 1): features and logits (eval;
  its train mode in CaDDN's loss);
* CaDDN's predict and loss with the compact DDN and with the DeepLab one
  (CHANNEL_REDUCE), the two JAX programs compiled side by side;
* one whole train step of the compact CaDDN (make_train_step against
  JAX's, the KITTI configs' adam_onecycle): the loss terms within 1e-5
  relative, grad_norm within 1e-4 (and within 1e-5 of the fp64 norm of
  the port's gradients), every gradient leaf within 1e-4 of its largest
  entry, the parameters after the step and the BN statistics within 1e-5;
* `trainer.train_model` over MultimodalBatches.

Tolerance: 1e-4 of the output's scale unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dfu3d_tpu.core.voxel import VoxelGrid as JVoxelGrid
from dfu3d_tpu.models import build_network as j_build_network
from dfu3d_tpu.models.image import ddn as jddn
from dfu3d_tpu.models.image.deeplab import DDNDeepLabV3 as JDeepLab
from dfu3d_tpu.train.optimization import build_optimizer as j_build_optimizer
from dfu3d_tpu.train.train_state import TrainState as JTrainState
from dfu3d_tpu.train.train_state import make_train_step as j_make_train_step
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu_torch import zoo
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.models.image import ddn as pddn
from dfu3d_tpu_torch.models.image.deeplab import DDNDeepLabV3
from dfu3d_tpu_torch.train.train_state import create_train_state, make_train_step
from dfu3d_tpu_torch.utils.config import CfgDict

from test_pointpillar import pp_model_cfg
from test_torch_port_camera import (NAMES3, PCR, TOL, VOXEL, Compiling, close, jax_batch,
                                    mm_arrays, model_pair, port_batch, t, variables_like)
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import recording

KITTI_OPTIM = yaml.safe_load((zoo.KITTI_CFGS / "voxel_rcnn.yaml").read_text())["OPTIMIZATION"]
DISC = {"num_bins": 12, "depth_min": 2.0, "depth_max": 14.0}
GRAD_TOL = 1e-4   # of each gradient leaf's largest |entry|


def caddn_cfg(deeplab=False):
    """tests/test_camera_branch.py's CaDDN configs: the compact DDN (8
    features, stem 4, 8) or DDNDeepLabV3 at ResNet layers (1, 1, 1, 1) with
    CHANNEL_REDUCE 16; Conv2DCollapse 16, a one-block BEV backbone, the
    anchors at stride 2."""
    cfg = pp_model_cfg()
    cfg["NAME"] = "CaDDN"
    ddn = ({"NAME": "DDNDeepLabV3", "BACKBONE_NAME": "ResNet50", "LAYERS": [1, 1, 1, 1]}
           if deeplab else {"FEAT_CHANNELS": 8, "STEM_CHANNELS": [4, 8]})
    cfg["VFE"] = {"NAME": "ImageVFE", "DDN": ddn, "DISC_CFG": dict(DISC)}
    if deeplab:
        cfg["VFE"]["CHANNEL_REDUCE"] = {"in_channels": 256, "out_channels": 16}
    cfg["MAP_TO_BEV"] = {"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 16}
    for c in cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]:
        c["feature_map_stride"] = 2
    cfg["BACKBONE_2D"] = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [2],
                          "NUM_FILTERS": [16], "UPSAMPLE_STRIDES": [1],
                          "NUM_UPSAMPLE_FILTERS": [16]}
    return dict(cfg)


def caddn_pair(deeplab=False, seed=1):
    """(JAX CaDDN, variables, port CaDDN); the box and class convs at a
    tenth of their He scale (tests/test_torch_port_two_stage.py's
    `build_pair` scales the box conv; at He scale the class logits reach
    1e1)."""
    cfg = caddn_cfg(deeplab)
    jmodel = j_build_network(JCfgDict(cfg), NAMES3, JVoxelGrid.create(PCR, VOXEL))
    model, variables = model_pair(cfg, seed=seed, max_voxels=None,
                                  gains={"dense_head/conv_box/kernel": 0.1,
                                         "dense_head/conv_cls/kernel": 0.1})
    return jmodel, variables, model


# --------------------------------------------------------------------------
# the DDN pieces
# --------------------------------------------------------------------------

def test_frustum_to_voxel_and_depth_loss_match_jax():
    """Two cameras (ahead and back) over every voxel centre of the grid:
    the `ok` mask exactly, the sampled features within 1e-5 (voxels behind
    a camera read 0); the LID bins within 1e-6; the focal depth loss and
    its gradient within 1e-5."""
    from dfu3d_tpu_torch.models.caddn import voxel_centers

    rng = np.random.RandomState(0)
    arrays = mm_arrays(1, n_cam=2, image_size=(64, 64))
    frustum = rng.randn(2, 12, 16, 16, 5).astype(np.float32)
    centers = voxel_centers(VoxelGrid_port())
    l2c, c2i = arrays[8][0], arrays[9][0]
    args = (12, 2.0, 14.0, (64, 64))
    want, want_ok = jax.jit(jax.vmap(lambda f, a, b: jddn.frustum_to_voxel(
        f, jnp.asarray(centers), a, b, *args)))(frustum, l2c, c2i)
    got, ok = pddn.frustum_to_voxel(t(frustum), t(centers), t(l2c), t(c2i), *args)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert 0 < ok.float().mean() < 1
    close(got.numpy(), np.asarray(want), 1e-5)

    depth = rng.uniform(0, 16, (2, 16, 16)).astype(np.float32)
    depth[depth < 3] = 0
    close(pddn.bin_depths_lid(t(depth), 12, 2.0, 14.0).numpy(),
          np.asarray(jddn.bin_depths_lid(jnp.asarray(depth), 12, 2.0, 14.0)), 1e-6)
    logits = rng.randn(2, 16, 16, 13).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(lambda x: jddn.ddn_depth_loss(x, depth, 12, 2.0, 14.0))(
        logits)
    x = t(logits).requires_grad_()
    loss = pddn.ddn_depth_loss(x, t(depth), 12, 2.0, 14.0)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    close(x.grad.numpy(), np.asarray(jgrad), 1e-5)


def VoxelGrid_port():
    from dfu3d_tpu_torch.core.voxel import VoxelGrid

    return VoxelGrid.create(PCR, VOXEL)


def test_deeplab_matches_jax():
    """DDNDeepLabV3 at ResNet layers (1, 1, 1, 1) on 64 x 64 images with a
    zero-padded border (kept at 0 by the preprocess): layer1's features and
    the logits resized from 8 x 8 to 16 x 16, in eval mode (its train mode
    runs in test_caddn_matches_jax's loss)."""
    train = False
    images = np.random.RandomState(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    images[:, :, -6:] = 0.0
    port = DDNDeepLabV3(13, (1, 1, 1, 1)).train(train)
    jmod = JDeepLab(num_classes=13, layers=(1, 1, 1, 1))
    variables = variables_like(port, seed=3)
    (feats, logits), _ = jax.jit(lambda v, x: jmod.apply(v, x, train, mutable=["batch_stats"]))(
        variables, jnp.asarray(images))
    params_from_jax(variables, port)
    with torch.no_grad():
        got_feats, got_logits = port(t(images))
    close(got_feats.numpy(), np.asarray(feats))
    close(got_logits.numpy(), np.asarray(logits))


# --------------------------------------------------------------------------
# CaDDN
# --------------------------------------------------------------------------

def caddn_program(jmodel):
    """JAX's predict and train-mode loss of a batch."""
    def run(v, b):
        pred = jmodel.apply(v, b, method=lambda m, bb: m.predict(bb))
        (loss, tb), _ = jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        return pred, loss, tb

    return run


@pytest.fixture(scope="module")
def caddn_pairs():
    """{False (the compact DDN), True (DeepLab)}: (JAX program compiled,
    variables, port model, batch arrays, JAX model); both compile at once."""
    out = {}
    for deeplab in (False, True):
        jmodel, variables, model = caddn_pair(deeplab)
        arrays = mm_arrays(3, image_size=(64, 64))
        out[deeplab] = [Compiling(caddn_program(jmodel), variables, jax_batch(arrays)),
                        variables, model, arrays, jmodel]
    for entry in out.values():
        entry[0] = entry[0].result()
    return out


@pytest.mark.parametrize("deeplab", [False, True])
def test_caddn_matches_jax(caddn_pairs, deeplab):
    """The flax tree of JAX's init is the port's state_dict; predict (valid
    masks and labels equal, scores within 1e-4, boxes within 1e-4 absolute
    or relative) and the
    train-mode loss (every term within 1e-4 relative, the depth loss > 0)."""
    program, variables, model, arrays, jmodel = caddn_pairs[deeplab]
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jax_batch(arrays), train=False))
    assert (jax.tree_util.tree_map(lambda s: s.shape, shapes)
            == jax.tree_util.tree_map(lambda a: a.shape, variables))
    (wb, ws, wl, wv), jloss, jtb = jax.device_get(program(variables, jax_batch(arrays)))
    batch = port_batch(arrays)
    model.eval()
    with torch.no_grad():
        gb, gs, gl, gv = (a.numpy() for a in model.predict(batch))
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 4
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)
    # boxes within 1e-4 absolute or relative: the dims are exponentials of
    # the regression (up to 36 m here, where fp32 rounds at 4e-6)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=TOL, atol=TOL)
    model.train()
    loss, tb = model(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert set(tb) == set(jtb) and float(jtb["depth_loss"]) > 0
    for k in jtb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=TOL, err_msg=k)


def test_caddn_train_step_matches_jax():
    """One make_train_step of the compact CaDDN against JAX's (the KITTI
    configs' adam_onecycle): the metrics within 1e-5 relative but
    grad_norm, which sums leaves that agree within GRAD_TOL, within 1e-4
    (and within 1e-5 of the fp64 norm of the port's gradients); every
    gradient leaf within GRAD_TOL of its largest entry; the parameters
    after the step and the BN statistics within 1e-5."""
    jmodel, variables, model = caddn_pair(seed=5)
    model.train()
    arrays = mm_arrays(6, image_size=(64, 64))
    tx, _ = j_build_optimizer(JCfgDict(KITTI_OPTIM), 100)
    tx = recording(tx)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=None)
    state = state._replace(opt_state=tx.init(state.params))
    new_state, jmetrics = jax.device_get(jax.jit(j_make_train_step(jmodel, tx))(
        state, jax_batch(arrays)))
    tstate = create_train_state(model, CfgDict(KITTI_OPTIM), 100)
    raw, opt_step = {}, tstate.optimizer.step

    def snapshot():
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return opt_step()

    tstate.optimizer.step = snapshot
    metrics = make_train_step(model, tstate.optimizer, device="cpu",
                              dtype=torch.float32)(port_batch(arrays))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1e-7, err_msg=k,
                                   rtol=GRAD_TOL if k == "grad_norm" else 1e-5)
    norm64 = np.sqrt(sum(float((g.double() ** 2).sum()) for g in raw.values()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm64, rtol=1e-5)
    jgrads = params_from_jax({"params": new_state.opt_state["grads"]})
    assert set(raw) == set(jgrads)
    for k, w in jgrads.items():
        w = w.numpy()
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(raw[k].numpy(), w, rtol=0, atol=GRAD_TOL * scale, err_msg=k)
    want = params_from_jax({"params": new_state.params})
    lr0 = tstate.optimizer.lr_fn(0)
    for k, p in model.named_parameters():
        got, w = p.detach().numpy(), want[k].numpy()
        sure = np.abs(raw[k].numpy() - jgrads[k].numpy()) <= 0.02 * np.abs(jgrads[k].numpy())
        tol = 1e-5 * (1 + np.abs(w).max())
        np.testing.assert_allclose(got[sure], w[sure], rtol=0, atol=tol, err_msg=k)
        assert (np.abs(got - w)[~sure] <= 2 * lr0 + tol).all(), k
    buffers = dict(model.named_buffers())
    for k, w in params_from_jax({"batch_stats": new_state.batch_stats}).items():
        close(buffers[k].numpy(), w.numpy(), 1e-5, err_msg=k)


def test_train_model_takes_multimodal_batches(tmp_path):
    """trainer.train_model over a list of MultimodalBatches: two steps,
    finite losses, a checkpoint."""
    from dfu3d_tpu_torch.train.trainer import train_model

    _, _, model = caddn_pair()
    model.train()
    state = create_train_state(model, CfgDict(KITTI_OPTIM), 10)
    losses = []
    train_model(state, [port_batch(mm_arrays(s, image_size=(64, 64))) for s in (8, 9)], 1,
                tmp_path, device="cpu", dtype=torch.float32,
                on_step=lambda it, m: losses.append(float(m["loss"])))
    assert len(losses) == 2 and np.isfinite(losses).all() and state.step == 2
    assert list(tmp_path.glob("checkpoint_epoch_1.pth"))


@pytest.mark.parametrize("name", ["bevfusion", "caddn", "voxel_rcnn_focal"])
def test_camera_spans(name, monkeypatch):
    """The camera detectors' span profile (`profile_serve.camera_profile`) of
    an eval step on the test models (and of a train step on CaDDN's), syncs
    stubbed: their spans present, B1 and B2 inside the spans that launch
    them, exclusive times summing to the step; the focal layers' dilated
    voxels against their caps."""
    from dfu3d_tpu_torch import profile_serve
    from dfu3d_tpu_torch.core.voxel import VoxelGrid
    from dfu3d_tpu_torch.models import build_network
    from dfu3d_tpu_torch.train.train_state import make_eval_step

    from test_torch_port_camera import IMG, bevfusion_cfg
    from test_torch_port_focal import PCR as FOCAL_PCR
    from test_torch_port_focal import focal_cfg

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    if name == "bevfusion":
        model, _ = model_pair(bevfusion_cfg(), seed=2)
        arrays = mm_arrays(3, n_cam=2, image_size=IMG)
        keys = ("swin_stages", "fpn", "view_transform.depth_net", "view_transform.geometry",
                "view_transform.bev_pool", "trunk", "trunk.b2", "fuser", "backbone_2d", "head",
                "decode", "recall_iou", "recall_iou.b1")
    elif name == "caddn":
        model = caddn_pair(deeplab=True)[2]
        arrays = mm_arrays(3, image_size=(64, 64))
        keys = ("resnet", "aspp", "frustum_features", "frustum_to_voxel", "collapse",
                "backbone_2d", "head", "decode", "b1", "keep_scan", "recall_iou")
    else:
        model = build_network(CfgDict(focal_cfg()), NAMES3, VoxelGrid.create(FOCAL_PCR, VOXEL),
                              device="cpu")
        arrays = mm_arrays(3, image_size=(48, 64), pcr=FOCAL_PCR)
        keys = ("vfe", "image_convs", "trunk", "trunk.focal_layers", "trunk.focal_layers.b2",
                "trunk.b2", "backbone_2d", "dense_head", "proposals", "proposals.b1", "roi_pool",
                "roi_head", "final_nms", "final_nms.b1", "recall_iou")
    batches = [port_batch(arrays)]
    step = make_eval_step(model, (0.3, 0.5, 0.7), device="cpu")
    res = profile_serve.camera_profile(model, lambda b: profile_serve._run(step, b), batches)
    phase = res["phase_ms"]
    for key in keys:
        assert phase.get(key, 0) > 0, key
    assert abs(sum(v for k, v in phase.items() if k != "step") - phase["step"]) < 1e-6
    if name == "voxel_rcnn_focal":
        dil = res["focal_dilation"]
        assert [dil[f"focal{s}"]["dilate_cap"] for s in (1, 2, 3)] == [4000, 2000, 1000]
        assert all(0 < k <= dil["focal1"]["dilate_cap"] for k in dil["focal1"]["kept_per_frame"])
    if name != "caddn":
        return
    model.train()
    tstate = create_train_state(model, CfgDict(KITTI_OPTIM), 10)
    tstep = make_train_step(model, tstate.optimizer, device="cpu", dtype=torch.float32)
    res = profile_serve.camera_profile(model, lambda b: float(tstep(b)["loss"]), batches,
                                       tstate.optimizer)
    for key in ("anchor_targets", "rpn_loss", "depth_loss", "backward", "clip_optimizer"):
        assert res["phase_ms"].get(key, 0) > 0, key
