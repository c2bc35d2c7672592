"""Port parity: BaseBEVBackbone, CenterHead forward, decode and the batched
post-processing against the JAX package, fp32 on both sides.

Weights are drawn with numpy in the flax layout and carried into the port by
`params_from_jax`, so these tests also pin the weight mapping (Dense, Conv,
grouped Conv, ConvTranspose flip, BN statistics).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfu3d_tpu.models.backbone_2d import BaseBEVBackbone as JBackbone
from dfu3d_tpu.models.center_head import CenterHead as JCenterHead
from dfu3d_tpu.utils.config import CfgDict as JCfgDict
from dfu3d_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.flagship import FLAGSHIP_CFG
from dfu3d_tpu_torch.models.backbone_2d import BaseBEVBackbone
from dfu3d_tpu_torch.models.center_head import CenterHead
from dfu3d_tpu_torch.utils.config import CfgDict, cfg_from_yaml_file


def numpy_variables(init_fn, seed=0, gains=None):
    """Fill the flax variable tree that `init_fn()` would make with numpy
    draws: He-normal kernels (times an optional per-path gain), N(0, 0.1)
    biases, U(0.8, 1.2) BN scales, N(0, 0.1) running means and U(0.5, 1.5)
    running variances."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)
    gains = gains or {}

    def fill(path, s):
        keys = [p.key for p in path]
        name = keys[-1]
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1])) * gains.get("/".join(keys[1:]), 1.0)
            return rng.normal(0, std, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_variables_like(model):
    """The flax {"params", "batch_stats"} tree (zeros) that
    `params_from_jax` maps onto `model`'s state_dict, each leaf in the flax
    layout: the inverse of its transforms. `numpy_variables(lambda:
    flax_variables_like(model))` draws the weights that it draws from the
    JAX module's init, without tracing the init."""
    modules = dict(model.named_modules())
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        shape = tuple(t.shape)
        tree, name = params, {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        if leaf in ("running_mean", "running_var"):
            tree = stats
        elif leaf == "weight" and t.dim() == 1:
            name = "scale"
        elif leaf == "weight":
            name = "kernel"
            if t.dim() == 2:
                shape = shape[::-1]
            elif isinstance(modules[".".join(mods)], torch.nn.ConvTranspose2d):
                shape = (shape[2], shape[3], shape[0], shape[1])
            else:   # (O, I, *k) → (*k, I, O)
                shape = shape[2:] + (shape[1], shape[0])
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = jnp.zeros(shape, jnp.float32)
    return {"params": params, "batch_stats": stats}


def flagship_model_cfgs():
    """(port cfg, JAX cfg) of the flagship yaml."""
    return (cfg_from_yaml_file(FLAGSHIP_CFG, CfgDict()),
            j_cfg_from_yaml_file(FLAGSHIP_CFG, JCfgDict()))


def _jax_head(jcfg, pcr, vs):
    dh = jcfg.MODEL.DENSE_HEAD
    return JCenterHead(
        class_names=tuple(jcfg.CLASS_NAMES),
        class_names_each_head=tuple(tuple(x) for x in dh.CLASS_NAMES_EACH_HEAD),
        shared_conv_channel=dh.SHARED_CONV_CHANNEL, num_hm_conv=dh.NUM_HM_CONV,
        head_order=tuple(dh.SEPARATE_HEAD_CFG.HEAD_ORDER),
        head_dict=dict(dh.SEPARATE_HEAD_CFG.HEAD_DICT), point_cloud_range=tuple(pcr),
        voxel_size=tuple(vs), feature_map_stride=dh.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE,
        use_bias_before_norm=True, dtype=jnp.float32)


def _port_head(cfg, pcr, vs):
    dh = cfg.MODEL.DENSE_HEAD
    return CenterHead(
        in_channels=384, class_names=cfg.CLASS_NAMES,
        class_names_each_head=dh.CLASS_NAMES_EACH_HEAD,
        shared_conv_channel=dh.SHARED_CONV_CHANNEL, num_hm_conv=dh.NUM_HM_CONV,
        head_dict=dict(dh.SEPARATE_HEAD_CFG.HEAD_DICT), point_cloud_range=pcr,
        voxel_size=vs, feature_map_stride=dh.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE,
        use_bias_before_norm=True).eval()


PCR = [0.0, -12.8, -5.0, 12.8, 12.8, 3.0]
VS = [0.2, 0.2, 8.0]


class TestBackbone:
    def test_flagship_backbone_matches_jax(self):
        cfg, _ = flagship_model_cfgs()
        bb = cfg.MODEL.BACKBONE_2D
        kw = dict(layer_nums=tuple(bb.LAYER_NUMS), layer_strides=tuple(bb.LAYER_STRIDES),
                  num_filters=tuple(bb.NUM_FILTERS),
                  upsample_strides=tuple(bb.UPSAMPLE_STRIDES),
                  num_upsample_filters=tuple(bb.NUM_UPSAMPLE_FILTERS))
        x = np.random.RandomState(1).normal(0, 1, (2, 32, 16, 64)).astype(np.float32)
        jmod = JBackbone(dtype=jnp.float32, **kw)
        variables = numpy_variables(
            lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
        want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))

        port = params_from_jax(variables, BaseBEVBackbone(in_channels=64, **kw).eval())
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 8, 4, 384)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestCenterHead:
    def _pair(self):
        cfg, jcfg = flagship_model_cfgs()
        x = np.random.RandomState(2).normal(0, 1, (2, 8, 16, 384)).astype(np.float32)
        jhead = _jax_head(jcfg, PCR, VS)
        variables = numpy_variables(
            lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), seed=3)
        port = params_from_jax(variables, _port_head(cfg, PCR, VS))
        return cfg, jcfg, x, jhead, variables, port

    def test_forward_matches_jax(self):
        _, _, x, jhead, variables, port = self._pair()
        want = jhead.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"center", "center_z", "dim", "rot", "hm"}
            for name in w:
                np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]),
                                           rtol=1e-4, atol=1e-4, err_msg=name)

    def _random_preds(self, seed):
        """Distinct fp32 heat-map logits and random regression maps for the
        flagship's six heads on an 8 × 16 map."""
        rng = np.random.RandomState(seed)
        preds = []
        for c in (1, 2, 2, 1, 2, 2):
            preds.append({
                "hm": rng.permutation(8 * 16 * c).reshape(8, 16, c)[None].repeat(2, 0)
                .astype(np.float32) * 0.01 - 0.5 + rng.normal(0, 1e-3, (2, 8, 16, c))
                .astype(np.float32),
                "center": rng.uniform(0, 1, (2, 8, 16, 2)).astype(np.float32),
                "center_z": rng.normal(-1, 0.5, (2, 8, 16, 1)).astype(np.float32),
                "dim": rng.normal(0.5, 0.5, (2, 8, 16, 3)).astype(np.float32),
                "rot": rng.normal(0, 1, (2, 8, 16, 2)).astype(np.float32),
            })
        return preds

    def test_decode_topk_matches_jax(self):
        cfg, jcfg, _, jhead, variables, port = self._pair()
        preds = self._random_preds(4)
        jpost = jcfg.MODEL.DENSE_HEAD.POST_PROCESSING
        want = jhead.apply(variables, [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
                           jpost, method=lambda m, p, c: m.decode_topk(p, c))
        got = port.decode_topk([{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
                               cfg.MODEL.DENSE_HEAD.POST_PROCESSING)
        for (gb, gs, gc, gv), (wb, ws, wc, wv) in zip(got, want):
            np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-4)
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))

    def test_generate_predicted_boxes_matches_jax(self):
        """Decode + NMS with all heads batched into one nms_bev call per
        candidate count (128 and 256 here) against JAX's per-head vmap."""
        cfg, jcfg, _, jhead, variables, port = self._pair()
        preds = self._random_preds(5)
        jpost = jcfg.MODEL.DENSE_HEAD.POST_PROCESSING
        want = jhead.apply(variables, [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
                           jpost, method=lambda m, p, c: m.generate_predicted_boxes(p, c))
        got = port.generate_predicted_boxes(
            [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
            cfg.MODEL.DENSE_HEAD.POST_PROCESSING)
        wb, ws, wl, wv = (np.asarray(a) for a in want)
        gb, gs, gl, gv = (a.numpy() for a in got)
        np.testing.assert_array_equal(gv, wv)
        assert wv.sum() > 50  # NMS kept a real set, not nothing
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, atol=1e-6)
        np.testing.assert_allclose(gb[gv], wb[wv], atol=1e-4)
