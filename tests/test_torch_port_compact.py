"""Port parity: the JAX package's legacy compact schemas, on the CPU, fp32 on
both sides, from the same numpy inputs and weights (flax layout, carried
across by `params_from_jax`), at the test-scale configs of
tests/test_torch_port_two_stage.py, tests/test_torch_port_pvrcnn_pp.py,
tests/test_parta2.py and tests/test_voxelnext.py with their RoI schema or
trunk replaced by the compact one (zoo.option_cfg's keys at test widths):

* each compact RoI head alone, in eval mode, on the same random sources
  (Voxel R-CNN's stage sets at strides 1-8 with pool_stage1..3; PV-RCNN's
  and PV-RCNN++'s keypoints with grid_sa and grid_vp; PartA2's stride-1 set
  with its part and score streams) and RoIs (one invalid): rcnn_cls and
  rcnn_reg within 1e-5, the gradients of a weighted sum of them (every
  parameter that has one, and the source features) within 1e-4 of each
  leaf's largest entry;
* VoxelNeXt's compact path from its VoxelBackBone8x's output on (that
  trunk is held by tests/test_torch_port_voxel8x.py): down16, down32, the
  BEV collapse, two BEV blocks and the heads, in train mode, BN biases +3
  on both sides (no ReLU input within rounding of its kink), against JAX's
  modules in `_features_pts`' order: the BEV set exactly equal, the heat
  map and regressions within 1e-4, the gradients of a weighted sum of them
  (every parameter and the stride-8 features) within 1e-4 of the larger of
  each leaf's largest entry and 1e-4 of the whole gradient's
  (tests/test_torch_port_voxelnext_train.py's floor), and B2 (through its
  twin) 4 times forward and 4 times for dX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu.models import voxelnext as jvn
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel, sparse_ops
from dfu3d_tpu_torch.models import pvrcnn as ppv
from dfu3d_tpu_torch.models import sparse_backbone as sb

from test_parta2 import pa2_cfg, pa2_grid
from test_pvrcnn import pv_cfg, pv_grid
from test_torch_port_options import assert_grads_close
from test_torch_port_pvrcnn_pp import pp_cfg
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)
from test_torch_port_train_slice import _shift_bn_biases
from test_torch_port_two_stage import build_pair, voxel_rcnn_cfg
from test_torch_port_voxelnext import pair as vn_pair
from test_torch_port_voxelnext_train import GRAD_FLOOR


def t(a):
    return torch.from_numpy(np.array(a))


def voxel_rcnn_compact_cfg():
    cfg = voxel_rcnn_cfg()
    rh = {k: v for k, v in cfg["ROI_HEAD"].items() if k != "ROI_GRID_POOL"}
    rh.update(GRID_SIZE=4, POOL_STAGES=[1, 2, 3], POOL_RADII=[0.4, 0.8, 1.6], GRID_MLP=[8, 8],
              GRID_NSAMPLE=8)
    cfg["ROI_HEAD"] = rh
    return cfg


def pv_rcnn_compact_cfg():
    cfg = pv_cfg()
    rh = {k: v for k, v in cfg["ROI_HEAD"].items() if k != "ROI_GRID_POOL"}
    rh.update(GRID_SIZE=4, GRID_RADIUS=0.8, GRID_NSAMPLE=8, GRID_MLP=[8, 8])
    cfg["ROI_HEAD"] = rh
    return cfg


def pv_rcnn_plusplus_compact_cfg():
    cfg = pp_cfg()
    rh = {k: v for k, v in cfg["ROI_HEAD"].items() if k != "ROI_GRID_POOL"}
    rh.update(GRID_SIZE=4, GRID_RADIUS=0.8, GRID_NSAMPLE=8, VP_BINS=[2, 2, 2], GRID_MLP=[8, 8])
    cfg["ROI_HEAD"] = rh
    return cfg


def parta2_compact_cfg():
    cfg = pa2_cfg()
    rh = {k: v for k, v in cfg["ROI_HEAD"].items() if k != "ROI_AWARE_POOL"}
    rh.update(GRID_SIZE=6, NUM_FEATURES=16)
    cfg["ROI_HEAD"] = rh
    return cfg


COMPACT = {"voxel_rcnn_compact": (voxel_rcnn_compact_cfg, pv_grid),
           "pv_rcnn_compact": (pv_rcnn_compact_cfg, pv_grid),
           "pv_rcnn_plusplus_compact": (pv_rcnn_plusplus_compact_cfg, pv_grid),
           "parta2_compact": (parta2_compact_cfg, pa2_grid)}


def random_set(rng, b, grid, v, c):
    """(coords (B, V, 3) int32 of distinct cells, valid (B, V), features
    (B, V, C))."""
    coords = np.zeros((b, v, 3), np.int32)
    for i in range(b):
        lin = rng.choice(grid[0] * grid[1] * grid[2], v, replace=False)
        coords[i] = np.stack([lin % grid[0], lin // grid[0] % grid[1],
                              lin // (grid[0] * grid[1])], -1)
    valid = rng.uniform(0, 1, (b, v)) > 0.1
    return coords, valid, rng.normal(0, 1, (b, v, c)).astype(np.float32)


def random_rois(rng, b=2, r=6):
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., 0] = rng.uniform(1.0, 5.4, (b, r))
    rois[..., 1] = rng.uniform(-5.0, 5.0, (b, r))
    rois[..., 2] = rng.uniform(-1.8, -0.6, (b, r))
    rois[..., 3:6] = rng.uniform(1.0, 4.0, (b, r, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    valid = np.ones((b, r), bool)
    valid[1, -1] = False
    return rois, valid


def compact_case(name, model, rng):
    """(JAX fn(module, sources) → (cls, reg), port fn(sources) → (cls, reg),
    the numpy sources, the RoIs)."""
    rois, roi_valid = random_rois(rng)
    jr, pr = (jnp.asarray(rois), jnp.asarray(roi_valid)), (t(rois), t(roi_valid))
    gx, gy, gz = (int(v) for v in pv_grid().grid_size)
    if name == "voxel_rcnn_compact":
        grids = [(gx >> s, gy >> s, gz >> s) for s in range(4)]
        sets = [random_set(rng, 2, g, v, c) for g, v, c in
                zip(grids, (600, 300, 120, 40), model.stage_channels)]

        def jfn(m, feats):
            stages = [jsb.SparseTensor(f, jnp.asarray(c), jnp.asarray(v), jsp.SparseGrid(*g))
                      for (c, v, _), f, g in zip(sets, feats, grids)]
            return m._roi_grid_pool(*jr, stages, False)

        def pfn(feats):
            stages = [sb.SparseTensor(f, t(c), t(v), sparse_ops.SparseGrid(*g))
                      for (c, v, _), f, g in zip(sets, feats, grids)]
            return model.refine(stages, *pr)

        return jfn, pfn, [f for _, _, f in sets]
    if name.startswith("pv_rcnn"):
        k, c = 96, model.vsa_fusion.out_channels
        xyz = np.stack([rng.uniform(0, 6.4, (2, k)), rng.uniform(-6.4, 6.4, (2, k)),
                        rng.uniform(-2.5, 0.5, (2, k))], -1).astype(np.float32)
        kv = rng.uniform(0, 1, (2, k)) > 0.1
        feats = rng.normal(0, 1, (2, k, c)).astype(np.float32)

        def jfn(m, f):
            return m._roi_grid_pool(*jr, jnp.asarray(xyz), jnp.asarray(kv), f[0], False)

        def pfn(f):
            return model.refine(ppv.Keypoints(t(xyz), t(kv), f[0], torch.zeros(2, k)), *pr)

        return jfn, pfn, [feats]
    coords, valid, feats = random_set(rng, 2, (gx, gy, gz), 1500,
                                      model.roi_head.rpn0_conv.in_channels)
    seg = rng.normal(0, 1.5, (2, 1500)).astype(np.float32)
    part = rng.uniform(0, 1, (2, 1500, 3)).astype(np.float32)
    grid = sparse_ops.SparseGrid(gx, gy, gz)

    def jfn(m, f):
        st = jsb.SparseTensor(f[0], jnp.asarray(coords), jnp.asarray(valid),
                              jsp.SparseGrid(gx, gy, gz))
        return m._roi_forward(*jr, st, jnp.asarray(seg), f[1], False)

    def pfn(f):
        return model.refine(*pr, sb.SparseTensor(f[0], t(coords), t(valid), grid), t(seg), f[1])

    return jfn, pfn, [feats, part]


@pytest.mark.parametrize("name", sorted(COMPACT))
def test_compact_roi_head_matches_jax(name):
    cfg_fn, grid_fn = COMPACT[name]
    jmodel, variables, model, _ = build_pair(cfg_fn(), grid_fn(), seed=3)
    pools = {"voxel_rcnn_compact": ["pool_stage1", "pool_stage2", "pool_stage3"],
             "pv_rcnn_compact": ["grid_sa"], "pv_rcnn_plusplus_compact": ["grid_vp"]}
    if name in pools:
        assert [n for n, _ in model.named_children() if n in pools[name] or
                n.startswith(("pool_", "grid_"))] == pools[name]
    else:
        assert model.roi_head.grid_size == 6 and model.roi_head.rpn1_conv.out_channels == 8
    model.eval()
    rng = np.random.RandomState(11)
    jfn, pfn, sources = compact_case(name, model, rng)
    cls_w = rng.normal(0, 1, (2, 6)).astype(np.float32)
    reg_w = rng.normal(0, 1, (2, 6, 7)).astype(np.float32)

    def jloss(params, feats):
        cls, reg = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                feats, method=jfn)
        return jnp.sum(cls * cls_w) + jnp.sum(reg * reg_w), (cls, reg)

    (_, (wcls, wreg)), (gp, gs) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(
        variables["params"], [jnp.asarray(s) for s in sources])
    src = [t(s).requires_grad_(True) for s in sources]
    cls, reg = pfn(src)
    ((cls * t(cls_w)).sum() + (reg * t(reg_w)).sum()).backward()
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(wcls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(wreg), rtol=0, atol=1e-5)
    jgrads = {k: v.numpy() for k, v in params_from_jax({"params": gp}).items()
              if np.abs(v.numpy()).max() > 0}
    pgrads = {k: p.grad.numpy() for k, p in model.named_parameters()
              if p.grad is not None and p.grad.abs().max() > 0}
    assert jgrads and any(k.startswith(("pool_stage", "grid_", "roi_head.")) for k in jgrads)
    assert_grads_close(pgrads, jgrads)
    # the sources a pool reads (Voxel R-CNN's compact schema reads no
    # stride-1 set)
    read = [i for i, g in enumerate(gs) if np.abs(np.asarray(g)).max() > 0]
    assert [i for i, s in enumerate(src) if s.grad is not None] == read
    assert_grads_close({i: src[i].grad.numpy() for i in read},
                       {i: np.asarray(gs[i]) for i in read})


def jax_compact_features(m, st8, train):
    """JAX VoxelNeXt._features_pts from its trunk's stride-8 output on, as
    written there for the compact path (voxelnext.py:250-291): down16 and
    down32, the three sets on the stride-8 grid, the z collapse, the
    shared BEV blocks, the per-group heads."""
    st16 = m.down16(st8, train=train)
    st32 = m.down32(st16, train=train)
    coords16 = jnp.concatenate([st16.coords[..., 0:2] * 2, st16.coords[..., 2:3]], axis=-1)
    coords32 = jnp.concatenate([st32.coords[..., 0:2] * 4, st32.coords[..., 2:3]], axis=-1)
    merged = jsb.SparseTensor(
        jnp.concatenate([st8.features, st16.features, st32.features], axis=1),
        jnp.concatenate([st8.coords, coords16, coords32], axis=1),
        jnp.concatenate([st8.valid, st16.valid, st32.valid], axis=1), st8.grid)
    bev = jvn.sparse_bev_collapse(merged, m.bev_cap)
    for blk in m.shared_blocks:
        bev = blk(bev, train)
    hm = jnp.zeros(bev.valid.shape + (len(m.class_names),), jnp.float32)
    regs = []
    for head, grp in zip(m.sep_heads, m.class_groups):
        outs = head(bev, train)
        for j, c in enumerate(grp):
            hm = hm.at[..., c].set(outs["hm"][..., j])
        regs.append(jnp.concatenate([outs[k] for k in ("center", "center_z", "dim", "rot")],
                                    axis=-1))
    return bev, hm, jnp.stack(regs, axis=2)


def test_voxelnext_compact_trunk_matches_jax(monkeypatch):
    """The compact path from the VoxelBackBone8x output on (its trunk is
    tests/test_torch_port_voxel8x.py's), on a random stride-8 set of 360
    cells with 2 z levels, its caps binding at stride 16."""
    def compact(cfg):
        cfg["BACKBONE_3D"] = {"NAME": "VoxelBackBone8x", "CHANNELS": [8, 8, 16, 16, 16],
                              "OUT_CHANNELS": 32}
        cfg["DENSE_HEAD"]["NUM_SHARED_BLOCKS"] = 2
        return cfg

    jmodel, variables, model = vn_pair("plain", seed=4, train=True, edit=compact)
    variables = _shift_bn_biases(variables, 3.0)
    params_from_jax(variables, model)
    assert not model.ref_backbone and isinstance(model.down16, sb.SparseConv3dDown)
    assert model.down16.out_cap == 128 and model.down32.out_cap == 64   # 2048 voxels / 16, / 32
    rng = np.random.RandomState(9)
    grid = (30, 24, 2)
    coords, valid, feats = random_set(rng, 2, grid, 360, 32)

    def jfeat(params, f):
        st8 = jsb.SparseTensor(f, jnp.asarray(coords), jnp.asarray(valid), jsp.SparseGrid(*grid))
        (bev, hm, reg), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, st8, True,
            method=jax_compact_features, mutable=["batch_stats"])
        return bev, hm, reg

    _, hm_s, reg_s = jax.eval_shape(jfeat, variables["params"], jnp.asarray(feats))
    hm_w = rng.normal(0, 1, hm_s.shape).astype(np.float32)
    reg_w = rng.normal(0, 1, reg_s.shape).astype(np.float32)

    def jloss(params, f):
        bev, hm, reg = jfeat(params, f)
        m = bev.valid[..., None].astype(jnp.float32)
        return jnp.sum(hm * hm_w * m) + jnp.sum(reg * reg_w * m[..., None]), (bev, hm, reg)

    (_, (jbev, jhm, jreg)), (gp, gf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(feats))
    calls, fn = [], gather_gemm_kernel.gather_gemm
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm",
                        lambda *a, **k: calls.append(a[2].shape[-1]) or fn(*a, **k))
    tf = t(feats).requires_grad_(True)
    bev, hm, reg = model.compact_features(sb.SparseTensor(tf, t(coords), t(valid),
                                                          sparse_ops.SparseGrid(*grid)))
    n_fwd = len(calls)
    m = bev.valid[..., None].float()
    ((hm * t(hm_w) * m).sum() + (reg * t(reg_w) * m[..., None]).sum()).backward()
    # down16, down32 and the two BEV blocks forward; each of them a dX
    assert n_fwd == 4 and len(calls) - n_fwd == 4, calls
    np.testing.assert_array_equal(bev.coords.numpy(), np.asarray(jbev.coords))
    np.testing.assert_array_equal(bev.valid.numpy(), np.asarray(jbev.valid))
    jv = np.asarray(jbev.valid)
    assert jv.sum() > 200 and int(np.asarray(jbev.valid).sum()) == int(bev.valid.sum())
    np.testing.assert_allclose(hm.detach().numpy()[jv], np.asarray(jhm)[jv], atol=1e-4)
    np.testing.assert_allclose(reg.detach().numpy()[jv], np.asarray(jreg)[jv], atol=1e-4)
    jgrads = {k: v.numpy() for k, v in params_from_jax({"params": gp}).items()}
    got = {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}
    jgrads = {k: v for k, v in jgrads.items() if not k.startswith("backbone_3d.")}
    assert_grads_close(got, jgrads, floor=GRAD_FLOOR)
    assert_grads_close({"st8": tf.grad.numpy()}, {"st8": np.asarray(gf)})
