"""Port parity: the PointNet++ ops and the PointNet2MSG backbone against the
JAX package, fp32 on both sides, from the same numpy inputs (the JAX ops
take one frame and are vmapped over the batch; the port's take the batch).

FPS, ball-query and 3-NN indices must be equal exactly, boundary cases
included: a point exactly at the radius, fewer valid points than `npoint`,
a centre with no neighbour, equal 3-NN distances. Features: within
OP_TOL (ops) and MODULE_TOL (modules with dense layers, whose sums XLA and
torch order differently) of the JAX values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core import pointnet2 as JP
from dfu3d_tpu.models import pointnet2_backbone as jbb
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import pointnet2 as P
from dfu3d_tpu_torch.models import pointnet2_backbone as pbb

from test_torch_port_models import numpy_variables

OP_TOL = dict(rtol=1e-6, atol=1e-6)
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def cloud(rng, b, n, extent=2.0, invalid=0.1):
    xyz = rng.uniform(0, extent, (b, n, 3)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > invalid
    return xyz, valid


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "few_valid", "no_valid"])
def test_farthest_point_sample_matches_jax(case):
    rng = np.random.RandomState(0)
    xyz, valid = cloud(rng, 2, 300)
    npoint = 64
    if case == "few_valid":   # 10 valid points, 64 samples: the loop repeats
        valid = np.zeros((2, 300), bool)
        valid[0, rng.choice(300, 10, replace=False)] = True
        valid[1, 290:] = True
    elif case == "no_valid":
        valid[1] = False
    want = np.asarray(jax.vmap(lambda x, v: JP.farthest_point_sample(x, v, npoint))(
        jnp.asarray(xyz), jnp.asarray(valid)))
    got = P.farthest_point_sample(t(xyz), t(valid), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.take_along_axis(valid, got, 1),
                                  np.take_along_axis(valid, want, 1))
    if case == "few_valid":
        # every valid point once, then the first valid point (at distance 0)
        # again and again, marked valid as in JAX
        for i in range(2):
            first = np.flatnonzero(valid[i])[0]
            assert sorted(got[i, :10]) == sorted(np.flatnonzero(valid[i]))
            assert (got[i, 10:] == first).all() and valid[i, got[i]].all()


@pytest.mark.parametrize("radius,nsample", [(0.5, 8), (0.1, 4), (1.0, 32)])
def test_ball_query_matches_jax(radius, nsample):
    rng = np.random.RandomState(1)
    xyz, valid = cloud(rng, 2, 200)
    new_xyz = rng.uniform(0, 2, (2, 40, 3)).astype(np.float32)
    new_valid = rng.uniform(size=(2, 40)) > 0.1
    # points exactly at the radius of centre 0 (along an axis and on a
    # diagonal, where the order of the three squares decides), a centre far
    # from every point, and an invalid centre with points around it
    c = np.float32([1.0, 1.0, 1.0])
    new_xyz[:, 0], new_valid[:, 0] = c, True
    r = np.float32(radius)
    for k, off in enumerate([(r, 0, 0), (0, -r, 0), (0, 0, r), (0.6 * r, 0.8 * r, 0),
                             (0.48 * r, 0.6 * r, 0.64 * r)]):
        xyz[:, k], valid[:, k] = c + np.float32(off), True
    new_xyz[:, 1], new_valid[:, 1] = 50.0, True
    new_xyz[:, 2], new_valid[:, 2] = c, False
    d2 = ((new_xyz[0, 0] - xyz[0, :5]) ** 2).sum(-1)
    assert (d2 == np.float32(radius * radius)).any(), "no point sits exactly at the radius"

    jq = jax.vmap(lambda x, v, nx, nv: JP.ball_query(radius, nsample, x, v, nx, nv))
    want_idx, want_has = (np.asarray(a) for a in jq(*map(jnp.asarray,
                                                         (xyz, valid, new_xyz, new_valid))))
    idx, has = P.ball_query(radius, nsample, t(xyz), t(valid), t(new_xyz), t(new_valid))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(has.numpy(), want_has)
    assert not has[:, 1].any() and (idx[:, 1] == 0).all()   # no neighbour: index 0
    assert not has[:, 2].any()


def test_group_points_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.randint(0, 50, (2, 7, 3)).astype(np.int32)
    want = np.asarray(jax.vmap(JP.group_points)(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(P.group_points(t(feats), t(idx).long()).numpy(), want)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.RandomState(3)
    known, known_valid = cloud(rng, 2, 60)
    unknown, unknown_valid = cloud(rng, 2, 90)
    # ties: unknown point 0 at the origin of a plus of four known points at
    # distance 1, two of them duplicated at higher indices; unknown point 1
    # on top of a duplicated known point
    plus = np.float32([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]]) + 10.0
    known[:, 0:4], known[:, 10:12], known_valid[:, [0, 1, 2, 3, 10, 11]] = plus, plus[:2], True
    unknown[:, 0] = 10.0
    known[:, 20], known[:, 21], known_valid[:, 20:22] = known[:, 30], known[:, 30], True
    known_valid[:, 30] = True
    unknown[:, 1] = known[:, 30]
    feats = rng.normal(size=(2, 60, 6)).astype(np.float32)

    def jfn(u, uv, k, kv, f):
        dist, idx = JP.three_nn(u, uv, k, kv)
        return dist, idx, JP.three_interpolate(f, idx, dist)

    wd, wi, wf = (np.asarray(a) for a in jax.vmap(jfn)(*map(
        jnp.asarray, (unknown, unknown_valid, known, known_valid, feats))))
    dist, idx = P.three_nn(t(unknown), t(unknown_valid), t(known), t(known_valid))
    np.testing.assert_array_equal(idx.numpy(), wi)
    np.testing.assert_array_equal(idx[:, 0].numpy(), [[0, 1, 2]] * 2)  # lower index first
    np.testing.assert_array_equal(idx[:, 1].numpy(), [[20, 21, 30]] * 2)
    np.testing.assert_allclose(dist.numpy(), wd, **OP_TOL)
    np.testing.assert_allclose(P.three_interpolate(t(feats), idx, dist).numpy(), wf, **OP_TOL)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def carried(jmodule, port, init_args, seed=0):
    """numpy variables for `jmodule` (flax layout) and `port` loaded with
    them through params_from_jax."""
    variables = numpy_variables(
        lambda: jmodule.init({"params": jax.random.PRNGKey(0)}, *init_args), seed=seed)
    params_from_jax(variables, port)
    return variables


@pytest.mark.parametrize("train", [False, True])
def test_shared_mlp_matches_jax(train):
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, 16, 8, 7)).astype(np.float32)
    mask = rng.uniform(size=(2, 16, 1, 1)) > 0.3
    jm = jbb.SharedMLP(channels=(16, 32))
    port = pbb.SharedMLP(7, (16, 32)).train(train)
    variables = carried(jm, port, (x, mask, False))
    if train:
        want, upd = jm.apply(variables, x, mask, True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, x, mask, False)
    got = port(t(x), t(mask[..., 0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)
    if train:   # keep 0.9, eps 1e-5: torch's BN defaults, not the VFE's
        for i in range(2):
            for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(
                    getattr(getattr(port, f"bn_{i}"), name).numpy(),
                    np.asarray(upd["batch_stats"][f"bn_{i}"][leaf]), **MODULE_TOL)


def test_set_abstraction_and_feature_propagation_match_jax():
    rng = np.random.RandomState(5)
    xyz, valid = cloud(rng, 2, 256, extent=4.0)
    feats = rng.uniform(size=(2, 256, 1)).astype(np.float32)
    jsa = jbb.SetAbstractionMSG(npoint=64, radii=(0.5, 1.0), nsamples=(8, 16),
                                mlps=((16, 16), (16, 32)))
    sa = pbb.SetAbstractionMSG(64, (0.5, 1.0), (8, 16), ((16, 16), (16, 32)), 1).eval()
    variables = carried(jsa, sa, (xyz, feats, valid, False))
    wx, wf, wv = (np.asarray(a) for a in jax.jit(jsa.apply, static_argnums=4)(
        variables, xyz, feats, valid, False))
    with torch.no_grad():
        gx, gf, gv = sa(t(xyz), t(feats), t(valid))
    np.testing.assert_array_equal(gx.numpy(), wx)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_allclose(gf.numpy(), wf, **MODULE_TOL)

    jfp = jbb.FeaturePropagation(mlp=(32, 16))
    fp = pbb.FeaturePropagation((32, 16), 48 + 1).eval()
    args = (xyz, valid, feats, wx, wv, wf)
    variables = carried(jfp, fp, (*args, False), seed=1)
    want = np.asarray(jax.jit(jfp.apply, static_argnums=7)(variables, *args, False))
    with torch.no_grad():
        got = fp(*map(t, args))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_pointnet2_msg_matches_jax():
    """The backbone at tests/test_pointrcnn.py's widths (npoints 128 / 32)."""
    rng = np.random.RandomState(6)
    b, n = 2, 256
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., :3] = rng.uniform(0, 4.0, (b, n, 3))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, -32:] = False
    spec = dict(npoints=(128, 32), radii=((0.5, 1.0), (1.0, 2.0)),
                nsamples=((8, 16), (8, 16)),
                mlps=(((16, 16), (16, 32)), ((32, 32), (32, 64))),
                fp_mlps=((64, 64), (64, 64)))
    jm = jbb.PointNet2MSG(**spec)
    port = pbb.PointNet2MSG(**spec, num_point_features=4).eval()
    variables = carried(jm, port, (pts, valid, False))
    want = np.asarray(jax.jit(jm.apply, static_argnums=3)(variables, pts, valid, False))
    with torch.no_grad():
        got = port(t(pts), t(valid))
    assert got.shape == (b, n, 64)
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)
