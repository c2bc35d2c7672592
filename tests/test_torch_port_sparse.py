"""Port parity: dynamic voxelization, the sparse coordinate ops, the
gather-GEMM's plain twin (kernel B2's reference), the sparse convs and
VoxelResBackBone8x against the JAX package, fp32 on both sides.

The port builds element neighbour tables (B, Q, K) by sort and searchsorted;
the JAX package's production path builds columnar maps and grouped
(packed-row) tables. On column-major slot sets, which every voxelizer and
downsample output is, the two are held equal here: tables exactly, conv
outputs within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core import voxel as jvoxel
from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.core.voxel.pallas_sparse import fused_gather_gemm
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu_torch.convert import params_from_jax
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.core.voxel import sparse_ops
from dfu3d_tpu_torch.core.voxel.gather_gemm_kernel import gather_gemm, gather_gemm_plain
from dfu3d_tpu_torch.models import sparse_backbone as sb

from test_torch_port_models import numpy_variables
from test_torch_port_threads import few_threads  # noqa: F401 (autouse)

PCR = [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]   # 128 x 128 x 40 at 0.1 x 0.1 x 0.2 m
VS = [0.1, 0.1, 0.2]
GROUND_Z = -1.7


def ground_points(rng, b, patches=3, per_patch=1200, boxes=2, per_box=600, scatter=100):
    """(B, N, 4) points clustered near a ground plane: a few 3 × 3 m ground
    patches (z noise 3 cm) and the faces of a few car-sized boxes standing on
    it, plus uniform points of which some fall outside the range; about 5 %
    of the points are padding (invalid)."""
    n = patches * per_patch + boxes * per_box + scatter
    pts = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        parts = []
        for _ in range(patches):
            c = rng.uniform(-4.5, 4.5, 2)
            xy = c + rng.uniform(-1.5, 1.5, (per_patch, 2))
            parts.append(np.c_[xy, GROUND_Z + rng.normal(0, 0.03, per_patch)])
        half = np.array([2.0, 0.9, 0.75])
        for _ in range(boxes):
            c = rng.uniform(-4.0, 4.0, 2)
            u = rng.uniform(-1, 1, (per_box, 3)) * half
            face, rows = rng.randint(0, 3, per_box), np.arange(per_box)
            u[rows, face] = np.sign(u[rows, face]) * half[face]
            parts.append(u + [c[0], c[1], GROUND_Z + half[2]])
        parts.append(rng.uniform([-7.0, -7.0, -5.5], [7.0, 7.0, 3.5], (scatter, 3)))
        xyz = np.concatenate(parts)
        pts[i, :, :3] = xyz[rng.permutation(n)]
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    return pts, valid


def _j_voxelize(pts, valid, max_voxels):
    grid = jvoxel.VoxelGrid.create(PCR, VS)
    return jax.vmap(lambda p, v: jvoxel.dynamic_voxelize(grid, p, v, max_voxels))(
        jnp.asarray(pts), jnp.asarray(valid))


@pytest.fixture(scope="module")
def voxels():
    """Port voxelization of two clustered samples (cap not binding), as numpy."""
    pts, valid = ground_points(np.random.RandomState(0), 2)
    vox = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), 8192)
    assert int(vox.num_unique.max()) < 8192
    return pts, valid, vox


@pytest.mark.parametrize("max_voxels", [8192, 1500])
def test_dynamic_voxelize_matches_jax(max_voxels):
    """Coords, valid, point_to_voxel and the counts; at 1500 the cap binds and
    keeps the first cells in column-major order."""
    pts, valid = ground_points(np.random.RandomState(1), 2)
    want = _j_voxelize(pts, valid, max_voxels)
    got = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), max_voxels)
    for name in ("voxel_coords", "voxel_valid", "point_to_voxel", "num_voxels", "num_unique"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    unique = got.num_unique.numpy()
    assert (unique > 2500).all()
    if max_voxels == 1500:
        assert (got.num_voxels.numpy() == 1500).all()
    else:
        assert (got.num_voxels.numpy() == unique).all()


@pytest.mark.parametrize("z_only", [False, True])
def test_downsample_coords_matches_jax(voxels, z_only):
    _, _, vox = voxels
    grid = sparse_ops.SparseGrid(128, 128, 40)
    down = grid.down_z() if z_only else grid.down()
    cap = 3000
    jgrid = jsp.SparseGrid(*down)
    want = jax.vmap(lambda c, v: jsp.downsample_coords(jgrid, c, v, cap, z_only=z_only))(
        jnp.asarray(vox.voxel_coords.numpy()), jnp.asarray(vox.voxel_valid.numpy()))
    got = sparse_ops.downsample_coords(down, vox.voxel_coords, vox.voxel_valid, cap,
                                       z_only=z_only)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(np.minimum(got[3].numpy(), cap), got[1].numpy().sum(1))
    assert 0 < int(got[1].sum()) < int(vox.voxel_valid.sum())


def _column_tables(grid, coords, valid, q_coords, q_valid, v, offsets):
    jgrid = jsp.SparseGrid(*grid)
    colmap = jsp.build_column_map_batched(jgrid, jnp.asarray(coords), jnp.asarray(valid))
    bases = jsp.column_map_bases(jgrid, coords.shape[0])
    return np.asarray(jax.vmap(
        lambda qc, qv, base: jsp.find_neighbors_via_column_map(
            jgrid, qc, qv, colmap, v, offsets, base)
    )(jnp.asarray(q_coords), jnp.asarray(q_valid), bases))


@pytest.mark.parametrize("case", ["subm", "strided", "z_only"])
def test_neighbor_tables_match_jax_column_map(voxels, case):
    """Element tables (sort + searchsorted) equal JAX's columnar lookups:
    the 3×3×3 submanifold table, the strided conv's (even centres) and
    conv_out's (1, 1, 3)."""
    _, _, vox = voxels
    grid = sparse_ops.SparseGrid(128, 128, 40)
    coords, valid = vox.voxel_coords, vox.voxel_valid
    v = coords.shape[1]
    if case == "subm":
        q_coords, q_valid, offsets = coords, valid, sparse_ops.kernel_offsets(3, 3, 3)
    else:
        z_only = case == "z_only"
        down = grid.down_z() if z_only else grid.down()
        out_c, q_valid, _, _ = sparse_ops.downsample_coords(down, coords, valid, 3000,
                                                            z_only=z_only)
        q_coords = out_c * torch.tensor([1, 1, 2] if z_only else [2, 2, 2], dtype=torch.int32)
        offsets = sparse_ops.kernel_offsets(*((1, 1, 3) if z_only else (3, 3, 3)))
    lookup = sparse_ops.build_lookup(grid, coords, valid)
    got = sparse_ops.find_neighbors(grid, q_coords, q_valid, *lookup, offsets)
    want = _column_tables(grid, coords.numpy(), valid.numpy(), q_coords.numpy(),
                          q_valid.numpy(), v, offsets)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    live = (got < v).sum(-1).float()[q_valid]
    if case == "subm":   # the clustered scene gives most voxels neighbours
        assert live.mean() >= 4.0


@pytest.mark.parametrize("b,v,q,k,cin,cout,tq,seed", [
    (2, 100, 96, 27, 8, 16, 32, 0),   # several query blocks
    (1, 64, 50, 27, 8, 8, 32, 1),     # a remainder query block
    (2, 40, 33, 3, 4, 16, 16, 2),     # conv_out's K=3 and conv_input's Cin=4
    (1, 40, 30, 125, 8, 16, 16, 5),   # a 5x5x5 down conv's 125 taps
    (1, 24, 20, 9, 256, 256, 16, 6),  # the 256-wide stages and heads
])
def test_gather_gemm_plain_matches_jax_and_pallas(b, v, q, k, cin, cout, tq, seed):
    """The plain twin against JAX's loop form and the Pallas kernel in
    interpret mode, with invalid rows and sentinel entries."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, v, cin)).astype(np.float32)
    valid = rng.random((b, v)) > 0.2
    nbr = rng.integers(0, v + 1, (b, q, k)).astype(np.int32)
    w = (rng.standard_normal((k, cin, cout)) * 0.1).astype(np.float32)
    args = (jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(nbr), jnp.asarray(w))
    got = gather_gemm(*(torch.from_numpy(a) for a in (feats, valid, nbr, w))).numpy()
    np.testing.assert_allclose(got, np.asarray(jsb._gather_gemm(*args)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(fused_gather_gemm(*args, tq=tq, interpret=True)),
                               atol=1e-5)


@pytest.mark.parametrize("b,v,q,k,cin,cout,tq,seed", [
    (2, 90, 70, 27, 16, 32, 32, 3),
    (1, 50, 40, 3, 4, 16, 16, 4),
])
def test_gather_gemm_ignores_garbage_in_masked_rows(b, v, q, k, cin, cout, tq, seed):
    """Rows that `valid` masks hold NaN, ±inf and ±1e30: they contribute
    exactly nothing (never scaled by the mask, which would give NaN), so the
    port, JAX's loop form and the Pallas kernel in interpret mode agree at
    1e-5 and the output is finite. B2 on the card keeps this semantics."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, v, cin)).astype(np.float32)
    valid = rng.random((b, v)) > 0.3
    bad = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)
    feats[~valid] = bad[np.arange(int((~valid).sum())) % len(bad)][:, None]
    nbr = rng.integers(0, v + 1, (b, q, k)).astype(np.int32)
    w = (rng.standard_normal((k, cin, cout)) * 0.1).astype(np.float32)
    args = (jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(nbr), jnp.asarray(w))
    got = gather_gemm(*(torch.from_numpy(a) for a in (feats, valid, nbr, w))).numpy()
    assert np.isfinite(got).all()
    assert (nbr < v).any() and not valid.all()
    np.testing.assert_allclose(got, np.asarray(jsb._gather_gemm(*args)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(fused_gather_gemm(*args, tq=tq, interpret=True)),
                               atol=1e-5)


def test_gather_gemm_all_sentinel_rows_are_zero():
    feats = torch.ones(1, 16, 8)
    nbr = torch.full((1, 16, 27), 16, dtype=torch.int32)
    out = gather_gemm_plain(feats, torch.ones(1, 16, dtype=torch.bool), nbr, torch.ones(27, 8, 8))
    assert out.abs().max().item() == 0.0
    # rows that `valid` masks contribute nothing either
    nbr = torch.zeros((1, 16, 27), dtype=torch.int32)
    valid = torch.zeros(1, 16, dtype=torch.bool)
    assert gather_gemm_plain(feats, valid, nbr, torch.ones(27, 8, 8)).abs().max().item() == 0.0


@pytest.mark.parametrize("case", ["subm", "strided", "z_only"])
def test_sparse_convs_match_jax_grouped_forms(voxels, case):
    """The port's SubMConv3d / SparseConv3dDown (element tables + B2's plain
    twin) against the JAX production forms: the grouped packed-row
    gather-GEMM for 3×3×3, the element form over the columnar table for the
    z-only conv_out."""
    _, _, vox = voxels
    rng = np.random.RandomState(5)
    grid = sparse_ops.SparseGrid(128, 128, 40)
    jgrid = jsp.SparseGrid(*grid)
    coords, valid = vox.voxel_coords, vox.voxel_valid
    b, v = valid.shape
    cin, cout = 6, 5
    feats = rng.normal(0, 1, (b, v, cin)).astype(np.float32)
    jc, jv, jf = jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()), jnp.asarray(feats)
    colmap = jsp.build_column_map_batched(jgrid, jc, jv)
    bases = jsp.column_map_bases(jgrid, b)
    st = sb.SparseTensor(torch.from_numpy(feats), coords, valid, grid)
    lookup = sparse_ops.build_lookup(grid, coords, valid)
    off27 = sparse_ops.kernel_offsets(3, 3, 3)

    def grouped(q_coords, q_valid):
        return jax.vmap(lambda qc, qv, base: jsp.grouped_column_neighbors(
            jgrid, qc, qv, colmap, v, off27, base))(q_coords, q_valid, bases)

    if case == "subm":
        w = rng.normal(0, 0.2, (27, cin, cout)).astype(np.float32)
        idx, p = grouped(jc, jv)
        want = jnp.where(jv[..., None], jsb.subm_gather_gemm_grouped(jf, jv, idx, p,
                                                                    jnp.asarray(w)), 0.0)
        conv = sb.SubMConv3d(cin, cout)
        conv.kernel.data = torch.from_numpy(w)
        with torch.no_grad():
            got = conv(st, sparse_ops.find_neighbors(grid, coords, valid, *lookup, off27))
    else:
        z_only = case == "z_only"
        conv = sb.SparseConv3dDown(cin, cout, 3000, z_only=z_only)
        w = rng.normal(0, 0.2, tuple(conv.kernel.shape)).astype(np.float32)
        conv.kernel.data = torch.from_numpy(w)
        with torch.no_grad():
            level = conv.plan(grid, coords, valid, lookup)
            got = conv(st, level)
        down = jsp.SparseGrid(*level.grid)
        out_c, out_v, _ = jax.vmap(lambda c, vv: jsp.downsample_coords(
            down, c, vv, 3000, z_only=z_only))(jc, jv)
        if z_only:
            centers = out_c * jnp.asarray([1, 1, 2], jnp.int32)
            nbr = jax.vmap(lambda qc, qv, base: jsp.find_neighbors_via_column_map(
                jgrid, qc, qv, colmap, v, jsp.kernel_offsets(1, 1, 3), base))(
                    centers, out_v, bases)
            out = jsb._gather_gemm(jf, jv, nbr, jnp.asarray(w))
        else:
            idx, p = grouped(out_c * 2, out_v)
            out = jsb._grouped_gather_gemm(jf, jv, idx, p, jnp.asarray(w))
        want = jnp.where(out_v[..., None], out, 0.0)
        np.testing.assert_array_equal(got.coords.numpy(), np.asarray(out_c))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(out_v))
    assert got.features.shape == want.shape
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want), atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.5


def test_voxel_res_backbone_matches_jax(voxels):
    """VoxelResBackBone8x at narrow widths on MeanVFE features: every stage's
    coords and valid equal, the output features and height_compression
    within 1e-4."""
    pts, valid, vox = voxels
    grid = sparse_ops.SparseGrid(128, 128, 40)
    cap = vox.voxel_coords.shape[1]
    jgrid = jsp.SparseGrid(*grid)
    feats = np.asarray(jax.vmap(lambda p, v, p2v: jax.ops.segment_sum(
        jnp.where(v[:, None], p, 0.0), p2v, num_segments=cap) / jnp.maximum(
        jax.ops.segment_sum(v.astype(jnp.float32), p2v, num_segments=cap), 1.0)[:, None])(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vox.point_to_voxel.numpy())))
    jc, jv = jnp.asarray(vox.voxel_coords.numpy()), jnp.asarray(vox.voxel_valid.numpy())
    chans, out_ch = (4, 8, 8, 16), 8
    jmod = jsb.VoxelResBackBone8x(grid=jgrid, voxel_cap=cap, channels=chans,
                                  out_channels=out_ch, dtype=jnp.float32)
    variables = numpy_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jc, jv, train=False),
        seed=2, gains={"conv_input/SubMConv3d_0/kernel": 0.5})
    want = jax.jit(lambda f: jmod.apply(variables, f, jc, jv, train=False))(jnp.asarray(feats))

    port = sb.VoxelResBackBone8x(grid, cap, in_channels=4, channels=chans, out_channels=out_ch)
    params_from_jax(variables, port.eval())
    with torch.no_grad():
        levels = port.plan(vox.voxel_coords, vox.voxel_valid, vox.num_unique)
        got = port(torch.from_numpy(feats), levels)
        bev = sb.height_compression(got)

    # the stage coordinate sets, chained as JAX's strided convs make them
    c, v, g = jc, jv, jgrid
    for i, lv in enumerate(levels[1:]):
        z_only = i == 3
        g = g.down_z() if z_only else g.down()
        c, v, _ = jax.vmap(lambda cc, vv: jsp.downsample_coords(
            g, cc, vv, lv.coords.shape[1], z_only=z_only))(c, v)
        assert tuple(lv.grid) == tuple(g)
        np.testing.assert_array_equal(lv.coords.numpy(), np.asarray(c))
        np.testing.assert_array_equal(lv.valid.numpy(), np.asarray(v))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=1e-4)
    jbev = np.asarray(jsb.height_compression(want))
    assert bev.shape == jbev.shape == (2, 16, 16, 3 * out_ch)
    np.testing.assert_allclose(bev.numpy(), jbev, atol=1e-4)
    assert np.abs(jbev).max() > 0.1


def test_gather_gemm_bf16_sums_taps_in_fp32():
    """In bf16 the port (and B2) sums all taps in fp32 and rounds once, so it
    is within half a bf16 ulp of the fp32 sum; JAX's loop form rounds after
    every tap and drifts further. This is why the parity tests run in fp32."""
    rng = np.random.default_rng(4)
    b, v, q, k, cin, cout = 2, 200, 150, 27, 16, 32
    feats = rng.standard_normal((b, v, cin)).astype(np.float32)
    valid = rng.random((b, v)) > 0.2
    nbr = rng.integers(0, v + 1, (b, q, k)).astype(np.int32)
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    tf, tw = torch.from_numpy(feats).bfloat16(), torch.from_numpy(w).bfloat16()
    tv, tn = torch.from_numpy(valid), torch.from_numpy(nbr)
    exact = gather_gemm_plain(tf.float(), tv, tn, tw.float())
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp(min=2.0 ** -126))) - 7)
    port = (gather_gemm(tf, tv, tn, tw).float() - exact).abs() / ulp
    jax_loop = (torch.from_numpy(np.asarray(jsb._gather_gemm(
        jnp.asarray(tf.float().numpy(), jnp.bfloat16), jnp.asarray(valid), jnp.asarray(nbr),
        jnp.asarray(tw.float().numpy(), jnp.bfloat16)).astype(jnp.float32))) - exact).abs() / ulp
    assert port.max().item() <= 0.5
    assert jax_loop.max().item() > 1.0
