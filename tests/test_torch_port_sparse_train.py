"""Port parity of the sparse convs' backward: the strided conv's transpose
table against JAX's `transpose_down_neighbors` (exact, 3×3×3 and z-only),
and dX and dW of the submanifold and strided gather-GEMM Functions against
`jax.vjp` of `subm_gather_gemm` and `down_gather_gemm` (within 1e-5 of the
gradient's largest entry: dW sums thousands of products in fp32 in another
order). On the CPU, B2 is its plain twin; the launch counts of a
voxel backbone's train step are checked here by counting the wrapper's
calls (21 forward, 20 dX: conv_input's input needs no gradient)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu3d_tpu.core.voxel import sparse_ops as jsp
from dfu3d_tpu.models import sparse_backbone as jsb
from dfu3d_tpu_torch.core import voxel
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel, sparse_ops
from dfu3d_tpu_torch.models import sparse_backbone as sb

from test_torch_port_sparse import PCR, VS, ground_points

GRID = sparse_ops.SparseGrid(128, 128, 40)


@pytest.fixture(scope="module")
def voxels():
    pts, valid = ground_points(np.random.RandomState(20), 2)
    vox = voxel.dynamic_voxelize(voxel.VoxelGrid.create(PCR, VS), torch.from_numpy(pts),
                                 torch.from_numpy(valid), 4096)
    return vox.voxel_coords, vox.voxel_valid


def _strided(coords, valid, z_only, cap=2000):
    """The strided conv's output set, forward table and transpose table."""
    conv = sb.SparseConv3dDown(4, 4, cap, z_only=z_only)
    lookup = sparse_ops.build_lookup(GRID, coords, valid)
    level = conv.plan(GRID, coords, valid, lookup)
    out_lookup = sparse_ops.build_lookup(level.grid, level.coords, level.valid)
    return conv, level, conv.transpose_table(coords, valid, level, out_lookup)


@pytest.mark.parametrize("z_only", [False, True])
def test_transpose_table_matches_jax(voxels, z_only):
    coords, valid = voxels
    conv, level, tnbr = _strided(coords, valid, z_only)
    b, v = valid.shape
    q = level.valid.shape[1]
    down = jsp.SparseGrid(*level.grid)
    out_cmap = jsb._batched_cell_map(down, jnp.asarray(level.coords.numpy()),
                                     jnp.asarray(level.valid.numpy()))
    offsets = jsp.kernel_offsets(*conv.kernel_size)
    want = np.asarray(jax.vmap(
        lambda ic, iv, base: jsp.transpose_down_neighbors(
            down, ic, iv, out_cmap, q, offsets, z_only=z_only, base=base)
    )(jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()), jsp.map_bases(down, b)))
    assert tnbr.dtype == torch.int32 and tnbr.shape == want.shape == (b, v, len(offsets))
    np.testing.assert_array_equal(tnbr.numpy(), want)
    # it is the transpose of the forward table: nbr_k(q) = p ⟺ tnbr_k(p) = q
    nbr = level.down_nbr.numpy()
    fwd = {(i, int(nbr[i, qq, k]), k, qq) for i, qq, k in zip(*np.nonzero(nbr < v))}
    tnp = tnbr.numpy()
    back = {(i, p, k, int(tnp[i, p, k])) for i, p, k in zip(*np.nonzero(tnp < q))}
    assert fwd == back and len(fwd) > 1000


def _grads(fn, args, wrt, cot):
    """Port gradients of sum(fn(*args) · cot) w.r.t. args[i] for i in wrt."""
    leaves = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in wrt:
        leaves[i].requires_grad_()
    (fn(*leaves) * torch.from_numpy(cot)).sum().backward()
    return [leaves[i].grad.numpy() for i in wrt]


@pytest.mark.parametrize("case", ["subm", "strided", "z_only"])
def test_conv_grads_match_jax_vjp(voxels, case):
    coords, valid = voxels
    rng = np.random.RandomState(21)
    b, v = valid.shape
    cin, cout = 8, 16
    feats = rng.normal(0, 1, (b, v, cin)).astype(np.float32)
    jv = jnp.asarray(valid.numpy())
    if case == "subm":
        lookup = sparse_ops.build_lookup(GRID, coords, valid)
        nbr = sparse_ops.find_neighbors(GRID, coords, valid, *lookup,
                                        sparse_ops.kernel_offsets(3, 3, 3)).numpy()
        w = rng.normal(0, 0.2, (27, cin, cout)).astype(np.float32)
        cot = np.where(valid.numpy()[..., None], rng.normal(0, 1, (b, v, cout)), 0)
        cot = cot.astype(np.float32)
        _, vjp = jax.vjp(lambda f, k: jsb.subm_gather_gemm(f, jv, jnp.asarray(nbr), k),
                         jnp.asarray(feats), jnp.asarray(w))
        got = _grads(lambda f, k: sb.subm_gather_gemm(f, valid, torch.from_numpy(nbr), k),
                     (feats, w), (0, 1), cot)
    else:
        _, level, tnbr = _strided(coords, valid, case == "z_only")
        nbr, q = level.down_nbr.numpy(), level.valid.shape[1]
        w = rng.normal(0, 0.2, (nbr.shape[2], cin, cout)).astype(np.float32)
        # the layer masks its output, so no gradient reaches an inactive one
        cot = np.where(level.valid.numpy()[..., None], rng.normal(0, 1, (b, q, cout)), 0)
        cot = cot.astype(np.float32)
        _, vjp = jax.vjp(lambda f, k: jsb.down_gather_gemm(
            f, jv, jnp.asarray(nbr), jnp.asarray(tnbr.numpy()), k),
            jnp.asarray(feats), jnp.asarray(w))
        got = _grads(lambda f, k: sb.down_gather_gemm(f, valid, torch.from_numpy(nbr), tnbr, k,
                                                      level.valid),
                     (feats, w), (0, 1), cot)
    want = vjp(jnp.asarray(cot))
    for g, wt, name in zip(got, want, ("dX", "dW")):
        wt = np.asarray(wt)
        assert g.shape == wt.shape and np.abs(wt).max() > 0.1, name
        np.testing.assert_allclose(g, wt, rtol=0, atol=1e-5 * np.abs(wt).max(), err_msg=name)
    assert (got[0][~valid.numpy()] == 0).all()


def test_voxel_backbone_train_step_launches(voxels, monkeypatch):
    """One forward and backward of VoxelResBackBone8x in train mode calls B2
    21 times forward and 20 times for dX, in that order: every conv but
    conv_input, whose input (MeanVFE, no parameters) needs no gradient. Every
    parameter gets a gradient."""
    coords, valid = voxels
    calls = []
    fn = gather_gemm_kernel.gather_gemm

    def counting(*args):
        calls.append(args[0].shape)
        return fn(*args)

    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", counting)
    bb = sb.VoxelResBackBone8x(GRID, valid.shape[1], in_channels=4, channels=(4, 8, 8, 16),
                               out_channels=8).train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in bb.parameters():
            if p.dim() == 3:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[0] * p.shape[1]))
    levels = bb.plan(coords, valid, valid.sum(1), transpose=True)
    assert all(lv.down_tnbr is not None for lv in levels[1:])
    assert bb.plan(coords, valid, valid.sum(1))[1].down_tnbr is None
    feats = torch.randn(valid.shape + (4,), generator=gen)
    st = bb(feats, levels)
    assert len(calls) == 21
    (st.features.square().sum() + sb.height_compression(st).sum()).backward()
    assert len(calls) == 41
    for name, p in bb.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
