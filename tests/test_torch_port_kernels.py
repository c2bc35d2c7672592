"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor tests/conftest.py's helpers, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q --noconftest

Without a card every test marked `cuda` skips; the gather-GEMM's variant
choice and alignment check run on the CPU as well. `near_miss_boxes` is
shared with tests/test_torch_port_geometry.py.
"""
import numpy as np
import pytest
import torch

from dfu3d_tpu_torch.core.geometry import boxes, iou_kernel
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel, sparse_ops
from dfu3d_tpu_torch.models import sparse_backbone


def _rand_boxes(rng, g, n, far=0.0):
    b = np.zeros((g, n, 7), np.float32)
    b[..., 0:2] = rng.uniform(-3.0, 3.0, (g, n, 2))
    b[..., 0] += far
    b[..., 2] = rng.uniform(-1, 1, (g, n))
    b[..., 3:6] = rng.uniform(0.5, 4.0, (g, n, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (g, n))
    return torch.from_numpy(b)


def near_miss_boxes(rng, n, scales=(1 + 1e-3, 1 - 1e-3), far=0.0, footprint=None,
                    heading=np.pi):
    """(a, b) fp32 numpy boxes, a (n, 7) and b (len(scales) * n, 7): the
    pair (a[i], b[k * n + i]) has BEV bounding boxes apart by
    scales[k] * CULL_MARGIN along x or y (at random, on a random side) and
    overlap along the other axis. Footprints are uniform in
    [0.5, 4] m or the fixed (dx, dy) `footprint`; headings uniform in
    ±`heading`."""
    def rand(centre, count):
        b = np.zeros((count, 7), np.float32)
        b[:, 0:2] = centre
        b[:, 3:5] = rng.uniform(0.5, 4.0, (count, 2)) if footprint is None else footprint
        b[:, 5] = 1.5
        b[:, 6] = rng.uniform(-heading, heading, count)
        return b

    def aabb(b):
        c = boxes.boxes_to_corners_bev(torch.from_numpy(b)).numpy()
        return c.min(axis=1), c.max(axis=1)  # (count, 2) each

    a = rand(rng.uniform(-3, 3, (n, 2)) + np.float32([far, 0.0]), n)
    a_lo, a_hi = aabb(a)
    rows = np.arange(n)
    out = []
    for scale in scales:
        b = rand(0.0, n)
        b_lo, b_hi = aabb(b)  # relative to b's centre
        axis = rng.choice([0, 1], n)
        side = rng.choice([-1.0, 1.0], n)
        gap = np.float32(scale * iou_kernel.CULL_MARGIN)
        b[rows, axis] = np.where(side > 0, a_hi[rows, axis] + gap - b_lo[rows, axis],
                                 a_lo[rows, axis] - gap - b_hi[rows, axis])
        # along the other axis the two bounding boxes overlap
        ext = np.minimum(a_hi - a_lo, b_hi - b_lo)[rows, 1 - axis]
        b[rows, 1 - axis] = a[rows, 1 - axis] + 0.5 * ext * rng.uniform(-1, 1, n)
        out.append(b)
    return a, np.concatenate(out)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("far", [0.0, 60.0])
def test_kernel_matches_plain_on_card(cuda_device, far):
    """The overlap kernel against its plain twin on the card, at a ragged
    size (not a multiple of the tile) and far from the origin; identical
    boxes give their area on the diagonal."""
    rng = np.random.RandomState(0)
    a, b = _rand_boxes(rng, 3, 150, far), _rand_boxes(rng, 3, 70, far)
    ca = boxes.boxes_to_corners_bev(a.to(cuda_device)).contiguous()
    cb = boxes.boxes_to_corners_bev(b.to(cuda_device)).contiguous()
    before = iou_kernel.launches
    got = iou_kernel.overlap_bev(ca, cb)
    torch.cuda.synchronize()
    assert iou_kernel.launches == before + 1
    assert got.shape == (3, 150, 70) and got.device.type == "cuda"
    want = iou_kernel.overlap_bev_plain(ca, cb)
    assert (got - want).abs().max().item() <= 1e-3

    same = iou_kernel.overlap_bev(ca, ca)
    area = (a[..., 3] * a[..., 4]).to(cuda_device)
    torch.testing.assert_close(same.diagonal(dim1=1, dim2=2), area, rtol=1e-4, atol=0)


def _overlap_case(rng, case):
    """(boxes_a, boxes_b) as (G, N, 7) / (G, M, 7) fp32 tensors."""
    if case == "all_disjoint":   # A left of x = -10, B right of x = +10
        a, b = _rand_boxes(rng, 2, 150), _rand_boxes(rng, 2, 70)
        a[..., 0] -= 30.0
        b[..., 0] += 30.0
    elif case == "none_culled":  # centres within 0.1 m: every pair overlaps
        a, b = _rand_boxes(rng, 2, 100), _rand_boxes(rng, 2, 70)
        for t in (a, b):
            t[..., 0:2] *= 0.1 / 3.0
    elif case == "near_miss":    # pair (i, i) apart by 1.001 margins, (i, 64 + i) by 0.999
        a, b = near_miss_boxes(rng, 64)
        a, b = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
    elif case == "nms_m500":     # the NMS problem's density, a is b
        a = _rand_boxes(rng, 2, 500)
        a[..., 0:2] *= 20.0 / 3.0
        b = a
    else:                        # "ragged_m70_g3": M % 4 != 0, three problems, at 60 m
        a, b = _rand_boxes(rng, 3, 150, far=60.0), _rand_boxes(rng, 3, 70, far=60.0)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_disjoint", "none_culled", "near_miss", "nms_m500",
                                  "ragged_m70_g3"])
def test_overlap_kernel_cull_cases(cuda_device, case):
    """The culling kernel against its plain twin (1e-3 m²) where the cull
    takes every pair, none, the near misses around the margin, and at the
    stores' two alignments (M = 500: 16-byte rows; M = 70: scalar stores).
    Culled pairs are exactly 0 in both, one launch per call, and a repeat
    gives the same bits."""
    rng = np.random.default_rng(3)
    a, b = _overlap_case(rng, case)
    ca = boxes.boxes_to_corners_bev(a.to(cuda_device)).contiguous()
    cb = boxes.boxes_to_corners_bev(b.to(cuda_device)).contiguous()
    before = iou_kernel.launches
    got = iou_kernel.overlap_bev(ca, cb)
    again = iou_kernel.overlap_bev(ca, cb)
    torch.cuda.synchronize()
    assert iou_kernel.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = iou_kernel.overlap_bev_plain(ca, cb)
    culled = iou_kernel.overlap_bev_cull_plain(ca, cb)
    assert (got - want).abs().max().item() <= 1e-3
    assert bool((got[culled] == 0).all()) and bool((want[culled] == 0).all())
    if case == "all_disjoint":
        assert bool(culled.all()) and bool((got == 0).all())
    elif case == "none_culled":
        assert not bool(culled.any()) and bool((want > 0).all())
    elif case == "near_miss":
        n = got.shape[1]
        idx = torch.arange(n, device=cuda_device)
        assert bool(culled[0, idx, idx].all()) and not bool(culled[0, idx, n + idx].any())
    else:
        assert 0 < culled.float().mean().item() < 1


@pytest.mark.cuda
def test_overlap_kernel_rejects_misaligned_corners(cuda_device):
    """The kernel reads a box as two 16-byte loads: a view that starts 4
    bytes into its storage raises instead of launching."""
    flat = torch.zeros(1 + 5 * 8, device=cuda_device)
    ca = flat[1:].view(1, 5, 4, 2)
    cb = torch.zeros((1, 5, 4, 2), device=cuda_device)
    before = iou_kernel.launches
    with pytest.raises(ValueError, match="16-byte"):
        iou_kernel.overlap_bev(ca, cb)
    assert iou_kernel.launches == before


def _gather_gemm_case(rng, b, v, q, k, cin, cout, dtype, device, sentinel_only=False):
    feats = torch.from_numpy(rng.standard_normal((b, v, cin)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, v)) > 0.2)
    nbr = torch.from_numpy(rng.integers(0, v + 1, (b, q, k)).astype(np.int32))
    if sentinel_only:
        nbr[:, ::3] = v   # every third query reads only the sentinel
    w = torch.from_numpy((rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin))
                         .astype(np.float32))
    return tuple(t.to(device) for t in (feats.to(dtype), valid, nbr, w.to(dtype)))


def _bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits), in fp32."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v,q,k,cin,cout", [
    (2, 500, 333, 27, 16, 32),    # ragged Q (not a multiple of the 64-row tile)
    (1, 300, 130, 27, 4, 16),     # conv_input's Cin = 4
    (2, 200, 100, 3, 128, 128),   # conv_out's K = 3 at full width
    (1, 400, 200, 125, 32, 64),   # a 5x5x5 down conv (voxelnext_ioubranch_large)
    (1, 300, 150, 27, 256, 256),  # PillarNet's and VoxelNeXt's 256-wide stages
    (2, 200, 100, 27, 128, 256),  # their widening down conv
])
def test_gather_gemm_matches_plain_on_card(cuda_device, dtype, b, v, q, k, cin, cout):
    """B2 against its plain twin on the card: fp32 within 1e-4; bf16 within
    one bf16 ulp of the plain result plus the difference two fp32 sums of
    K·Cin terms in another order may have (both round such a sum once).
    Queries that read only the sentinel come out zero."""
    rng = np.random.default_rng(cin + k)
    feats, valid, nbr, w = _gather_gemm_case(rng, b, v, q, k, cin, cout, dtype, cuda_device,
                                             sentinel_only=True)
    before = gather_gemm_kernel.launches
    got = gather_gemm_kernel.gather_gemm(feats, valid, nbr, w)
    torch.cuda.synchronize()
    assert gather_gemm_kernel.launches == before + 1
    assert got.shape == (b, q, cout) and got.dtype == dtype
    want = gather_gemm_kernel.gather_gemm_plain(feats, valid, nbr, w)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        _assert_bf16_close(got, want, feats, valid, nbr, w)
    assert got[:, ::3].abs().max().item() == 0.0


def _assert_bf16_close(got, want, feats, valid, nbr, w):
    """Within one bf16 ulp of the plain result plus the largest difference of
    two fp32 sums of K·Cin products in another order (2·K·Cin·2^-24 times
    the sum of their magnitudes), as chip_smoke.py holds the kernel."""
    k, cin = w.shape[0], w.shape[1]
    err = (got.float() - want.float()).abs()
    mag = gather_gemm_kernel.gather_gemm_plain(feats.abs(), valid, nbr, w.abs()).float()
    tol = _bf16_ulp(want) + 2 * k * cin * 2.0 ** -24 * mag
    assert bool((err <= tol).all()), f"max excess {(err - tol).max().item()}"


def _launch_tc(feats, valid, nbr, w):
    """One call that must run the tensor-core kernel."""
    before = dict(gather_gemm_kernel.launches_by_variant)
    got = gather_gemm_kernel.gather_gemm(feats, valid, nbr, w)
    torch.cuda.synchronize()
    after = gather_gemm_kernel.launches_by_variant
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["cuda_core"] == before["cuda_core"]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k", [
    (4, 16, 27), (5, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27),
    (64, 64, 27), (64, 128, 27), (128, 128, 27), (128, 128, 3),
    (128, 64, 27), (96, 32, 27), (48, 16, 27), (16, 48, 27), (32, 96, 27),
    (128, 256, 27), (256, 256, 27), (256, 128, 27), (256, 256, 9), (256, 256, 3),
    (128, 128, 1), (256, 64, 9),
])
def test_gather_gemm_tensor_core_widths(cuda_device, cin, cout, k):
    """The bf16 tensor-core kernel at every (Cin, Cout, K) of the voxel
    paths (Cin 5: the nuScenes configs' first conv, padded to 8 by the
    wrapper; PartA2's SparseUNet decoder, Cin 128, 96, 48, and its dX, Cout
    48 and 96; PillarNet's and VoxelNeXt's 256-wide stages, their dX and
    VoxelNeXt's (3, 3, 1) and (1, 1, 1) head convs), on a random table with
    ~20 % masked rows and a ragged Q (not a multiple of the 64-row tile)."""
    rng = np.random.default_rng(cin * 1000 + cout + k)
    args = _gather_gemm_case(rng, 2, 700, 333, k, cin, cout, torch.bfloat16, cuda_device)
    got = _launch_tc(*args)
    assert got.shape == (2, 333, cout) and got.dtype == torch.bfloat16
    _assert_bf16_close(got, gather_gemm_kernel.gather_gemm_plain(*args), *args)


def _sparse_case(rng, device, cin=32, cout=64, b=2, v=400, q=300, k=27):
    feats, valid, nbr, w = _gather_gemm_case(rng, b, v, q, k, cin, cout, torch.bfloat16, device)
    return feats, valid, torch.full_like(nbr, v), w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_live_tap", "sentinel_tiles", "nan_masked_rows"])
def test_gather_gemm_tensor_core_edges(cuda_device, case):
    """The tensor-core kernel on the tables it serves: every row reads
    exactly one live tap (a different one per row); whole 64-row tiles read
    only the sentinel and come out zero; masked rows that hold
    NaN, ±inf and ±1e30 contribute nothing and the output stays finite."""
    rng = np.random.default_rng(7)
    feats, valid, nbr, w = _sparse_case(rng, cuda_device)
    b, v = valid.shape
    q, k = nbr.shape[1], nbr.shape[2]
    if case == "one_live_tap":
        valid = torch.ones_like(valid)
        taps = torch.from_numpy(rng.integers(0, k, (b, q))).to(cuda_device)
        rows = torch.from_numpy(rng.integers(0, v, (b, q)).astype(np.int32)).to(cuda_device)
        nbr.scatter_(2, taps[..., None], rows[..., None])
        assert bool(((nbr < v).sum(-1) == 1).all())
    elif case == "sentinel_tiles":
        nbr = torch.from_numpy(rng.integers(0, v + 1, (b, q, k)).astype(np.int32)).to(cuda_device)
        nbr[:, :128] = v   # tiles 0-1
        nbr[1] = v         # all of sample 1
    else:
        nbr = torch.from_numpy(rng.integers(0, v + 1, (b, q, k)).astype(np.int32)).to(cuda_device)
        bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30],
                           device=cuda_device)
        fill = bad[torch.arange(int((~valid).sum()), device=cuda_device) % len(bad)]
        feats = feats.clone()
        feats[~valid] = fill[:, None].to(feats.dtype)
    got = _launch_tc(feats, valid, nbr, w)
    want = gather_gemm_kernel.gather_gemm_plain(feats, valid, nbr, w)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    _assert_bf16_close(got, want, feats, valid, nbr, w)
    if case == "sentinel_tiles":
        assert got[:, :128].abs().max().item() == 0.0
        assert got[1].abs().max().item() == 0.0
        assert got[0, 128:].abs().max().item() > 0.0


@pytest.mark.cuda
def test_gather_gemm_fp32_repeats_bit_for_bit(cuda_device):
    """fp32 stays on the CUDA-core kernel: no atomics, so two calls give the
    same bits."""
    rng = np.random.default_rng(11)
    args = _gather_gemm_case(rng, 2, 500, 333, 27, 128, 128, torch.float32, cuda_device)
    before = dict(gather_gemm_kernel.launches_by_variant)
    first = gather_gemm_kernel.gather_gemm(*args)
    second = gather_gemm_kernel.gather_gemm(*args)
    torch.cuda.synchronize()
    assert gather_gemm_kernel.launches_by_variant["cuda_core"] == before["cuda_core"] + 2
    assert gather_gemm_kernel.launches_by_variant["tensor_core"] == before["tensor_core"]
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin", [(27, 256), (125, 64)])
def test_gather_gemm_cuda_core_wide_columns_bit_for_bit(cuda_device, k, cin):
    """fp32 at Cout 256 stages Cin in chunks of 64 and adds the products of
    each sum in the order of the unchunked kernel: its first 128 columns equal
    a Cout-128 call on those columns bit for bit (which stages all of Cin)."""
    rng = np.random.default_rng(k + cin)
    feats, valid, nbr, w = _gather_gemm_case(rng, 2, 300, 200, k, cin, 256, torch.float32,
                                             cuda_device)
    before = dict(gather_gemm_kernel.launches_by_variant)
    wide = gather_gemm_kernel.gather_gemm(feats, valid, nbr, w)
    narrow = gather_gemm_kernel.gather_gemm(feats, valid, nbr, w[..., :128].contiguous())
    torch.cuda.synchronize()
    assert gather_gemm_kernel.launches_by_variant["cuda_core"] == before["cuda_core"] + 2
    assert torch.equal(wide[..., :128], narrow)


@pytest.mark.parametrize("dtype,k,cin,cout,want", [
    (torch.bfloat16, 27, 4, 16, "tensor_core"),
    (torch.bfloat16, 27, 128, 128, "tensor_core"),
    (torch.bfloat16, 3, 128, 128, "tensor_core"),
    (torch.float32, 27, 64, 64, "cuda_core"),      # TF32 would change fp32 results
    (torch.bfloat16, 27, 16, 48, "tensor_core"),   # PartA2's decoder dX
    (torch.bfloat16, 27, 32, 96, "tensor_core"),
    (torch.bfloat16, 27, 8, 8, "cuda_core"),       # Cout not in 16, 32, 48, 64, 96, 128
    (torch.bfloat16, 27, 6, 16, "cuda_core"),      # Cin % 4 != 0
    (torch.bfloat16, 33, 16, 16, "cuda_core"),     # more taps than a 32-bit mask holds
    (torch.bfloat16, 125, 32, 64, "cuda_core"),    # a 5x5x5 down conv
    (torch.bfloat16, 27, 256, 256, "tensor_core"),  # two Cin chunks, two column blocks
    (torch.bfloat16, 27, 128, 256, "tensor_core"),
    (torch.bfloat16, 9, 256, 128, "tensor_core"),
    (torch.bfloat16, 27, 132, 16, "cuda_core"),    # above 128, Cin % 16 != 0
    (torch.bfloat16, 27, 272, 16, "cuda_core"),    # above two chunks
    (torch.bfloat16, 27, 64, 192, "cuda_core"),    # Cout not a tensor-core width
    (torch.float32, 27, 256, 256, "cuda_core"),
])
def test_gather_gemm_variant(dtype, k, cin, cout, want):
    assert gather_gemm_kernel.variant(dtype, k, cin, cout) == want


@pytest.mark.parametrize("dtype,cin,want", [
    (torch.bfloat16, 5, 8), (torch.bfloat16, 4, 4), (torch.bfloat16, 1, 4),
    (torch.bfloat16, 127, 128), (torch.bfloat16, 130, 130), (torch.float32, 5, 5),
])
def test_gather_gemm_padded_cin(dtype, cin, want):
    """The wrapper pads a bf16 Cin to a multiple of 4 where that width takes
    the tensor-core kernel, and leaves every other width as it is."""
    assert gather_gemm_kernel.padded_cin(dtype, 27, cin, 16) == want


@pytest.mark.parametrize("cin,offset,ok", [(16, 8, True), (16, 1, False), (4, 4, True),
                                           (4, 2, False)])
def test_gather_gemm_alignment_check(cin, offset, ok):
    """A feats view that starts off the tensor-core kernel's copy size (16
    bytes; 8 at Cin = 4) raises instead of being copied; the offset is in
    bf16 elements from a fresh allocation."""
    flat = torch.zeros(offset + 2 * 10 * cin, dtype=torch.bfloat16)
    feats = flat[offset:].view(2, 10, cin)
    w = torch.zeros(27, cin, 16, dtype=torch.bfloat16)
    assert w.data_ptr() % 16 == 0 and flat.data_ptr() % 16 == 0
    if ok:
        gather_gemm_kernel.check_aligned(feats, w)
    else:
        with pytest.raises(ValueError, match="feats must start"):
            gather_gemm_kernel.check_aligned(feats, w)
    w_off = torch.zeros(8 + w.numel(), dtype=w.dtype)[1:1 + w.numel()].view(w.shape)
    with pytest.raises(ValueError, match="kernel must start"):
        gather_gemm_kernel.check_aligned(flat[:2 * 10 * cin].view(2, 10, cin), w_off)


# ---------------------------------------------------------------------------
# The sparse convs' backward: dX is a B2 launch
# ---------------------------------------------------------------------------

# dX launches of one voxel train step at B=4, max_voxels 60000:
# (conv, V' table rows, Q' queries, K, Cin' = the conv's Cout, Cout' = its Cin)
DX_SHAPES = [
    ("res1", 60000, 60000, 27, 16, 16),
    ("down2", 30000, 60000, 27, 32, 16),
    ("res2", 30000, 30000, 27, 32, 32),
    ("down3", 15000, 30000, 27, 64, 32),
    ("res3", 15000, 15000, 27, 64, 64),
    ("down4", 7500, 15000, 27, 128, 64),
    ("res4", 7500, 7500, 27, 128, 128),
    ("conv_out", 7500, 7500, 3, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,v,q,k,cin,cout", DX_SHAPES, ids=[s[0] for s in DX_SHAPES])
def test_gather_gemm_dx_shapes_on_card(cuda_device, name, v, q, k, cin, cout):
    """B2 at each dX shape of the voxel train step, bf16: the tensor-core
    variant, within the bf16 tolerance of the plain twin; queries whose table
    row holds only the sentinel (inputs no output reads) come out zero."""
    rng = np.random.default_rng(v + cin)
    args = _gather_gemm_case(rng, 4, v, q, k, cin, cout, torch.bfloat16, cuda_device,
                             sentinel_only=True)
    got = _launch_tc(*args)
    _assert_bf16_close(got, gather_gemm_kernel.gather_gemm_plain(*args), *args)
    assert got[:, ::3].abs().max().item() == 0.0


def _sparse_set(device, b=2, n=3000, grid=sparse_ops.SparseGrid(40, 40, 12), seed=0):
    """A random coordinate set (B, n) with about 8 % invalid slots, its
    submanifold table and a strided conv's output set and tables."""
    gen = torch.Generator().manual_seed(seed)
    lin = torch.stack([torch.randperm(grid.num_cells, generator=gen)[:n] for _ in range(b)])
    coords = torch.stack([lin % grid.nx, lin // grid.nx % grid.ny, lin // (grid.nx * grid.ny)],
                         -1).to(torch.int32)
    valid = torch.rand(b, n, generator=gen) > 0.08
    coords, valid = coords.to(device), valid.to(device)
    lookup = sparse_ops.build_lookup(grid, coords, valid)
    subm = sparse_ops.find_neighbors(grid, coords, valid, *lookup,
                                     sparse_ops.kernel_offsets(3, 3, 3))
    return grid, coords, valid, lookup, subm


def _conv_grads(case, feats, valid, tables, w, out_valid, cot):
    """(out, dX, dW) of one conv Function."""
    feats = feats.clone().requires_grad_()
    w = w.clone().requires_grad_()
    if case == "subm":
        out = sparse_backbone.subm_gather_gemm(feats, valid, tables[0], w)
    else:
        out = sparse_backbone.down_gather_gemm(feats, valid, tables[0], tables[1], w, out_valid)
    out = torch.where(out_valid[..., None], out, 0)
    (out.float() * cot).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), feats.grad, w.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["subm", "strided", "z_only", "no_active_output"])
def test_sparse_conv_functions_match_plain_on_card(cuda_device, monkeypatch, dtype, case):
    """Each autograd Function (forward B2, dX B2 over the reversed or the
    transpose table, dW gather + matmul) through the kernels against the
    same Function through the plain twin, on real tables: fp32 within 1e-5
    of each result's largest entry, bf16 within 2^-7 of it (one bf16 ulp at
    that magnitude: both sum in fp32 and round once; dW is the same code on
    the same inputs in both). dX launches exactly once per call; with no
    active output (every output slot invalid) all three are zero."""
    grid, coords, valid, lookup, subm = _sparse_set(cuda_device)
    b, v = valid.shape
    cin, cout = 16, 32
    gen = torch.Generator().manual_seed(3)
    if case == "subm":
        tables, out_valid, k = (subm,), valid, 27
    else:
        z_only = case == "z_only"
        conv = sparse_backbone.SparseConv3dDown(cin, cout, 1500, z_only=z_only)
        level = conv.plan(grid, coords, valid, lookup)
        out_valid = level.valid
        if case == "no_active_output":
            out_valid = torch.zeros_like(out_valid)
            level = level._replace(valid=out_valid)
        out_lookup = sparse_ops.build_lookup(level.grid, level.coords, out_valid)
        tnbr = conv.transpose_table(coords, valid, level, out_lookup)
        tables, k = (level.down_nbr, tnbr), level.down_nbr.shape[2]
    q = out_valid.shape[1]
    feats = torch.randn(b, v, cin, generator=gen).to(cuda_device, dtype)
    w = (torch.randn(k, cin, cout, generator=gen) / np.sqrt(k * cin)).to(cuda_device, dtype)
    cot = torch.randn(b, q, cout, generator=gen).to(cuda_device)
    before = gather_gemm_kernel.launches
    got = _conv_grads(case, feats, valid, tables, w, out_valid, cot)
    assert gather_gemm_kernel.launches == before + 2   # forward and dX
    monkeypatch.setattr(gather_gemm_kernel, "gather_gemm", gather_gemm_kernel.gather_gemm_plain)
    want = _conv_grads(case, feats, valid, tables, w, out_valid, cot)
    for g, wt, name in zip(got, want, ("out", "dX", "dW")):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        if case == "no_active_output":
            assert g.abs().max().item() == 0.0 and wt.abs().max().item() == 0.0, name
            continue
        err = (g.float() - wt.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * wt.abs().max().item(), name
        else:
            assert err.max().item() <= 2.0 ** -7 * wt.float().abs().max().item(), name
    assert bool((got[1][~valid] == 0).all())
