"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor tests/conftest.py's helpers, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q --noconftest

Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from dfu3d_tpu_torch.core.geometry import boxes, iou_kernel
from dfu3d_tpu_torch.core.voxel import gather_gemm_kernel


def _rand_boxes(rng, g, n, far=0.0):
    b = np.zeros((g, n, 7), np.float32)
    b[..., 0:2] = rng.uniform(-3.0, 3.0, (g, n, 2))
    b[..., 0] += far
    b[..., 2] = rng.uniform(-1, 1, (g, n))
    b[..., 3:6] = rng.uniform(0.5, 4.0, (g, n, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (g, n))
    return torch.from_numpy(b)


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
        mag = gather_gemm_kernel.gather_gemm_plain(feats.abs(), valid, nbr, w.abs()).float()
        tol = _bf16_ulp(want) + 2 * k * cin * 2.0 ** -24 * mag
        assert bool((err <= tol).all()), f"max excess {(err - tol).max().item()}"
    assert got[:, ::3].abs().max().item() == 0.0
