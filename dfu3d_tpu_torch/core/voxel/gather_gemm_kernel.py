"""Sparse gather-GEMM: the CUDA kernels, their wrapper and their plain twin.

    out[b, q] = Σ_k T_b[nbr[b, q, k]] @ W[k]

T_b is feats[b] with the rows that `valid` masks set to zero, plus a zero
row at the sentinel index V. Sums are fp32; the output keeps the dtype of
feats (fp32 or bf16). Every sparse conv of the voxel backbone is one call.

The kernels (csrc/gather_gemm.cu) replace the TPU kernel
dfu3d_tpu/core/voxel/pallas_sparse.py::_fused_kernel (`fused_gather_gemm`)
and compute what dfu3d_tpu/models/sparse_backbone.py::_gather_gemm computes.
Two variants, chosen by dtype and widths (`variant`):

* ``tensor_core``, bf16 at Cin % 4 == 0, Cin <= 128, Cout in {16, 32, 48,
  64, 96, 128}, K <= 32 (every conv of the served paths and every dX of the
  train paths, PartA2's decoder's 48 and 96 included; `gather_gemm` first pads a
  bf16 Cin that is not a multiple of 4 with zero channels, in feats and
  in the kernel, as the nuScenes configs' 5 point features need, which
  leaves every product unchanged): one block per (sample,
  64 queries) builds the tile's live-tap list once, gathers the rows of
  the live taps with cp.async into a ring of shared-memory stages (dead rows
  zero-filled, never read) and runs mma.sync m16n8k16 bf16 products into
  fp32 registers. feats must be aligned to the copy size (16 bytes, 8 when
  Cin % 8 != 0) and the weight to 16 bytes; a misaligned view raises.
* ``cuda_core``, fp32 and the other bf16 widths: the first design, fp32
  products on the CUDA cores, one block per (sample, 64 queries), taps that
  no row of the tile reads skipped. fp32 stays here because the tensor cores
  would compute it in TF32.

What bounds the work on the card depends on the widths: the int32 table's
bytes at the sparse first stages, the operations at Cin = Cout = 128 (see the
source).

`gather_gemm` takes CPU tensors to the plain twin and CUDA tensors to a
kernel; on the card it launches or raises, with no fallback from one variant
to the other or to the twin. The library is built at first use with nvcc for
sm_90a into dfu3d_tpu_torch/csrc_build/ and loaded with ctypes (`cuda_build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_gemm.cu"
NVCC_FLAGS = ()
MAX_COUT = 128
TC_COUTS = (16, 32, 48, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, in all and per variant; read by chip_smoke.py
launches = 0
launches_by_variant = {"tensor_core": 0, "cuda_core": 0}
_fns = {}


def padded_table(feats, valid):
    """T in fp32, flat: feats (B, V, C) with the rows `valid` masks set to 0
    and one zero row appended per sample → (B·(V + 1), C); with
    `table_rows`, table index V (the sentinel) reads that zero row."""
    b, v, cin = feats.shape
    table = torch.where(valid[..., None], feats, 0).float()
    return torch.cat([table, table.new_zeros(b, 1, cin)], dim=1).reshape(b * (v + 1), cin)


def table_rows(nbr, v):
    """Per tap j, the flat rows of `padded_table` that nbr[:, :, j] reads:
    (K, B·Q) int64."""
    base = torch.arange(nbr.shape[0], device=nbr.device, dtype=torch.int64)[:, None, None] * (v + 1)
    return (nbr.long() + base).permute(2, 0, 1).reshape(nbr.shape[2], -1)


def gather_gemm_plain(feats, valid, nbr, kernel):
    """Loop form of dfu3d_tpu/models/sparse_backbone.py::_gather_gemm in
    PyTorch: mask, pad a zero row, then per tap one row gather and one
    matmul, summed in fp32; the result is cast to feats' dtype."""
    b, v, _ = feats.shape
    table = padded_table(feats, valid)
    w = kernel.float()
    out = None
    for j, rows in enumerate(table_rows(nbr, v)):
        contrib = table.index_select(0, rows) @ w[j]
        out = contrib if out is None else out + contrib
    return out.reshape(b, nbr.shape[1], -1).to(feats.dtype)


def _kernel(kind):
    if kind not in _fns:
        # the CUDA-core kernel also takes the dtype
        symbol, n_int = (("dfu3d_gather_gemm_tc", 6) if kind == "tensor_core"
                         else ("dfu3d_gather_gemm", 7))
        _fns[kind] = cuda_build.load(
            SOURCE, NVCC_FLAGS, symbol,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    return _fns[kind]


def variant(dtype, k, cin, cout):
    """The kernel that takes inputs of these widths on the card:
    "tensor_core" or "cuda_core" (`gather_gemm` asks it after padding Cin;
    `padded_cin`)."""
    if (dtype == torch.bfloat16 and k <= 32 and 4 <= cin <= 128 and cin % 4 == 0
            and cout in TC_COUTS):
        return "tensor_core"
    return "cuda_core"


def padded_cin(dtype, k, cin, cout) -> int:
    """Cin as `gather_gemm` launches it: a bf16 Cin rounded up to a multiple
    of 4 where that width takes the tensor-core kernel, else Cin."""
    up = -(-cin // 4) * 4
    if dtype == torch.bfloat16 and up != cin and variant(dtype, k, up, cout) == "tensor_core":
        return up
    return cin


def check_aligned(feats, kernel):
    """The tensor-core kernel copies feats rows in 16-byte pieces (8 when
    Cin % 8 != 0) and the weight in 16-byte pieces; raise on a view whose
    data does not start at such a boundary (nothing is copied to fix it)."""
    cin = feats.shape[-1]
    for name, t, align in (("feats", feats, 16 if cin % 8 == 0 else 8), ("kernel", kernel, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start at a multiple of {align} bytes for the "
                             f"tensor-core gather-GEMM, got address {t.data_ptr():#x}")


def _check(feats, valid, nbr, kernel):
    if feats.dim() != 3 or valid.shape != feats.shape[:2]:
        raise ValueError(f"feats (B, V, Cin) and valid (B, V), got {tuple(feats.shape)} and "
                         f"{tuple(valid.shape)}")
    if nbr.dim() != 3 or nbr.shape[0] != feats.shape[0]:
        raise ValueError(f"nbr must be (B, Q, K), got {tuple(nbr.shape)}")
    if kernel.dim() != 3 or tuple(kernel.shape[:2]) != (nbr.shape[2], feats.shape[2]):
        raise ValueError(f"kernel must be (K, Cin, Cout) = ({nbr.shape[2]}, {feats.shape[2]}, "
                         f"Cout), got {tuple(kernel.shape)}")
    if feats.dtype not in _DTYPES or kernel.dtype != feats.dtype:
        raise TypeError(f"feats and kernel must both be float32 or bfloat16, got {feats.dtype} "
                        f"and {kernel.dtype}")
    if valid.dtype != torch.bool or nbr.dtype != torch.int32:
        raise TypeError(f"valid must be bool and nbr int32, got {valid.dtype} and {nbr.dtype}")
    devices = {t.device for t in (feats, valid, nbr, kernel)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def gather_gemm(feats, valid, nbr, kernel):
    """feats (B, V, Cin), valid (B, V) bool, nbr (B, Q, K) int32 in [0, V],
    kernel (K, Cin, Cout) → (B, Q, Cout) in feats' dtype."""
    global launches
    _check(feats, valid, nbr, kernel)
    dev = feats.device
    if dev.type == "cpu":
        return gather_gemm_plain(feats, valid, nbr, kernel)
    if dev.type != "cuda":
        raise ValueError(f"gather_gemm runs on cpu or cuda, not {dev}")
    for name, t in (("feats", feats), ("valid", valid), ("nbr", nbr), ("kernel", kernel)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, v, cin = feats.shape
    q, k, cout = nbr.shape[1], nbr.shape[2], kernel.shape[2]
    if cout > MAX_COUT:
        raise ValueError(f"the gather-GEMM kernel takes Cout <= {MAX_COUT}, got {cout}")
    pad = padded_cin(feats.dtype, k, cin, cout) - cin
    if pad:
        feats = torch.nn.functional.pad(feats, (0, pad))
        kernel = torch.nn.functional.pad(kernel, (0, 0, 0, pad))
        cin += pad
    kind = variant(feats.dtype, k, cin, cout)
    if kind == "tensor_core":
        check_aligned(feats, kernel)
        dtype_arg = ()
    else:
        dtype_arg = (_DTYPES[feats.dtype],)
    out = torch.empty((b, q, cout), dtype=feats.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = _kernel(kind)
    with torch.cuda.device(dev):
        rc = fn(feats.data_ptr(), valid.data_ptr(), nbr.data_ptr(), kernel.data_ptr(),
                out.data_ptr(), b, v, q, k, cin, cout, *dtype_arg,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_gemm {kind} kernel launch failed with CUDA error {rc}")
    launches += 1
    launches_by_variant[kind] += 1
    return out
