// Sparse gather-GEMM on Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel dfu3d_tpu/core/voxel/pallas_sparse.py::_fused_kernel
// (fused_gather_gemm) and computes what dfu3d_tpu/models/sparse_backbone.py::
// _gather_gemm computes:
//   out[b, q, :] = sum_k T_b[nbr[b, q, k]] @ W[k]
// where T_b is feats[b] with the rows that `valid` masks set to zero, and the
// sentinel index V (or any index outside [0, V)) reads a zero row. The kernel
// applies the mask itself; no padded table is made. Sums are fp32; the output
// is rounded once to the type of feats.
//
// Layout: feats (B, V, Cin), valid (B, V) bool as bytes, nbr (B, Q, K) int32,
// w (K, Cin, Cout), out (B, Q, Cout), all contiguous; feats, w and out share
// one type. Cout <= 128.
//
// Design (simple first, on CUDA cores): one block of 256 threads per
// (b, tile of kTileQ = 64 queries). The tile's (64, K) slice of the table is
// staged in shared memory once. For each tap k the block marks the live rows
// (index in range and valid) and skips the tap outright when the tile has
// none, which is common on the sparse serving tables; otherwise it stages the
// 64 gathered rows (zeros where not live) and W[k] in shared memory as fp32,
// and every thread adds its (8 rows x up to 4 columns) products in fp32
// registers: warp w takes rows w, w + 8, ..., lane l columns l, l + 32, ...
// Row reads are warp broadcasts and W reads are consecutive, so shared memory
// has no bank conflicts. No atomics: a run repeats bit for bit.
//
// Bound: bytes for small Cin*Cout (the int32 table is the largest input at
// the first stage), operations for Cin = Cout = 128. This version reads
// shared memory about once per two FMAs and does not use the tensor cores;
// mma/wgmma, cp.async gathers and the packed-row form are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 64;
constexpr int kRowsPerWarp = kTileQ / kWarps;  // 8

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NJ = ceil(Cout / 32) column chunks per lane.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const T* __restrict__ feats, const uint8_t* __restrict__ valid,
                   const int* __restrict__ nbr, const T* __restrict__ w, T* __restrict__ out,
                   int v, int q, int k, int cin, int cout) {
  extern __shared__ float smem[];
  float* s_rows = smem;                                        // kTileQ * cin
  float* s_w = s_rows + kTileQ * cin;                          // cin * cout
  int* s_nbr = reinterpret_cast<int*>(s_w + cin * cout);       // kTileQ * k
  int* s_live = s_nbr + kTileQ * k;                            // kTileQ

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_here = min(kTileQ, q - q0);

  {  // the tile's table slice, contiguous in global memory
    const int* src = nbr + (static_cast<size_t>(b) * q + q0) * k;
    for (int e = tid; e < kTileQ * k; e += kThreads)
      s_nbr[e] = (e < rows_here * k) ? src[e] : v;
  }
  __syncthreads();

  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const T* feats_b = feats + static_cast<size_t>(b) * v * cin;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * v;

  for (int kk = 0; kk < k; ++kk) {
    int live = 0;
    if (tid < kTileQ) {
      const int idx = s_nbr[tid * k + kk];
      live = idx >= 0 && idx < v && valid_b[idx];
      s_live[tid] = live ? idx : -1;
    }
    // also the barrier that publishes s_live, and that retires the previous
    // tap's reads of s_rows / s_w before they are overwritten
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < kTileQ * cin; e += kThreads) {
      const int r = e / cin;
      const int idx = s_live[r];
      s_rows[e] = idx >= 0 ? to_float(feats_b[static_cast<size_t>(idx) * cin + (e - r * cin)])
                           : 0.f;
    }
    const T* w_k = w + static_cast<size_t>(kk) * cin * cout;
    for (int e = tid; e < cin * cout; e += kThreads) s_w[e] = to_float(w_k[e]);
    __syncthreads();

    for (int ci = 0; ci < cin; ++ci) {
      float wv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        wv[j] = c < cout ? s_w[ci * cout + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float x = s_rows[(warp + kWarps * i) * cin + ci];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows_here) continue;
    T* dst = out + (static_cast<size_t>(b) * q + q0 + r) * cout;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < cout) dst[c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
int launch(const void* feats, const void* valid, const void* nbr, const void* w, void* out,
           int b, int v, int q, int k, int cin, int cout, size_t smem, cudaStream_t stream) {
  auto kernel = gather_gemm_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((q + kTileQ - 1) / kTileQ, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(nbr), static_cast<const T*>(w), static_cast<T*>(out), v, q, k,
      cin, cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feats, const void* valid, const void* nbr, const void* w, void* out,
             int b, int v, int q, int k, int cin, int cout, size_t smem, cudaStream_t stream) {
  switch ((cout + 31) / 32) {
    case 1: return launch<T, 1>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, stream);
    case 2: return launch<T, 2>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, stream);
    case 3: return launch<T, 3>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, stream);
    case 4: return launch<T, 4>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// dtype 0 = float32, 1 = bfloat16. The launch goes on `stream` and does not
// synchronise. Returns a cudaError_t (0 = success).
extern "C" int dfu3d_gather_gemm(const void* feats, const void* valid, const void* nbr,
                                 const void* w, void* out, int b, int v, int q, int k, int cin,
                                 int cout, int dtype, void* stream) {
  if (cout < 1 || cout > 128 || cin < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  // rows and W[k] as fp32, the tile's table slice and its live rows as int32
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileQ) * cin
                                       + static_cast<size_t>(cin) * cout)
                      + sizeof(int) * (static_cast<size_t>(kTileQ) * k + kTileQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(feats, valid, nbr, w, out, b, v, q, k, cin, cout, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
