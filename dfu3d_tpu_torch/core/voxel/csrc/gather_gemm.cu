// Sparse gather-GEMM on Hopper (sm_90a): bf16 on the tensor cores, fp32 on
// the CUDA cores.
//
// Replaces the TPU kernel dfu3d_tpu/core/voxel/pallas_sparse.py::_fused_kernel
// (fused_gather_gemm) and computes what dfu3d_tpu/models/sparse_backbone.py::
// _gather_gemm computes:
//   out[b, q, :] = sum_k T_b[nbr[b, q, k]] @ W[k]
// where T_b is feats[b] with the rows that `valid` masks set to zero, and the
// sentinel index V (or any index outside [0, V)) reads a zero row. The kernels
// apply the mask themselves; no padded table is made, and a masked row is
// never read, so NaN or garbage there cannot reach the sums. Sums are fp32;
// the output is rounded once to the type of feats. No atomics: a run repeats
// bit for bit.
//
// Layout: feats (B, V, Cin), valid (B, V) bool as bytes, nbr (B, Q, K) int32,
// w (K, Cin, Cout), out (B, Q, Cout), all contiguous; feats, w and out share
// one type. Cout <= 128.
//
// What bounds it: bytes at the sparse first stages (the int32 table is the
// largest input there, and ~1.1 of 27 taps per query are live on served
// tables), operations at Cin = Cout = 128 where most taps are live.
//
// bf16, on the tensor cores (dfu3d_gather_gemm_tc; Cin % 4 == 0, Cin <= 128,
// Cout in {16, 32, 48, 64, 96, 128}, K <= 32). Output-stationary: one block of
// 4 warps owns TQ = 64 query rows of one sample and all Cout columns; each
// warp owns 16 rows.
//  1. Live-tap list, built once per tile. The block reads its (TQ, K) slice
//     of the table with 16-byte loads, looks `valid` up once per (row, tap)
//     and keeps the slice in shared memory with -1 for every dead entry
//     (sentinel, out of range, masked, past the ragged end of Q): that slice
//     is the per-row live map. A warp OR-reduction per warp and one block
//     reduction give the tile's K-bit "any row live" mask; the block then
//     walks its set bits only (__ffs), with one barrier per live tap. A tile
//     with no live tap writes zeros and exits.
//  2. cp.async gathers into a ring of 2-3 shared-memory stages (as many as fit
//     in 40 KB), so that the next taps' rows and W[k] are in flight while a
//     tap's products run. 16 bytes per copy (8 when Cin % 8 != 0, e.g.
//     Cin = 4); a dead row is copied with src-size 0, which writes zeros
//     without reading. Rows and W stay bf16 in shared memory, each row padded
//     by 16 bytes so that the ldmatrix reads of 8 rows hit 8 distinct bank
//     groups; Cin is padded with zeros to a multiple of 16 (k16).
//  3. mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with ldmatrix.x4
//     for the rows and ldmatrix.x4.trans for W[k] (row-major Cin x Cout),
//     fp32 accumulators in registers: Cout / 8 n8 tiles per warp (64 floats
//     per thread at Cout = 128).
//  4. Epilogue: the fp32 sums rounded once to bf16 and stored as bf16x2.
// The tensor cores add a 16-term dot product inside each mma in another
// order, and with other internal rounding, than an fmaf chain; the bf16
// results stay within one bf16 ulp plus the spread of two fp32 sums of
// K * Cin products (see chip_smoke.py).
//
// fp32 and the other bf16 widths, on the CUDA cores (dfu3d_gather_gemm, the
// first design, kept bit for bit): fp32 on the tensor cores would be TF32
// and would change the fp32 results that the path checks hold at 1e-4. One
// block of 256 threads per (b, tile of kTileQ = 64 queries); the tile's table
// slice is staged in shared memory once. For each tap k the block marks the
// live rows and skips the tap when the tile has none; otherwise it stages the
// 64 gathered rows (zeros where not live) and W[k] in shared memory as fp32,
// and every thread adds its (8 rows x up to 4 columns) products in fp32
// registers: warp w takes rows w, w + 8, ..., lane l columns l, l + 32, ...
// Row reads are warp broadcasts and W reads are consecutive, so shared memory
// has no bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ---- bf16 on the tensor cores ---------------------------------------------

// Ring stages a block aims for: more and larger stages cost blocks per SM,
// which hide the gathers' latency better (measured on the served tables).
constexpr int kStageBudget = 40 * 1024;  // bytes
constexpr int kMaxStages = 3;
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) after every row in shared memory
// Query rows per block (TQ / 16 warps of 16 rows). 64 beat 128 at 16 of the
// 21 served convs: twice the tiles, fewer dead rows per live tap.
constexpr int TQ = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, `bytes` of the copy read and the rest zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 or 1: kMaxStages - 2) of this thread's
// groups are in flight
static_assert(kMaxStages == 3, "cp_async_wait takes pending <= 1");
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block, in bf16 elements unless said otherwise.
struct TcLayout {
  int cin_p;       // Cin rounded up to k16
  int row_stride;  // cin_p + kRowPad
  int w_stride;    // cout + kRowPad
  int stage;       // one ring stage: TQ gathered rows, then W[k]
  __host__ __device__ TcLayout(int tq, int cin, int cout)
      : cin_p((cin + 15) & ~15), row_stride(cin_p + kRowPad), w_stride(cout + kRowPad),
        stage(tq * row_stride + cin_p * w_stride) {}
};

// NP = Cout / 16.
template <int NP>
__global__ void __launch_bounds__(TQ * 2)
gather_gemm_tc_kernel(const __nv_bfloat16* __restrict__ feats,
                      const uint8_t* __restrict__ valid, const int* __restrict__ nbr,
                      const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                      int v, int q, int k, int cin, int stages) {
  constexpr int kWarpsTc = TQ / 16;
  constexpr int kThreadsTc = kWarpsTc * 32;
  constexpr int kCout = NP * 16;
  const TcLayout lay(TQ, cin, kCout);

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* s_stages = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  int* s_nbr = reinterpret_cast<int*>(s_stages + stages * lay.stage);  // TQ * k, -1 = dead
  unsigned* s_warp_taps = reinterpret_cast<unsigned*>(s_nbr + TQ * k);  // kWarpsTc

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_here = min(TQ, q - q0);
  const __nv_bfloat16* feats_b = feats + static_cast<size_t>(b) * v * cin;
  const uint8_t* valid_b = valid + static_cast<size_t>(b) * v;
  __nv_bfloat16* out_tile = out + (static_cast<size_t>(b) * q + q0) * kCout;

  // 1. the tile's table slice with its dead entries as -1, and its live taps
  unsigned taps = 0;
  {
    const int* src = nbr + (static_cast<size_t>(b) * q + q0) * k;
    const int n_in = rows_here * k;
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    // TQ * k is a multiple of 4
    for (int e0 = 4 * tid; e0 < TQ * k; e0 += 4 * kThreadsTc) {
      int idx[4];
      if (vec && e0 + 4 <= n_in) {
        const int4 r = __ldg(reinterpret_cast<const int4*>(src + e0));
        idx[0] = r.x; idx[1] = r.y; idx[2] = r.z; idx[3] = r.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) idx[j] = e0 + j < n_in ? __ldg(src + e0 + j) : -1;
      }
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = idx[j] >= 0 && idx[j] < v;
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = live[j] && valid_b[idx[j]];
      int tap = e0 % k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_nbr[e0 + j] = live[j] ? idx[j] : -1;
        if (live[j]) taps |= 1u << tap;
        tap = tap + 1 == k ? 0 : tap + 1;
      }
    }
  }
  taps = __reduce_or_sync(0xffffffffu, taps);
  if (lane == 0) s_warp_taps[warp] = taps;
  if (cin < lay.cin_p) {  // the k16 padding of every stage: rows' columns and W's rows
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const int pad = lay.cin_p - cin;
    for (int s = 0; s < stages; ++s) {
      __nv_bfloat16* s_rows = s_stages + s * lay.stage;
      __nv_bfloat16* s_w = s_rows + TQ * lay.row_stride;
      for (int e = tid; e < TQ * pad; e += kThreadsTc)
        s_rows[(e / pad) * lay.row_stride + cin + e % pad] = zero;
      for (int e = tid; e < pad * kCout; e += kThreadsTc)
        s_w[(cin + e / kCout) * lay.w_stride + e % kCout] = zero;
    }
  }
  __syncthreads();
  taps = 0;
#pragma unroll
  for (int i = 0; i < kWarpsTc; ++i) taps |= s_warp_taps[i];

  if (taps == 0) {  // no live tap: the tile is zero
    constexpr int kChunks = kCout / 8;
    for (int e = tid; e < rows_here * kChunks; e += kThreadsTc)
      reinterpret_cast<int4*>(out_tile)[e] = make_int4(0, 0, 0, 0);
    return;
  }

  // 2. one tap's gathered rows and W[k] into a ring stage, as one cp.async group
  auto load_tap = [&](int tap, int stage) {
    __nv_bfloat16* s_rows = s_stages + stage * lay.stage;
    __nv_bfloat16* s_w = s_rows + TQ * lay.row_stride;
    if (cin % 8 == 0) {
      const int per_row = cin / 8;
      for (int e = tid; e < TQ * per_row; e += kThreadsTc) {
        const int r = e / per_row, c = (e - r * per_row) * 8;
        const int idx = s_nbr[r * k + tap];
        cp_async16(smem_u32(s_rows + r * lay.row_stride + c),
                   idx >= 0 ? feats_b + static_cast<size_t>(idx) * cin + c : feats_b,
                   idx >= 0 ? 16 : 0);
      }
    } else {
      const int per_row = cin / 4;
      for (int e = tid; e < TQ * per_row; e += kThreadsTc) {
        const int r = e / per_row, c = (e - r * per_row) * 4;
        const int idx = s_nbr[r * k + tap];
        cp_async8(smem_u32(s_rows + r * lay.row_stride + c),
                  idx >= 0 ? feats_b + static_cast<size_t>(idx) * cin + c : feats_b,
                  idx >= 0 ? 8 : 0);
      }
    }
    const __nv_bfloat16* w_k = w + static_cast<size_t>(tap) * cin * kCout;
    constexpr int kWChunks = kCout / 8;
    for (int e = tid; e < cin * kWChunks; e += kThreadsTc) {
      const int r = e / kWChunks, c = (e - r * kWChunks) * 8;
      cp_async16(smem_u32(s_w + r * lay.w_stride + c), w_k + r * kCout + c, 16);
    }
  };

  unsigned to_load = taps;
  for (int s = 0; s + 1 < stages; ++s) {
    if (to_load) {
      load_tap(__ffs(to_load) - 1, s);
      to_load &= to_load - 1;
    }
    cp_async_commit();
  }

  // 3. per live tap: wait for its stage, refill the stage freed by the tap
  // before, and run the warp's 16 rows x Cout products
  float acc[2 * NP][4];
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  // ldmatrix.x4 addresses: lanes 0-15 give rows 0-15 at column 0, lanes
  // 16-31 the same rows at column 8 (rows of W[k] for .trans)
  const int frag_row = lane & 15, frag_col = (lane >> 4) * 8;
  const int n_live = __popc(taps);
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait(stages - 2);
    __syncthreads();
    if (to_load) {
      load_tap(__ffs(to_load) - 1, (i + stages - 1) % stages);
      to_load &= to_load - 1;
    }
    cp_async_commit();
    const __nv_bfloat16* s_rows = s_stages + (i % stages) * lay.stage;
    const __nv_bfloat16* s_w = s_rows + TQ * lay.row_stride;
    const unsigned a_base = smem_u32(s_rows + (warp * 16 + frag_row) * lay.row_stride + frag_col);
    const unsigned b_base = smem_u32(s_w + frag_row * lay.w_stride + frag_col);
    for (int ks = 0; ks < lay.cin_p / 16; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, a_base + ks * 16 * 2);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        unsigned bw[4];
        ldmatrix_x4_trans(bw, b_base + (ks * 16 * lay.w_stride + p * 16) * 2);
        mma_bf16(acc[2 * p], a, bw[0], bw[1]);
        mma_bf16(acc[2 * p + 1], a, bw[2], bw[3]);
      }
    }
  }

  // 4. round once to bf16; lane holds rows lane/4 and lane/4 + 8 of its
  // warp, columns 2 * (lane % 4) + {0, 1} of every n8 tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + (lane >> 2) + half * 8;
    if (r >= rows_here) continue;
    __nv_bfloat16* dst = out_tile + static_cast<size_t>(r) * kCout + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

template <int NP>
int launch_tc(const void* feats, const void* valid, const void* nbr, const void* w, void* out,
              int b, int v, int q, int k, int cin, cudaStream_t stream) {
  const TcLayout lay(TQ, cin, NP * 16);
  const int stage_bytes = 2 * lay.stage;
  const int stages = std::max(2, std::min(kMaxStages, kStageBudget / stage_bytes));
  const size_t smem = static_cast<size_t>(stages) * stage_bytes
                      + sizeof(int) * (static_cast<size_t>(TQ) * k + TQ / 16);
  auto kernel = gather_gemm_tc_kernel<NP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((q + TQ - 1) / TQ, b);
  kernel<<<grid, TQ * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(nbr), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), v, q, k, cin, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// each launch goes on `stream` and does not synchronise. Each returns a
// cudaError_t (0 = success).

// The CUDA-core kernel; dtype 0 = float32, 1 = bfloat16.
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

// The bf16 tensor-core kernel. feats must be aligned to 16 bytes (8 when
// Cin % 8 != 0) and w to 16 bytes.
extern "C" int dfu3d_gather_gemm_tc(const void* feats, const void* valid, const void* nbr,
                                    const void* w, void* out, int b, int v, int q, int k,
                                    int cin, int cout, void* stream) {
  if (k < 1 || k > 32 || cin < 4 || cin > 128 || cin % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 16: return launch_tc<1>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    case 32: return launch_tc<2>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    case 48: return launch_tc<3>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    case 64: return launch_tc<4>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    case 96: return launch_tc<6>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    case 128: return launch_tc<8>(feats, valid, nbr, w, out, b, v, q, k, cin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
