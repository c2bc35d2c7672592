// Pairwise rotated-BEV intersection area on Hopper (sm_90a).
//
// Replaces the TPU kernel dfu3d_tpu/core/geometry/iou_pallas.py::_overlap_kernel
// (with its _contrib), and computes what the production JAX path
// dfu3d_tpu/core/geometry/iou.py::pairwise_overlap_bev computes:
//   * each pair (a, b) is centred on its own midpoint (iou.py:88-98), not on
//     the per-tile midpoint of the Pallas kernel (iou_pallas.py:90-96);
//   * A's edges are Liang-Barsky clipped inside B with the boundary inclusive
//     (+1e-6), B's edges inside A with it exclusive (-1e-6); the
//     Green's-theorem terms of the clipped segments are summed and the area
//     clamped at >= 0.
//
// Layout: corners_a (G, N, 4, 2), corners_b (G, M, 4, 2) fp32, contiguous and
// 16-byte aligned; out (G, N, M) fp32. blockIdx.z is the problem g, so all NMS
// problems of an eval step go in one launch.
//
// Design. Almost every pair of an NMS or recall problem is disjoint (97-99 %
// at the path's shapes), and the full clip costs ~1,500 issue slots a pair
// (686 fp32 operations, none fused under --fmad=false, plus 32 IEEE divides,
// 8 rsqrt and the selects) in a dependent chain of several thousand cycles.
// So a block of 256 threads owns a 64 x 64 tile of pairs and:
//   1. stages the tile's 64 + 64 boxes in shared memory (two float4 a box)
//      and classifies each box once (box_kind) with its axis-aligned bounding
//      box (AABB), A's widened by the margin kCullMargin;
//   2. culls every pair whose AABBs are apart by more than the margin in x or
//      y (4 compares), writes +0 for it into a shared-memory output tile, and
//      compacts the survivors into a shared queue of packed (row, col)
//      entries: each warp keeps its 16 ballots and reserves its slots with
//      one shared atomicAdd;
//   3. works through the queue eight lanes to a pair: each lane clips one of
//      the pair's eight edges (A's four inside B, B's four inside A) with the
//      operations of the one-thread-per-pair kernel it replaces (same
//      centring, same half-planes, same clip), and lane 0 of the eight sums
//      the terms in that kernel's order and clamps, so a survivor's value is
//      bit-identical to it, and a culled pair is the +0 that it gives. Eight
//      lanes cut the chain a survivor waits for about eightfold;
//   4. stores the tile once, with 16-byte stores where each row starts on a
//      16-byte boundary (M % 4 == 0) and scalar stores otherwise.
//
// Why a culled pair is exactly 0. A box is a "quad" when its corners are
// finite, within kCoordLimit of the origin, convex and counter-clockwise with
// every edge >= 1 cm and every corner between 30 and 150 degrees: then the
// four half-planes that the clip tests are the box itself to within the fp32
// error of a side distance (~1e-4 m at kCoordLimit, ~5e-6 m at the 61.2 m of
// POST_CENTER_LIMIT_RANGE) plus the 1e-6 tolerance, and no edge of a box
// more than kCullMargin = 1 cm away survives the clip. A "point" (four equal
// finite corners) has zero-length edges that add exactly 0, and its own
// half-planes reject every edge of the other box. Anything else (NaN or
// infinite corners, slivers, a bow-tie or clockwise order) is never culled: a
// zero-size box B, as in the gt padding, is a point whose half-planes accept
// every edge of A, so overlap(A, B) is A's area at any distance. A pair is
// culled when its AABBs are apart and A is a point or both are quads. A box
// that is neither gets NaN bounds, and every compare with NaN is false.
//
// Bound: what these inputs need is the 4 output bytes of every pair (24 MB
// at the NMS shape (24, 500, 500), 7.2 us at 3.35 TB/s) plus the full
// arithmetic only for the pairs that overlap (686 operations each and 15 for
// each clipped edge that survives, at 67 TFLOP/s); the cull's compares are
// not counted, as the compares and selects of the full computation are not.
// Beyond that the kernel spends issue slots on the survivors that do not
// overlap (about a third of them at the NMS shape), on the half-plane set-up
// that each of the eight lanes repeats, and on each block's chain of stage,
// classify, cull, clip and store. Built without fast math and with
// --fmad=false, so each operation rounds as in the plain PyTorch twin
// (iou_kernel.overlap_bev_plain).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;       // boxes of A (rows) and of B (columns) per block
constexpr int kThreads = 256;
constexpr int kPairsPerThread = kTile * kTile / kThreads;
constexpr float kEps = 1e-9f;
constexpr float kTol = 1e-6f;
constexpr float kCullMargin = 1e-2f;   // m; >> the side-distance error above
constexpr float kCoordLimit = 1024.f;  // m; farther boxes are never culled
constexpr float kMinEdge2 = 1e-4f;     // m^2; (1 cm)^2
constexpr int kPoint = 1;
constexpr int kQuad = 2;

// Green's-theorem term of P's edge (a -> b) clipped inside quad Q, or 0 where
// nothing of it survives (iou.py::_edge_contributions, one of its four
// edges). Q's half-planes are set up here, with the same operations for each
// of P's edges.
__device__ __forceinline__ float clipped_edge(float ax, float ay, float bx, float by,
                                              const float* qx, const float* qy, float shift) {
  float t_lo = 0.f, t_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int j1 = (j + 1) & 3;
    const float dx = qx[j1] - qx[j];
    const float dy = qy[j1] - qy[j];
    const float inv_len = rsqrtf(fmaxf(dx * dx + dy * dy, kEps));
    const float sp = (dx * (ay - qy[j]) - dy * (ax - qx[j])) * inv_len + shift;
    const float sq = (dx * (by - qy[j]) - dy * (bx - qx[j])) * inv_len + shift;
    float den = sp - sq;
    den = fabsf(den) < kEps ? kEps : den;
    const float t_cross = sp / den;
    const bool p_in = sp >= 0.f;
    const bool q_in = sq >= 0.f;
    const bool empty = !p_in && !q_in;
    const float lo = empty ? 1.f : ((!p_in && q_in) ? t_cross : 0.f);
    const float hi = empty ? 0.f : ((p_in && !q_in) ? t_cross : 1.f);
    t_lo = j == 0 ? lo : fmaxf(t_lo, lo);
    t_hi = j == 0 ? hi : fminf(t_hi, hi);
  }
  const float segx = bx - ax, segy = by - ay;
  const float x0 = ax + segx * t_lo, y0 = ay + segy * t_lo;
  const float x1 = ax + segx * t_hi, y1 = ay + segy * t_hi;
  return t_hi > t_lo ? 0.5f * (x0 * y1 - x1 * y0) : 0.f;
}

// Centres a pair on its own midpoint, which keeps fp32 cancellation small at
// any world position (iou.py:91-96).
__device__ __forceinline__ void centre_pair(float* ax, float* ay, float* bx, float* by) {
  const float mid_x = ((ax[0] + ax[1] + ax[2] + ax[3]) * 0.25f
                       + (bx[0] + bx[1] + bx[2] + bx[3]) * 0.25f) * 0.5f;
  const float mid_y = ((ay[0] + ay[1] + ay[2] + ay[3]) * 0.25f
                       + (by[0] + by[1] + by[2] + by[3]) * 0.25f) * 0.5f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] -= mid_x;
    ay[k] -= mid_y;
    bx[k] -= mid_x;
    by[k] -= mid_y;
  }
}

// kPoint, kQuad or 0 (never culled); see the note at the top.
// iou_kernel._box_kind is its plain twin.
__device__ __forceinline__ int box_kind(const float* x, const float* y) {
  bool in_range = true, point = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    in_range = in_range && fabsf(x[k]) <= kCoordLimit && fabsf(y[k]) <= kCoordLimit;
    point = point && x[k] == x[0] && y[k] == y[0];
  }
  if (!in_range) return 0;
  if (point) return kPoint;
  float ex[4], ey[4], len2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ex[k] = x[(k + 1) & 3] - x[k];
    ey[k] = y[(k + 1) & 3] - y[k];
    len2[k] = ex[k] * ex[k] + ey[k] * ey[k];
  }
  bool quad = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const float cross = ex[k] * ey[k1] - ey[k] * ex[k1];
    quad = quad && len2[k] >= kMinEdge2 && cross > 0.f
           && 4.f * cross * cross >= len2[k] * len2[k1];
  }
  return quad ? kQuad : 0;
}

struct TileBoxes {
  float4 corners[kTile][2];  // (x0, y0, x1, y1), (x2, y2, x3, y3)
  float lo_x[kTile], hi_x[kTile], lo_y[kTile], hi_y[kTile];
  int kind[kTile];
};

// One thread per box: its kind and AABB, widened by `margin`; NaN bounds for
// a box that is never culled.
__device__ __forceinline__ void classify(TileBoxes& t, int i, float margin) {
  const float4 c0 = t.corners[i][0], c1 = t.corners[i][1];
  const float x[4] = {c0.x, c0.z, c1.x, c1.z};
  const float y[4] = {c0.y, c0.w, c1.y, c1.w};
  const int kind = box_kind(x, y);
  t.kind[i] = kind;
  if (kind == 0) {
    t.lo_x[i] = t.hi_x[i] = t.lo_y[i] = t.hi_y[i] = __int_as_float(0x7fc00000);
    return;
  }
  t.lo_x[i] = fminf(fminf(fminf(x[0], x[1]), x[2]), x[3]) - margin;
  t.hi_x[i] = fmaxf(fmaxf(fmaxf(x[0], x[1]), x[2]), x[3]) + margin;
  t.lo_y[i] = fminf(fminf(fminf(y[0], y[1]), y[2]), y[3]) - margin;
  t.hi_y[i] = fmaxf(fmaxf(fmaxf(y[0], y[1]), y[2]), y[3]) + margin;
}

__device__ __forceinline__ void unpack(const float4* c, float* x, float* y) {
  x[0] = c[0].x; y[0] = c[0].y; x[1] = c[0].z; y[1] = c[0].w;
  x[2] = c[1].x; y[2] = c[1].y; x[3] = c[1].z; y[3] = c[1].w;
}

__global__ void __launch_bounds__(kThreads)
overlap_bev_kernel(const float* __restrict__ corners_a, const float* __restrict__ corners_b,
                   float* __restrict__ out, int n, int m) {
  __shared__ TileBoxes sa, sb;
  __shared__ __align__(16) float s_out[kTile][kTile];
  __shared__ uint16_t s_queue[kTile * kTile];  // survivors, row * kTile + col
  __shared__ int s_count;

  const int g = blockIdx.z;
  const int n0 = blockIdx.y * kTile;
  const int m0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - n0), cols = min(kTile, m - m0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  {  // stage: threads 0-127 load A's boxes, 128-255 B's, two float4 each
    const int box = (tid & 127) >> 1, half = tid & 1;
    const bool is_a = tid < 128;
    const int count = is_a ? rows : cols;
    const float4* src = reinterpret_cast<const float4*>(
        is_a ? corners_a + (static_cast<size_t>(g) * n + n0) * 8
             : corners_b + (static_cast<size_t>(g) * m + m0) * 8);
    (is_a ? sa : sb).corners[box][half] =
        box < count ? src[box * 2 + half] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
  if (tid < kTile) classify(sa, tid, kCullMargin);
  else if (tid < 2 * kTile) classify(sb, tid - kTile, 0.f);
  __syncthreads();

  // cull: a thread keeps one column (its B box's bounds in registers) and
  // takes rows r = it * 4 + tid / 64, so a warp covers 32 columns of one row
  // per step; no short-circuit, so no branch. Each warp keeps its 16 ballots
  // and reserves its queue slots with one atomicAdd.
  const int col = tid % kTile;
  const float b_lo_x = sb.lo_x[col], b_hi_x = sb.hi_x[col];
  const float b_lo_y = sb.lo_y[col], b_hi_y = sb.hi_y[col];
  const bool b_quad = sb.kind[col] == kQuad;
  const bool col_in = col < cols;
  unsigned ballots[kPairsPerThread];
  unsigned mine = 0;  // bit `it`: this thread's pair of step `it` survives
  int total = 0;
#pragma unroll
  for (int it = 0; it < kPairsPerThread; ++it) {
    const int r = it * (kThreads / kTile) + tid / kTile;
    const bool apart = (sa.hi_x[r] < b_lo_x) | (b_hi_x < sa.lo_x[r])
                       | (sa.hi_y[r] < b_lo_y) | (b_hi_y < sa.lo_y[r]);
    const bool cull = apart & ((sa.kind[r] == kPoint) | b_quad);
    const bool survive = !cull & col_in & (r < rows);
    s_out[r][col] = 0.f;
    ballots[it] = __ballot_sync(0xffffffffu, survive);
    mine |= static_cast<unsigned>(survive) << it;
    total += __popc(ballots[it]);
  }
  int base = 0;
  if (lane == 0 && total > 0) base = atomicAdd(&s_count, total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kPairsPerThread; ++it) {
    if (mine >> it & 1u) {
      s_queue[base + __popc(ballots[it] & below)] = static_cast<uint16_t>(it * kThreads + tid);
    }
    base += __popc(ballots[it]);
  }
  __syncthreads();

  // survivors: eight lanes a pair, one clipped edge each (lanes 0-3 A's edges
  // inside B, 4-7 B's inside A); lane 0 of the eight sums the eight terms in
  // the order of the one-thread form
  const int count = s_count;
  const int sub = tid & 7;
  const bool a_edge = sub < 4;
  const int k = sub & 3, k1 = (k + 1) & 3;
  const unsigned group = 0xffu << (lane & 24);
  for (int q = tid >> 3; q < count; q += kThreads / 8) {
    const int r = s_queue[q] / kTile, c = s_queue[q] % kTile;
    float ax[4], ay[4], bx[4], by[4];
    unpack(sa.corners[r], ax, ay);
    unpack(sb.corners[c], bx, by);
    centre_pair(ax, ay, bx, by);
    // this lane's edge (p0 -> p1) and the quad it is clipped in, by selects
    float p0x = 0.f, p0y = 0.f, p1x = 0.f, p1y = 0.f, qx[4], qy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float px = a_edge ? ax[i] : bx[i], py = a_edge ? ay[i] : by[i];
      p0x = i == k ? px : p0x;
      p0y = i == k ? py : p0y;
      p1x = i == k1 ? px : p1x;
      p1y = i == k1 ? py : p1y;
      qx[i] = a_edge ? bx[i] : ax[i];
      qy[i] = a_edge ? by[i] : ay[i];
    }
    const float term = clipped_edge(p0x, p0y, p1x, p1y, qx, qy, a_edge ? kTol : -kTol);
    float terms[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) terms[i] = __shfl_sync(group, term, i, 8);
    if (sub == 0) {
      // a term that is not live is +0, and a sum that starts at +0 is never
      // -0, so adding it changes no bit against skipping it
      float total_a = 0.f, total_b = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        total_a += terms[i];
        total_b += terms[4 + i];
      }
      s_out[r][c] = fmaxf(total_a + total_b, 0.f);
    }
  }
  __syncthreads();

  // store the tile once
  float* dst = out + (static_cast<size_t>(g) * n + n0) * m + m0;
  if ((m & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int i = tid; i < kTile * kTile / 4; i += kThreads) {
      const int r = i / (kTile / 4), c = (i % (kTile / 4)) * 4;
      if (r < rows && c < cols) {
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * m + c) =
            *reinterpret_cast<const float4*>(&s_out[r][c]);
      }
    }
  } else {
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      if (r < rows && c < cols) dst[static_cast<size_t>(r) * m + c] = s_out[r][c];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers, the
// corners 16-byte aligned; the launch goes on `stream` and does not
// synchronise. Returns cudaGetLastError().
extern "C" int dfu3d_overlap_bev(const void* corners_a, const void* corners_b, void* out,
                                 int g, int n, int m, void* stream) {
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, g);
  overlap_bev_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners_a), static_cast<const float*>(corners_b),
      static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
