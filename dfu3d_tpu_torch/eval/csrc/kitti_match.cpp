// KITTI AP greedy matcher — native hot loop for the evaluator (the port's
// own copy of the JAX package's csrc/kitti_match.cpp).
//
// Semantics are an exact port of the reference's numba kernels
// (pcdet/datasets/kitti/kitti_object_eval_python/eval.py:
//  compute_statistics_jit:161-283 and fused_compute_statistics:299-341),
// re-implemented in C++. Its plain twin is the Python matcher in
// dfu3d_tpu_torch/eval/kitti_eval.py (use_native=False); the tests hold the
// precision/recall tables of the two equal.
//
// Build (dfu3d_tpu_torch/eval/native.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 kitti_match.cpp -o libkitti_match.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double NO_DETECTION = -10000000.0;

// axis-aligned 2D overlap with criterion 0 (divide by first box area)
double image_overlap_c0(const double* a, const double* b) {
  double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
  if (iw <= 0) return 0.0;
  double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (ih <= 0) return 0.0;
  double ua = (a[2] - a[0]) * (a[3] - a[1]);
  if (ua < 1e-12) ua = 1e-12;
  return iw * ih / ua;
}

struct FrameView {
  const double* overlaps;  // (ndt, ngt) row-major [det, gt]
  const double* gt;        // (ngt, 5) bbox + alpha
  const double* dt;        // (ndt, 6) bbox + alpha + score
  const int64_t* ign_gt;   // (ngt,)
  const int64_t* ign_dt;   // (ndt,)
  const double* dc;        // (ndc, 4)
  int ngt, ndt, ndc;
};

// One frame, one threshold. Mirrors compute_statistics_jit exactly.
void match_frame(const FrameView& f, int metric, double min_overlap,
                 double thresh, bool compute_fp, bool compute_aos,
                 double* out_tp, double* out_fp, double* out_fn,
                 double* out_sim, double* tp_thresholds, int* n_thresholds) {
  std::vector<char> assigned(f.ndt, 0);
  std::vector<char> ignored_threshold(f.ndt, 0);
  if (compute_fp) {
    for (int j = 0; j < f.ndt; ++j)
      if (f.dt[j * 6 + 5] < thresh) ignored_threshold[j] = 1;
  }
  double tp = 0, fp = 0, fn = 0, similarity = 0;
  std::vector<double> delta;
  int n_thr = 0;

  for (int i = 0; i < f.ngt; ++i) {
    if (f.ign_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;

    for (int j = 0; j < f.ndt; ++j) {
      if (f.ign_dt[j] == -1 || assigned[j] || ignored_threshold[j]) continue;
      double overlap = f.overlaps[(size_t)j * f.ngt + i];
      double dt_score = f.dt[j * 6 + 5];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 f.ign_dt[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == NO_DETECTION && f.ign_dt[j] == 1) {
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == NO_DETECTION && f.ign_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != NO_DETECTION &&
               (f.ign_gt[i] == 1 || f.ign_dt[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != NO_DETECTION) {
      tp += 1;
      if (tp_thresholds) tp_thresholds[n_thr] = f.dt[det_idx * 6 + 5];
      n_thr += 1;
      if (compute_aos) delta.push_back(f.gt[i * 5 + 4] - f.dt[det_idx * 6 + 4]);
      assigned[det_idx] = 1;
    }
  }

  if (compute_fp) {
    for (int j = 0; j < f.ndt; ++j) {
      if (!(assigned[j] || f.ign_dt[j] == -1 || f.ign_dt[j] == 1 ||
            ignored_threshold[j]))
        fp += 1;
    }
    int nstuff = 0;
    if (metric == 0 && f.ndc > 0) {
      for (int i = 0; i < f.ndc; ++i) {
        for (int j = 0; j < f.ndt; ++j) {
          if (assigned[j] || f.ign_dt[j] == -1 || f.ign_dt[j] == 1 ||
              ignored_threshold[j])
            continue;
          if (image_overlap_c0(&f.dt[j * 6], &f.dc[i * 4]) > min_overlap) {
            assigned[j] = 1;
            nstuff += 1;
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      similarity = 0;
      for (double d : delta) similarity += (1.0 + std::cos(d)) / 2.0;
      if (!(tp > 0 || fp > 0)) similarity = -1;
    }
  }
  *out_tp = tp;
  *out_fp = fp;
  *out_fn = fn;
  *out_sim = similarity;
  if (n_thresholds) *n_thresholds = n_thr;
}

}  // namespace

extern "C" {

// Pass 1: collect TP score thresholds over all frames (compute_fp = false).
// Arrays are concatenations over frames with per-frame counts.
// Returns total number of thresholds written into `out_thresholds`
// (caller allocates total_gt capacity).
int collect_thresholds(
    const double* overlaps_flat, const int64_t* overlap_offsets,
    const double* gt_flat, const int64_t* gt_offsets,
    const double* dt_flat, const int64_t* dt_offsets,
    const int64_t* ign_gt_flat, const int64_t* ign_dt_flat,
    const double* dc_flat, const int64_t* dc_offsets,
    int num_frames, int metric, double min_overlap, double* out_thresholds) {
  int total = 0;
  for (int fidx = 0; fidx < num_frames; ++fidx) {
    FrameView f;
    f.ngt = (int)(gt_offsets[fidx + 1] - gt_offsets[fidx]);
    f.ndt = (int)(dt_offsets[fidx + 1] - dt_offsets[fidx]);
    f.ndc = (int)(dc_offsets[fidx + 1] - dc_offsets[fidx]);
    f.overlaps = overlaps_flat + overlap_offsets[fidx];
    f.gt = gt_flat + gt_offsets[fidx] * 5;
    f.dt = dt_flat + dt_offsets[fidx] * 6;
    f.ign_gt = ign_gt_flat + gt_offsets[fidx];
    f.ign_dt = ign_dt_flat + dt_offsets[fidx];
    f.dc = dc_flat + dc_offsets[fidx] * 4;
    double tp, fp, fn, sim;
    int n_thr = 0;
    match_frame(f, metric, min_overlap, 0.0, false, false, &tp, &fp, &fn, &sim,
                out_thresholds + total, &n_thr);
    total += n_thr;
  }
  return total;
}

// Pass 2: accumulate the PR table over all frames × thresholds.
// pr: (num_thresholds, 4) row-major [tp, fp, fn, similarity], pre-zeroed.
void fused_statistics(
    const double* overlaps_flat, const int64_t* overlap_offsets,
    const double* gt_flat, const int64_t* gt_offsets,
    const double* dt_flat, const int64_t* dt_offsets,
    const int64_t* ign_gt_flat, const int64_t* ign_dt_flat,
    const double* dc_flat, const int64_t* dc_offsets,
    int num_frames, int metric, double min_overlap,
    const double* thresholds, int num_thresholds, int compute_aos,
    double* pr) {
  for (int fidx = 0; fidx < num_frames; ++fidx) {
    FrameView f;
    f.ngt = (int)(gt_offsets[fidx + 1] - gt_offsets[fidx]);
    f.ndt = (int)(dt_offsets[fidx + 1] - dt_offsets[fidx]);
    f.ndc = (int)(dc_offsets[fidx + 1] - dc_offsets[fidx]);
    f.overlaps = overlaps_flat + overlap_offsets[fidx];
    f.gt = gt_flat + gt_offsets[fidx] * 5;
    f.dt = dt_flat + dt_offsets[fidx] * 6;
    f.ign_gt = ign_gt_flat + gt_offsets[fidx];
    f.ign_dt = ign_dt_flat + dt_offsets[fidx];
    f.dc = dc_flat + dc_offsets[fidx] * 4;
    for (int t = 0; t < num_thresholds; ++t) {
      double tp, fp, fn, sim;
      match_frame(f, metric, min_overlap, thresholds[t], true,
                  compute_aos != 0, &tp, &fp, &fn, &sim, nullptr, nullptr);
      pr[t * 4 + 0] += tp;
      pr[t * 4 + 1] += fp;
      pr[t * 4 + 2] += fn;
      if (sim != -1) pr[t * 4 + 3] += sim;
    }
  }
}

}  // extern "C"
