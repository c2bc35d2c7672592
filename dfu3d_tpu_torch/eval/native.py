"""ctypes binding for the native KITTI matcher (eval/csrc/kitti_match.cpp).

Own copy of dfu3d_tpu/eval/native.py without its quiet fallback: the library
is built with g++ at first use into dfu3d_tpu_torch/csrc_build/, named by a
digest of the source and the flags, and a failed build or load raises. The
Python matcher in kitti_eval.py is its plain twin, chosen only by
``use_native=False``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .. import gxx_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "kitti_match.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc_build"
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "collect_thresholds": (ctypes.c_int, [
        _DP, _IP, _DP, _IP, _DP, _IP, _IP, _IP, _DP, _IP,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, _DP,
    ]),
    "fused_statistics": (None, [
        _DP, _IP, _DP, _IP, _DP, _IP, _IP, _IP, _DP, _IP,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        _DP, ctypes.c_int, ctypes.c_int, _DP,
    ]),
}


def library_path() -> Path:
    return gxx_build.library_path(SOURCE, BUILD_DIR, "libkitti_match")


def get_lib():
    """The native matcher, built if needed and loaded once per process."""
    return gxx_build.load(SOURCE, BUILD_DIR, "libkitti_match", "the native KITTI matcher",
                          _SIGNATURES)


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class FlatFrames:
    """Concatenated per-frame arrays + offsets, ready for the C ABI."""

    def __init__(self, overlaps, gt_datas_list, dt_datas_list, ignored_gts,
                 ignored_dets, dontcares):
        n = len(gt_datas_list)
        gt_counts = np.array([len(g) for g in gt_datas_list], np.int64)
        dt_counts = np.array([len(d) for d in dt_datas_list], np.int64)
        dc_counts = np.array([len(d) for d in dontcares], np.int64)
        self.gt_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(gt_counts, out=self.gt_offsets[1:])
        self.dt_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(dt_counts, out=self.dt_offsets[1:])
        self.dc_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(dc_counts, out=self.dc_offsets[1:])
        self.overlap_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(gt_counts * dt_counts, out=self.overlap_offsets[1:])

        self.overlaps = (
            np.concatenate([o.reshape(-1) for o in overlaps])
            if n else np.zeros(0)
        ).astype(np.float64)
        self.gt = (
            np.concatenate([np.asarray(g, np.float64).reshape(-1, 5) for g in gt_datas_list])
            if self.gt_offsets[-1] else np.zeros((0, 5))
        ).astype(np.float64)
        self.dt = (
            np.concatenate([np.asarray(d, np.float64).reshape(-1, 6) for d in dt_datas_list])
            if self.dt_offsets[-1] else np.zeros((0, 6))
        ).astype(np.float64)
        self.ign_gt = (
            np.concatenate([np.asarray(g, np.int64) for g in ignored_gts])
            if self.gt_offsets[-1] else np.zeros(0, np.int64)
        ).astype(np.int64)
        self.ign_dt = (
            np.concatenate([np.asarray(d, np.int64) for d in ignored_dets])
            if self.dt_offsets[-1] else np.zeros(0, np.int64)
        ).astype(np.int64)
        self.dc = (
            np.concatenate([np.asarray(d, np.float64).reshape(-1, 4) for d in dontcares])
            if self.dc_offsets[-1] else np.zeros((0, 4))
        ).astype(np.float64)
        self.num_frames = n
        self.total_gt = int(self.gt_offsets[-1])

    def _args(self):
        return (
            _dp(self.overlaps), _ip(self.overlap_offsets),
            _dp(self.gt), _ip(self.gt_offsets),
            _dp(self.dt), _ip(self.dt_offsets),
            _ip(self.ign_gt), _ip(self.ign_dt),
            _dp(self.dc), _ip(self.dc_offsets),
        )

    def collect_thresholds(self, lib, metric, min_overlap):
        out = np.zeros(max(self.total_gt, 1), np.float64)
        n = lib.collect_thresholds(
            *self._args(), self.num_frames, int(metric), float(min_overlap),
            _dp(out),
        )
        return out[:n]

    def fused_statistics(self, lib, metric, min_overlap, thresholds, compute_aos):
        thresholds = np.ascontiguousarray(thresholds, np.float64)
        pr = np.zeros((max(len(thresholds), 1), 4), np.float64)
        if len(thresholds):
            lib.fused_statistics(
                *self._args(), self.num_frames, int(metric), float(min_overlap),
                _dp(thresholds), len(thresholds), int(bool(compute_aos)), _dp(pr),
            )
        return pr[: len(thresholds)]
