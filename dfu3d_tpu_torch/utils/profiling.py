"""Profiling and tracing utilities (port of dfu3d_tpu/utils/profiling.py).

* `trace(logdir)`: a context manager around `torch.profiler.profile` (CPU
  activities, and CUDA's when a card is present) that writes a Chrome trace
  of the host spans and the device kernels into `logdir`; the profile is
  the context's value.
* `annotate(name)`: a named span in that trace (`torch.profiler.record_function`).
* `StepTimer`: a wall-clock per-phase timer with EMA smoothing (the
  reference's `--infer_time` meter, eval_utils.py:40-42), the JAX package's
  arithmetic and summary text.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def trace(logdir):
    """Profile the block; on exit write `<logdir>/trace_<pid>.json` (Chrome
    trace format, chrome://tracing or Perfetto) and set it as the profile's
    `trace_path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = logdir / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(prof.trace_path))


def annotate(name: str):
    """A span named `name` in the trace of an enclosing `trace`."""
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    """EMA-smoothed phase timer. Use .tick(name) between phases."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.avg = {}
        self._last = time.time()

    def tick(self, name: str) -> float:
        now = time.time()
        dt = now - self._last
        self._last = now
        prev = self.avg.get(name)
        self.avg[name] = dt if prev is None else (
            self.momentum * prev + (1 - self.momentum) * dt
        )
        return dt

    def reset(self):
        self._last = time.time()

    def summary(self) -> str:
        return "  ".join(f"{k}: {v * 1000:.1f}ms" for k, v in self.avg.items())
