"""Profiling and numeric-debugging helpers (PyTorch).

The port's counterpart of startrax/utils/profiling.py:

- trace(): a torch.profiler window that writes a Chrome trace (the card's
  kernels by name, where there is a card),
- StepTimer: wall-clock rays a second that reads a scalar to close the
  timing (float(loss) waits for the card),
- enable_nan_checks(): autograd's anomaly detection (the reference's
  detect_anomaly) and numpy's seterr(all="raise").
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace to <log_dir>/trace.json; yields the profiler (its
    key_averages() sum the kernels by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def enable_nan_checks():
    """Debug mode: autograd raises where a backward produces NaN, and numpy
    raises on floating-point errors (the reference's detect_anomaly=True,
    train_app_init__.py:264, and np.seterr(all="raise"))."""
    torch.autograd.set_detect_anomaly(True)
    np.seterr(all="raise")


class StepTimer:
    """Throughput meter: call tick(loss, n_rays) each step; reads a scalar
    every `sync_every` steps so the device queue drains and the rate is real."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self._count = 0
        self._rays = 0
        self._t0: Optional[float] = None
        self.rays_per_sec = float("nan")

    def tick(self, loss, n_rays: int):
        if self._t0 is None:
            float(loss)  # drain once so timing starts clean
            self._t0 = time.perf_counter()
            return self.rays_per_sec
        self._count += 1
        self._rays += n_rays
        if self._count % self.sync_every == 0:
            float(loss)  # a host read waits for the queued work
            dt = time.perf_counter() - self._t0
            self.rays_per_sec = self._rays / dt
            self._t0 = time.perf_counter()
            self._rays = 0
        return self.rays_per_sec
