"""Profiling and numeric-debugging helpers (PyTorch).

The port's counterpart of startrax/utils/profiling.py:

- trace(): a torch.profiler window that writes a Chrome trace (the card's
  kernels by name, where there is a card),
- span(name): a named host range around a layer of the training step,
  recorded in that trace on the profiler's own clock,
- enable_nan_checks(): autograd's anomaly detection (the reference's
  detect_anomaly) and numpy's seterr(all="raise").

The spans the program opens, each a CPU range of the trace:

- ``train.step``, ``train.forward``, ``train.losses``, ``train.backward``
  and ``train.optimizer`` in train/loop.py's steps (the backward's is the
  loop thread's wall time, which holds the autograd engine's CUDA
  backward);
- ``render.coarse``, ``render.resample`` and ``render.fine`` in
  models/star.py's render_star;
- ``optim.gather`` (the grads' concatenation, all-reduce and accumulation)
  and ``optim.adam`` (open only on a step that updates) in
  train/optim.py's FusedGroupAdam.step;
- ``fused_mlp.prepare`` (flattening, checking, the save decision) and
  ``fused_mlp.pack`` (each weight repack, the backward's on the autograd
  engine's thread) in kernels/fused_mlp.py's CUDA path;
- ``data.wait``: the training loop's wait on data/prefetch.py's queue.

To see where a step's host time goes, wrap a few steps in
``with trace(dir) as prof:`` (synchronize before the block ends), then
read each span's host total from ``prof.key_averages()`` by its name, or
open ``dir/trace.json`` in a Chrome-trace viewer (chrome://tracing,
Perfetto), where every kernel launch and every gap on the device lines up
under the spans open at that instant.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast

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


def span(name: str):
    """A context manager that records the block as a host range named
    ``name`` while a torch profiler records (a CPU op of the trace, not a
    user annotation: it draws no row on the device's timeline), and costs
    under a microsecond when none does."""
    return _RecordFunctionFast(name)


def enable_nan_checks():
    """Debug mode: autograd raises where a backward produces NaN, and numpy
    raises on floating-point errors (the reference's detect_anomaly=True,
    train_app_init__.py:264, and np.seterr(all="raise"))."""
    torch.autograd.set_detect_anomaly(True)
    np.seterr(all="raise")
