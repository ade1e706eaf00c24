"""Device time by span for the occupancy-grid readers: each device
operation is the one that the span open at its launch asked for. On the
one stream the k-th launch, copy or set call of the CUDA runtime in the
host records is the k-th operation on the device; where the two counts
differ (a call or an operation the trace did not keep) nothing is read."""

from __future__ import annotations

from ..work_occgrid import OccgridCall
from . import _spans

CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
COPIES = ("cudaMemcpy", "cudaMemset")  # prefixes: the async and 2-d forms too


def is_device_call(name: str) -> bool:
    return name in CALLS or name.startswith(COPIES)


def launched(ctx):
    """[(device operation, host ns of the call that launched it)] in the
    device's order, or None where the counts differ."""
    calls = sorted(a for n, a, _ in ctx.trace.host if is_device_call(n))
    ops = sorted(ctx.trace.ops, key=lambda o: o[1])
    if len(calls) != len(ops):
        return None
    return list(zip(ops, calls))


def inside(t, spans) -> bool:
    return any(s <= t < e for s, e in spans)


def span_seconds(ctx, name):
    """(device seconds of the operations launched inside the spans named
    ``name``, how many such spans), or None."""
    spans = sorted(_spans.intervals(ctx, name))
    ops = launched(ctx) if spans else None
    if ops is None:
        return None
    ns = sum(b - a for (_, a, b, _), t in ops if inside(t, spans))
    return ns / 1e9, len(spans)


def call(ctx):
    """The step's OccgridCall (steps/occgrid_init.calls), or None."""
    return next((c for c in ctx.calls if isinstance(c, OccgridCall)), None)
