"""The program's spans in the traced stretch: host ranges that
startrax_torch.utils.profiling.span records on the profiler's clock,
found by name among the trace's host operations. A program without them
(one older than its spans) gives the readers nothing to read."""

from __future__ import annotations

# CUDA runtime calls that block the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def intervals(ctx, name):
    """(start ns, end ns) of every span named ``name``."""
    return [(a, b) for n, a, b in ctx.trace.host if n == name]


def host_ms(ctx, name):
    """Host wall ms a step inside the spans named ``name``, summed over
    every thread that opens them, or None where the trace holds none."""
    spans = intervals(ctx, name)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e6 / ctx.trace.steps
