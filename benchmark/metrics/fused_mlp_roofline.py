"""The fused field MLP's share of its roofline, in percent: the bound time
of the step's calls (work.call_bounds: the larger of FLOP at the bf16 peak,
the ordered sums at the float32 peak, and bytes at the memory rate, per
launch) over their device time, both summed over the kernels that
fused_mlp_kernels.json names and the trace holds."""

from .. import work
from . import _fused


def read(ctx):
    s = _fused.seconds(ctx)
    if not s:
        return None
    bound_ms = sum(work.call_bounds(c)[n] for c in ctx.calls for n in s)
    device_ms = sum(s.values()) * 1e3 / ctx.trace.steps
    return 100.0 * bound_ms / device_ms
