"""The step's model FLOP (the field MLPs' forward and backward at the
configuration's widths and sample counts, counted from shapes by work.py)
over the mean step time of the traced run's unprofiled stretch times the
H100's bf16 peak, in percent."""

from .. import work


def read(ctx):
    return 100.0 * work.step_flop(ctx.calls) / (ctx.step_s * work.PEAK_FLOPS)
