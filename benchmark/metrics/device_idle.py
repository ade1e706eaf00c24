"""Share of a step in which no operation runs on the device, in percent:
1 - (the device's busy time a step in the traced stretch) / (the mean step
time of the unprofiled stretch). The busy time is the union of the
device's operations, which the profiler does not slow; the step time is
taken without the profiler, whose host work would add idle time of its own
(the result's busy_s and window_s are the traced stretch's own)."""


def read(ctx):
    busy = ctx.trace.busy_s() / ctx.trace.steps
    return 100.0 * (1.0 - busy / ctx.step_s)
