"""Kernel launches a step: the kernels the profiler records on the device in
the traced stretch (one a launch), over its steps."""


def read(ctx):
    return sum(1 for op in ctx.trace.ops if op[3]) / ctx.trace.steps
