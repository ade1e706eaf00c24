"""Device ms a step of every operation but the fused field MLP's kernels:
sampling, sorting, warps, compositing, losses, the optimizer, copies."""

from . import _fused


def read(ctx):
    total = sum((b - a) / 1e9 for _, a, b, _ in ctx.trace.ops)
    return (total - sum(_fused.seconds(ctx).values())) * 1e3 / ctx.trace.steps
