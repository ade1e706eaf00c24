"""Device ms a step of the fused field MLP's kernels (fused_mlp_kernels.json)."""

from . import _fused


def read(ctx):
    s = _fused.seconds(ctx)
    return sum(s.values()) * 1e3 / ctx.trace.steps if s else None
