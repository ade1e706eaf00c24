"""Device ms a step of the operations launched inside the span
``occgrid.update`` (kernels/occgrid.py), over the traced steps."""

from . import _occgrid


def read(ctx):
    got = _occgrid.span_seconds(ctx, "occgrid.update")
    return None if got is None else got[0] * 1e3 / ctx.trace.steps
