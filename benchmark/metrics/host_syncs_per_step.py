"""Host syncs a step: the CUDA runtime calls that block the host
(_spans.SYNCS) that start inside a span ``train.step`` of the program
(train/loop.py), over the traced stretch's steps. A sync outside every
step (the harness's own) is not counted."""

from . import _spans


def read(ctx):
    steps = _spans.intervals(ctx, "train.step")
    if not steps:
        return None
    n = sum(1 for name, a, _ in ctx.trace.host
            if name in _spans.SYNCS and any(s <= a < e for s, e in steps))
    return n / ctx.trace.steps
