"""Host ms a step inside the span ``fused_mlp.pack`` (the fused MLP's
weight repack, kernels/fused_mlp.py), in the traced stretch: summed over
the loop thread's forward packs and the autograd engine thread's backward
packs, a part of the forward's and the backward's host time."""

from . import _spans


def read(ctx):
    return _spans.host_ms(ctx, "fused_mlp.pack")
