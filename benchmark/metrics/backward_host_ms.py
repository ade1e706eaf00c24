"""Host wall ms a step inside the span ``train.backward`` of the program's
training step (train/loop.py), in the traced stretch."""

from . import _spans


def read(ctx):
    return _spans.host_ms(ctx, "train.backward")
