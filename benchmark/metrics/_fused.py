"""The fused field MLP's kernels as the metrics' data file names them."""

from __future__ import annotations

import json
import os


def names():
    with open(os.path.join(os.path.dirname(__file__), "fused_mlp_kernels.json")) as fp:
        return json.load(fp)["kernels"]


def seconds(ctx):
    """{name: device seconds in the traced stretch} of the named kernels
    the trace holds."""
    ks = ctx.trace.kernel_seconds()
    return {n: ks[n] for n in names() if n in ks}
