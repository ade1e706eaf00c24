"""The march's share of its roofline, in percent: its least bytes at the
memory rate (work_occgrid.march_bound_ms) over the device time of the
operations launched inside ``occgrid.march``, a march each."""

from .. import work_occgrid
from . import _occgrid


def read(ctx):
    got, call = _occgrid.span_seconds(ctx, "occgrid.march"), _occgrid.call(ctx)
    if got is None or call is None:
        return None
    seconds, marches = got
    return 100.0 * marches * work_occgrid.march_bound_ms(call) / (seconds * 1e3)
