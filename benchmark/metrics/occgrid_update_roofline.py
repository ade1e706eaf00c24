"""The grid update's share of its roofline, in percent: the bound of one
update (work_occgrid.update_bound_ms: the field's forward on one point a
cell, nothing saved, with the EMA's and the draws' bytes) times the
updates in the traced stretch, over the device time of the operations
launched inside ``occgrid.update``."""

from .. import work_occgrid
from . import _occgrid


def read(ctx):
    got, call = _occgrid.span_seconds(ctx, "occgrid.update"), _occgrid.call(ctx)
    if got is None or call is None:
        return None
    seconds, updates = got
    return 100.0 * updates * work_occgrid.update_bound_ms(call) / (seconds * 1e3)
