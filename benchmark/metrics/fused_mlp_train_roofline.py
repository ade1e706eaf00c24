"""The fused field MLP's share of its roofline in the occupancy-grid step's
training call, in percent: fused_mlp_roofline's reading (work.call_bounds
of the step's call over the device time of the kernels that
fused_mlp_kernels.json names) with the kernels launched inside
``occgrid.update`` left out. The update's forward-only call over the grid
is no part of the call the bound counts; it is read by
occgrid_update_roofline."""

from .. import work
from ..trace import base_name
from . import _fused, _occgrid, _spans


def read(ctx):
    call, ops = _occgrid.call(ctx), _occgrid.launched(ctx)
    if call is None or ops is None:
        return None
    names, updates = set(_fused.names()), _spans.intervals(ctx, "occgrid.update")
    s = {}
    for (name, a, b, kernel), t in ops:
        key = base_name(name)
        if kernel and key in names and not _occgrid.inside(t, updates):
            s[key] = s.get(key, 0.0) + (b - a) / 1e9
    if not s:
        return None
    bound_ms = sum(work.call_bounds(call)[n] for n in s)
    device_ms = sum(s.values()) * 1e3 / ctx.trace.steps
    return 100.0 * bound_ms / device_ms
