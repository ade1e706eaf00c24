"""The yardstick's arithmetic for the occupancy-grid step
(steps/occgrid_init.py): the least bytes of its march and the bound of its
grid update, from shapes, with the peaks of work.py.

- The march (kernels/occgrid.march_and_select) reads its jitter uniforms
  (f32 a step), the rays' origins and directions (f32), and the occupancy
  grid once (a byte a cell), and writes the kept depths (f32), their flags
  (a byte) and each ray's count of occupied samples (int64); every other
  array it makes is its own scratch. It does no arithmetic worth a bound
  beside its bytes.
- The update (kernels/occgrid.update_grid) is the field's forward without
  saving on one point a cell (work.kernel_work, save=False), plus the EMA
  read and written (f32) and its draws read: the jitter (3 f32 a cell)
  and the refresh uniform (f32 a cell).
"""

from __future__ import annotations

import dataclasses

from . import work


@dataclasses.dataclass(frozen=True)
class OccgridCall(work.FieldCall):
    """The step's field call (``n`` = rays x budget points), with the sizes
    of the march and the grid that fed it: ``rays`` rays of ``n_march``
    steps, ``res`` cells a side."""

    rays: int = 0
    n_march: int = 0
    res: int = 0

    @property
    def budget(self) -> int:
        return self.n // self.rays


def march_bytes(call: OccgridCall) -> float:
    R = call.rays
    return 4.0 * R * call.n_march + 2 * 12.0 * R + float(call.res ** 3) \
        + R * call.budget * (4.0 + 1.0) + 8.0 * R


def march_bound_ms(call: OccgridCall) -> float:
    """The march's bound: its bytes at the memory rate."""
    return march_bytes(call) / work.PEAK_BYTES * 1e3


def update_bound_ms(call: OccgridCall) -> float:
    """One update's bound: the forward's FLOP at the bf16 peak against its
    bytes and the EMA's and draws' at the memory rate, the larger."""
    cells = call.res ** 3
    flop, nbytes = work.kernel_work(call.field, cells, 1, pe=True, input_grads=False,
                                    warped=False, save=False)["fwd"]
    return work.bound(flop, nbytes + cells * (4.0 + 4.0 + 12.0 + 4.0))[0]
