#!/usr/bin/env python3
"""Faults planted in the occupancy-grid step's grid update
(startrax_torch/kernels/occgrid.update_grid, which apps/occgrid_init.GridStep
calls), beside faults.py's: for the check's tests and for reading the
upper ends of the occgrid cell's limits. A run of the benchmark plants
none.

- ``no_update``: the update skipped; the grid stays as it was.
- ``no_decay``: the update without the EMA's decay; refreshed cells take
  max(ema, density).

Each is plant(prog) on a built step and returns an undo function, as in
faults.py. Run as a script, this is calibrate.py with these faults added
to faults.py's:

    python3 benchmark/faults_occgrid.py --workload star_carla_nerfacc.occgrid_init \\
        --faults unchanged,half_batch,no_update,no_decay [calibrate.py's other options]
"""

from __future__ import annotations

import dataclasses
import os
import sys


def _replace_update(make):
    """Puts make(update_grid) in place of the program's update_grid."""
    from startrax_torch.kernels import occgrid

    update = occgrid.update_grid
    occgrid.update_grid = make(update)

    def undo():
        occgrid.update_grid = update
    return undo


def no_update(prog):
    """The grid update skipped: the step marches through the grid as it was."""
    return _replace_update(lambda update: lambda grid, *args, **kw: grid)


def no_decay(prog):
    """The grid update without the EMA's decay."""
    def undecayed(update):
        def run(grid, density_fn, cfg, *args, **kw):
            return update(grid, density_fn, dataclasses.replace(cfg, ema_decay=1.0), *args, **kw)
        return run
    return _replace_update(undecayed)


FAULTS = {"no_update": no_update, "no_decay": no_decay}


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import calibrate, faults

    faults.FAULTS.update(FAULTS)
    calibrate.main()
