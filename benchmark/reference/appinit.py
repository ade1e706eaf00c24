"""The reference of the appearance-init step (steps/appinit.py): the static
field alone, no pose, no regularizer, Adam with one group and no clip."""

from __future__ import annotations

from typing import Dict, List

from . import train
from .star import schedule


def run_steps(flags: Dict, workload: Dict, params0, batches: List[Dict], n_steps: int, state,
              precision: str = "f32") -> Dict:
    """train.run_steps for this kind; params0 the fields."""
    def make_opt(live):
        return train.adam(flags, live, dict.fromkeys(live, 0),
                          [schedule(flags["lrate"], **train.decay(flags))], None, state)

    return train.run_steps(flags, params0, batches, n_steps, precision, lambda tree: tree,
                           make_opt, lambda tree, b: None, lambda tree: None, False)
