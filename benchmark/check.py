"""The comparison that decides ``correct``: the program's first three steps
against the reference's on the same inputs and the same resumed optimizer
state.

Every reading is taken over the moving leaves: those whose reference
gradient at the first step is at least a thousandth of the median leaf's
(the others, such as app-init's dynamic fields, get none, and would move
under Adam by round-off alone). A leaf's gap is measured against the
larger of the reference's norm of that leaf and the median moving leaf's.

- ``loss_gap``: the relative gap of the first step's loss;
  ``loss_gap_steps`` the largest over the steps;
- ``grad_gap``: the gap between the program's norm of a leaf's gradient at
  the first step and the reference's, the mean over the leaves;
- ``grad_diff``: the norm of the difference of a leaf's gradients, the
  median leaf's; ``grad_diff_worst`` the worst leaf's;
- ``change_gap``: the gap between the norms of a leaf's change over the
  three steps (the optimizer's update with its groups, schedules, clip and
  accumulation, and the quaternions' renormalisation), the worst leaf's;
- ``change_diff``: the norm of the difference of a leaf's changes, the
  median leaf's; ``change_diff_worst`` the worst leaf's.

A workload's "limits" name the numbers compared; the others are readings
printed beside them. PERF.md gives the readings each limit was set from,
and why the others are not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

STILL = 1e-3  # a leaf's gradient under this share of the median leaf's: not moving


def _finite(values: List[float]) -> List[float]:
    """The values, each NaN read as infinite, so that a NaN never passes."""
    return [float("inf") if v != v else v for v in values]


def leaf_norms(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Per leaf: the norms of each side's gradient and change, and of their
    differences. prog and ref as reference.train.run_steps returns them."""
    out = {}
    for n, gr in ref["grads"].items():
        gp, cp, cr = prog["grads"][n], prog["changes"][n], ref["changes"][n]
        out[n] = {"grad_p": float(gp.norm()), "grad_r": float(gr.norm()),
                  "grad_d": float((gp - gr).norm()), "change_p": float(cp.norm()),
                  "change_r": float(cr.norm()), "change_d": float((cp - cr).norm())}
    return out


def from_leaves(leaves: Dict[str, Dict[str, float]], loss_p: List[float],
                loss_r: List[float]) -> Dict[str, float]:
    """Every reading (module docstring) from leaf_norms and each side's
    losses."""
    med = statistics.median([v["grad_r"] for v in leaves.values() if v["grad_r"] > 0])
    moving = [v for v in leaves.values() if v["grad_r"] >= STILL * med]
    g_med = statistics.median([v["grad_r"] for v in moving])
    c_med = statistics.median([v["change_r"] for v in moving])

    def share(num, den, med_of):
        return _finite([num(v) / max(v[den], med_of, 1e-30) for v in moving])

    grad_gap = share(lambda v: abs(v["grad_p"] - v["grad_r"]), "grad_r", g_med)
    grad_diff = share(lambda v: v["grad_d"], "grad_r", g_med)
    change_gap = share(lambda v: abs(v["change_p"] - v["change_r"]), "change_r", c_med)
    change_diff = share(lambda v: v["change_d"], "change_r", c_med)
    losses = _finite([abs(p - r) / max(abs(r), 1e-30) for p, r in zip(loss_p, loss_r)])
    return {"loss_gap": losses[0], "loss_gap_steps": max(losses),
            "grad_gap": statistics.fmean(grad_gap),
            "grad_diff": statistics.median(grad_diff), "grad_diff_worst": max(grad_diff),
            "change_gap": max(change_gap),
            "change_diff": statistics.median(change_diff),
            "change_diff_worst": max(change_diff)}


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every reading of the program's first steps against the reference's."""
    return from_leaves(leaf_norms(prog, ref), prog["losses"], ref["losses"])


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number the limits name is within its limit."""
    return all(values[k] <= lim for k, lim in limits.items())
