"""The reference of the online step at one frame a batch (steps/online.py):
the static and K dynamic fields, the batch's frame's poses (frame 0 the
identity), STaR's regularizers, Adam with three groups (static fields,
dynamic fields, poses) and a clip of 1.0, the quaternions renormalised
after each step."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import train
from .star import schedule


def run_steps(flags: Dict, workload: Dict, params0, batches: List[Dict], n_steps: int, state,
              precision: str = "f32") -> Dict:
    """train.run_steps for this kind; params0 {"nerf": fields, "poses":
    [F-1, K, 7]}."""
    K = flags["num_vehicles"]
    d = train.decay(flags)

    def make_opt(live):
        groups = {n: 2 if n == "poses" else 0 if n.startswith("nerf/static") else 1
                  for n in live}
        scheds = [schedule(flags["lrate_static"], **d),
                  schedule(flags["lrate_dynamic"], **d),
                  schedule(flags["lrate_pose"], decay_rate=flags["pose_lrate_decay_rate"],
                                 decay_epochs=flags.get("pose_lrate_decay"),
                                 decay_milestones=flags.get("pose_lrate_decay_steps"),
                                 steps_per_epoch=d["steps_per_epoch"])]
        return train.adam(flags, live, groups, scheds, 1.0, state)

    def pose_of(tree, b):
        ident = torch.zeros(1, K, 7, device=tree["poses"].device)
        ident[..., 6] = 1.0
        return torch.cat([ident, tree["poses"]], 0)[b["frame"]]

    def after(tree):
        q = tree["poses"][..., 3:7]
        q.copy_(q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12))

    return train.run_steps(flags, params0, batches, n_steps, precision,
                           lambda tree: tree["nerf"], make_opt, pose_of, after, True)
