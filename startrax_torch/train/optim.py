"""Optimizer and learning-rate schedules (PyTorch).

Counterpart of startrax/train/optim.py's fused path: ``FusedGroupAdam`` is
``fused_group_adam`` (one flat Adam over every parameter, a learning rate per
group, optional global-norm clip), and the schedules are keyed on the step
count as optax's are. The optimizer updates the parameters in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

from ..utils.tree import tree_leaves

Schedule = Callable[[int], float]


def make_schedule(lrate: float, decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
                  decay_milestones: Optional[Sequence[int]] = None, steps_per_epoch: int = 1,
                  cosine_t_max: int = 60000, cosine_eta_min: float = 1e-4) -> Schedule:
    """Milestones -> piecewise constant (x decay_rate at each milestone
    epoch); decay_epochs -> staircase exponential decay; else cosine decay
    to cosine_eta_min over cosine_t_max steps."""
    if decay_milestones:
        boundaries = sorted(int(m) * steps_per_epoch for m in decay_milestones)

        def piecewise(count: int) -> float:
            lr = lrate
            for b in boundaries:
                if count >= b:
                    lr *= decay_rate
            return lr

        return piecewise
    if decay_epochs:
        transition = int(decay_epochs) * steps_per_epoch

        def staircase(count: int) -> float:
            return lrate * decay_rate ** (count // transition)

        return staircase
    alpha = cosine_eta_min / max(lrate, 1e-12)

    def cosine(count: int) -> float:
        c = min(count, cosine_t_max)
        return lrate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cosine_t_max)) + alpha)

    return cosine


class FusedGroupAdam:
    """Adam over all leaves as one flat vector with a learning rate per group.

    The schedule is read at the pre-increment step count and the bias
    correction uses the post-increment count (optax's convention). Leaves
    whose .grad is None count as zero gradients."""

    def __init__(self, leaves: Sequence[torch.Tensor], group_ids: Sequence[int],
                 schedules: Sequence[Schedule], grad_clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves = list(leaves)
        self.schedules = list(schedules)
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        ref = self.leaves[0]
        sizes = [p.numel() for p in self.leaves]
        self.group = torch.cat([torch.full((n,), g, dtype=torch.long, device=ref.device)
                                for n, g in zip(sizes, group_ids)])
        self.m = torch.zeros(sum(sizes), dtype=torch.float32, device=ref.device)
        self.v = torch.zeros_like(self.m)

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in self.leaves])
        if self.grad_clip is not None:
            gnorm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        lrs = torch.tensor([s(self.count) for s in self.schedules], dtype=torch.float32,
                           device=g.device)
        self.count += 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * g * g)
        mhat = self.m / (1 - self.b1 ** self.count)
        vhat = self.v / (1 - self.b2 ** self.count)
        update = -lrs[self.group] * mhat / (torch.sqrt(vhat) + self.eps)
        start = 0
        for p in self.leaves:
            n = p.numel()
            p.add_(update[start:start + n].view_as(p))
            start += n


def make_fused_star_optimizer(params: Dict, lrate_static: float, lrate_dynamic: float,
                              lrate_pose: float, steps_per_epoch: int = 1,
                              decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
                              decay_milestones: Optional[Sequence[int]] = None,
                              pose_decay_rate: float = 0.5,
                              pose_decay_epochs: Optional[int] = None,
                              pose_decay_milestones: Optional[Sequence[int]] = None,
                              grad_clip: Optional[float] = 1.0,
                              accumulate_steps: int = 1) -> FusedGroupAdam:
    """Adam over {"nerf": star params, "poses": [F-1, K, 7]} with three LR
    groups: static fields, dynamic fields, poses."""
    if accumulate_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    kw = dict(decay_rate=decay_rate, decay_epochs=decay_epochs,
              decay_milestones=decay_milestones, steps_per_epoch=steps_per_epoch)
    scheds = [
        make_schedule(lrate_static, **kw),
        make_schedule(lrate_dynamic, **kw),
        make_schedule(lrate_pose, decay_rate=pose_decay_rate, decay_epochs=pose_decay_epochs,
                      decay_milestones=pose_decay_milestones, steps_per_epoch=steps_per_epoch),
    ]
    leaves, groups = [], []
    for name in sorted(params["nerf"]):
        for leaf in tree_leaves(params["nerf"][name]):
            leaves.append(leaf)
            groups.append(0 if name.startswith("static") else 1)
    leaves.append(params["poses"])
    groups.append(2)
    return FusedGroupAdam(leaves, groups, scheds, grad_clip=grad_clip)


def make_appinit_optimizer(params: Dict, lrate: float, steps_per_epoch: int = 1,
                           decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
                           decay_milestones: Optional[Sequence[int]] = None,
                           grad_clip: Optional[float] = None,
                           accumulate_steps: int = 1) -> FusedGroupAdam:
    """Single-group Adam with a schedule, for appearance init."""
    if accumulate_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    sched = make_schedule(lrate, decay_rate=decay_rate, decay_epochs=decay_epochs,
                          decay_milestones=decay_milestones, steps_per_epoch=steps_per_epoch)
    leaves = tree_leaves(params)
    return FusedGroupAdam(leaves, [0] * len(leaves), [sched], grad_clip=grad_clip)
