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

from ..utils.profiling import span
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
    whose .grad is None count as zero gradients.

    accumulate_steps = k > 1 is optax.MultiSteps around it: each step() folds
    the grads into a running mean (acc + (g - acc) / (n + 1) after n earlier
    mini-steps); the k-th applies clip and Adam to that mean and resets it,
    and the other k - 1 leave the parameters, the moments and the step count
    (so the schedules) untouched.

    ray_group (a parallel.mesh.RayGroup, or None) makes it data-parallel:
    step() all-reduces (sums) the concatenated grads of the ranks' loss
    shares first, so accumulation, the clip's global norm and Adam read the
    whole batch's grad, and every rank's leaves stay bit-identical. The
    train steps read it to reduce their losses and draw at the whole batch's
    shape (train.loop)."""

    def __init__(self, leaves: Sequence[torch.Tensor], group_ids: Sequence[int],
                 schedules: Sequence[Schedule], grad_clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 accumulate_steps: int = 1, ray_group=None):
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        self.leaves = list(leaves)
        self.schedules = list(schedules)
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.accumulate_steps = accumulate_steps
        self.ray_group = ray_group
        self.count = 0
        self.mini_step = 0
        ref = self.leaves[0]
        sizes = [p.numel() for p in self.leaves]
        self.group = torch.cat([torch.full((n,), g, dtype=torch.long, device=ref.device)
                                for n, g in zip(sizes, group_ids)])
        self.m = torch.zeros(sum(sizes), dtype=torch.float32, device=ref.device)
        self.v = torch.zeros_like(self.m)
        self.acc = torch.zeros_like(self.m) if accumulate_steps > 1 else None

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    def state_dict(self) -> Dict:
        """The optimizer's state: the moments, the accumulator (None
        without accumulation), the update count and the mini-steps taken
        since the last update. Its tensors are the live buffers; save it
        with train.checkpoint.save_checkpoint, which detaches them."""
        return {"m": self.m, "v": self.v, "acc": self.acc, "count": self.count,
                "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a state_dict() into this optimizer in place: the buffers
        keep their identity and device. Raises when the state was saved by
        an optimizer over other leaves or another accumulation."""
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the state's accumulation does not match this optimizer's")
        for name in ("m", "v", "acc"):
            dst, src = getattr(self, name), state[name]
            if dst is None:
                continue
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"optimizer state {name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(src))
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def reset(self) -> None:
        """Return to a newly built optimizer's state over the same leaves
        (optax's ``tx.init`` after a pose jump): zero moments and
        accumulator, and the update count and mini-steps at 0, so the
        schedules restart too. The buffers keep their identity."""
        for buf in (self.m, self.v, self.acc):
            if buf is not None:
                buf.zero_()
        self.count = 0
        self.mini_step = 0

    @torch.no_grad()
    def step(self) -> bool:
        """One optimizer step on the leaves' .grad; returns whether it
        updated the parameters."""
        with span("optim.gather"):
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in self.leaves])
            if self.ray_group is not None:
                self.ray_group.all_reduce(g)
            if self.acc is not None:
                self.acc.add_((g - self.acc) / (self.mini_step + 1))
                self.mini_step += 1
                if self.mini_step < self.accumulate_steps:
                    return False
                g = self.acc.clone()
                self.acc.zero_()
                self.mini_step = 0
        with span("optim.adam"):
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
        return True


def make_fused_star_optimizer(params: Dict, lrate_static: float, lrate_dynamic: float,
                              lrate_pose: float, steps_per_epoch: int = 1,
                              decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
                              decay_milestones: Optional[Sequence[int]] = None,
                              pose_decay_rate: float = 0.5,
                              pose_decay_epochs: Optional[int] = None,
                              pose_decay_milestones: Optional[Sequence[int]] = None,
                              grad_clip: Optional[float] = 1.0,
                              accumulate_steps: int = 1, ray_group=None) -> FusedGroupAdam:
    """Adam over {"nerf": star params, "poses": [F-1, K, 7]} with three LR
    groups: static fields, dynamic fields, poses. With accumulate_steps = k,
    an update every k steps on the mean grad, the schedules counting updates
    (an epoch is steps_per_epoch // k of them); ray_group as FusedGroupAdam."""
    sched_steps = max(steps_per_epoch // accumulate_steps, 1)
    kw = dict(decay_rate=decay_rate, decay_epochs=decay_epochs,
              decay_milestones=decay_milestones, steps_per_epoch=sched_steps)
    scheds = [
        make_schedule(lrate_static, **kw),
        make_schedule(lrate_dynamic, **kw),
        make_schedule(lrate_pose, decay_rate=pose_decay_rate, decay_epochs=pose_decay_epochs,
                      decay_milestones=pose_decay_milestones, steps_per_epoch=sched_steps),
    ]
    leaves, groups = [], []
    for name in sorted(params["nerf"]):
        for leaf in tree_leaves(params["nerf"][name]):
            leaves.append(leaf)
            groups.append(0 if name.startswith("static") else 1)
    leaves.append(params["poses"])
    groups.append(2)
    return FusedGroupAdam(leaves, groups, scheds, grad_clip=grad_clip,
                          accumulate_steps=accumulate_steps, ray_group=ray_group)


def make_appinit_optimizer(params: Dict, lrate: float, steps_per_epoch: int = 1,
                           decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
                           decay_milestones: Optional[Sequence[int]] = None,
                           grad_clip: Optional[float] = None,
                           accumulate_steps: int = 1, ray_group=None) -> FusedGroupAdam:
    """Single-group Adam with a schedule, for appearance init; accumulation
    and ray_group as in make_fused_star_optimizer."""
    sched = make_schedule(lrate, decay_rate=decay_rate, decay_epochs=decay_epochs,
                          decay_milestones=decay_milestones,
                          steps_per_epoch=max(steps_per_epoch // accumulate_steps, 1))
    leaves = tree_leaves(params)
    return FusedGroupAdam(leaves, [0] * len(leaves), [sched], grad_clip=grad_clip,
                          accumulate_steps=accumulate_steps, ray_group=ray_group)


def make_gauge_optimizer(gauge: torch.Tensor, lrate: float, ray_group=None) -> FusedGroupAdam:
    """Plain Adam at a constant learning rate, no clip (optax.adam(lrate),
    as apps/online.py builds it for the gauge fit); ray_group as
    FusedGroupAdam."""
    return FusedGroupAdam([gauge], [0], [lambda count: lrate], ray_group=ray_group)
