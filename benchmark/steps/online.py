"""The online tracking step at one frame a batch
(train.loop.make_online_train_step, the shared-pose path) with the joint
optimizer that apps/online.py builds for the configuration: three
learning-rate groups, their decays, clip 1.0, its gradient accumulation.
The step runs past BARF (end_barf off) with rotations free, at the
workload's epoch. Its reference is reference/online.py."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .. import work
from .common import Program, configs, program_leaves, resume


def build(flags: Dict, workload: Dict, params, state) -> Program:
    from startrax_torch.train import loop, optim

    cfg, star_cfg, loss_cfg = configs(flags)
    star_cfg = dataclasses.replace(star_cfg, end_barf=-1)
    tree, leaves = program_leaves(params)
    opt = optim.make_fused_star_optimizer(
        tree, lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
        lrate_pose=cfg.lrate_pose, decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay, decay_milestones=cfg.lrate_decay_steps,
        pose_decay_rate=cfg.pose_lrate_decay_rate, pose_decay_epochs=cfg.pose_lrate_decay,
        pose_decay_milestones=cfg.pose_lrate_decay_steps, steps_per_epoch=cfg.steps_per_epoch,
        grad_clip=1.0, accumulate_steps=cfg.accumulate_grad_batches)
    resume(opt, leaves, state)
    train_step = loop.make_online_train_step(star_cfg, loss_cfg, opt,
                                             trans_only=cfg.pose_trans_only)
    epoch = workload["epoch"]

    def step(b):
        batch = {k: b[k] for k in ("rays_o", "rays_d", "target", "frame", "target_depth")
                 if k in b}
        return train_step(tree, batch, epoch=epoch, u_strat=b["u_strat"], u_pdf=b["u_pdf"])[0]

    return Program(step, leaves, opt)


def calls(flags: Dict, workload: Dict) -> List[work.FieldCall]:
    """The step's fused calls: the static field's coarse and fine passes,
    and each vehicle's dynamic field a call a pass, warped in the kernel."""
    static, static_fine, dynamic, dynamic_fine = work.field_shapes(flags)
    n_c, n_f = work.points(flags)
    out = [work.FieldCall("static coarse", static, n_c),
           work.FieldCall("static fine", static_fine, n_f)]
    for k in range(flags["num_vehicles"]):
        out += [work.FieldCall(f"dynamic coarse {k}", dynamic, n_c, warped=True),
                work.FieldCall(f"dynamic fine {k}", dynamic_fine, n_f, warped=True)]
    return out
