"""The appearance-init step (train.loop.make_appinit_train_step: the static
field alone, no pose) with the optimizer that apps/app_init.py builds for
the configuration: one group over every field, its decay and accumulation,
no clip. Its reference is reference/appinit.py."""

from __future__ import annotations

from typing import Dict, List

from .. import work
from .common import Program, configs, program_leaves, resume


def build(flags: Dict, workload: Dict, params, state) -> Program:
    from startrax_torch.train import loop, optim

    cfg, star_cfg, loss_cfg = configs(flags)
    tree, leaves = program_leaves(params)
    opt = optim.make_appinit_optimizer(
        tree, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch, decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay, decay_milestones=cfg.lrate_decay_steps,
        accumulate_steps=cfg.accumulate_grad_batches)
    resume(opt, leaves, state)
    train_step = loop.make_appinit_train_step(star_cfg, loss_cfg, opt)

    def step(b):
        batch = {k: b[k] for k in ("rays_o", "rays_d", "target", "target_depth") if k in b}
        return train_step(tree, batch, u_strat=b["u_strat"], u_pdf=b["u_pdf"])[0]

    return Program(step, leaves, opt)


def calls(flags: Dict, workload: Dict) -> List[work.FieldCall]:
    """The step's fused calls: the static field's coarse and fine passes."""
    static, static_fine, _, _ = work.field_shapes(flags)
    n_c, n_f = work.points(flags)
    return [work.FieldCall("static coarse", static, n_c),
            work.FieldCall("static fine", static_fine, n_f)]
