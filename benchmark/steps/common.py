"""What the step kinds share: the program's configuration objects from the
flags, the leaves handed to the program, and the optimizer's resumed
state loaded into it."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..reference.train import leaves_of


@dataclasses.dataclass
class Program:
    """A built step: ``step(batch)`` runs one training step of the program
    and returns its loss (a device scalar, not read); ``leaves`` are the
    program's parameters by path; ``opt`` its optimizer."""

    step: Callable
    leaves: Dict[str, torch.Tensor]
    opt: object


def configs(flags: Dict):
    """The program's StarConfig and LossConfig, as its apps map the flags."""
    from startrax_torch.utils.config import Config, loss_config_from, star_config_from

    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in flags.items() if k in names})
    return cfg, star_config_from(cfg), loss_config_from(cfg)


def program_leaves(params):
    """(tree, {path: leaf}): copies of the benchmark's inputs as the
    program's own leaf tensors (requiring grad), in the same tree; the
    benchmark keeps its originals for the reference."""
    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy(v) for v in tree]
        return tree.detach().clone().requires_grad_(True)

    tree = copy(params)
    return tree, leaves_of(tree)


def resume(opt, leaves: Dict[str, torch.Tensor], state) -> None:
    """Load the resumed state (inputs.Resume) into the program's optimizer
    through its own state_dict: the update count, the mini-steps into the
    accumulation, a zero first moment and accumulator, and the second
    moment of each leaf in the optimizer's own order of leaves."""
    path = {id(t): n for n, t in leaves.items()}
    own = opt.state_dict()
    v = torch.cat([state.v[path[id(p)]].reshape(-1) for p in opt.leaves])
    opt.load_state_dict({"m": torch.zeros_like(own["m"]), "v": v,
                         "acc": None if own["acc"] is None else torch.zeros_like(own["acc"]),
                         "count": state.count, "mini_step": state.mini_step})
