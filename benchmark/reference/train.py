"""The reference's first training steps, whatever the kind: the same
inputs the program was handed, the same number of steps, and what
``correct`` compares. A kind (reference/<kind>.py) gives its optimizer,
its pose a batch and what follows each update."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .star import Adam, Model, dot_for, loss_share, render


def leaves_of(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a nested dict / list tree, dict keys sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves_of(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves_of(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def rebuild(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """tree's structure over the given leaves."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], leaves, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, list):
        return [rebuild(v, leaves, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]


def decay(flags: Dict) -> Dict:
    """The schedules' decay as the apps read the flags; an epoch counts
    steps_per_epoch // accumulate_grad_batches updates."""
    k = flags.get("accumulate_grad_batches", 1)
    return dict(decay_rate=flags["lrate_decay_rate"], decay_epochs=flags.get("lrate_decay"),
                decay_milestones=flags.get("lrate_decay_steps"),
                steps_per_epoch=max(flags["steps_per_epoch"] // k, 1))


def adam(flags: Dict, leaves: Dict[str, torch.Tensor], groups: Dict[str, int],
         schedules: List, clip: Optional[float], state) -> Adam:
    """Adam over the leaves, resumed from the run's state (inputs.Resume)."""
    return Adam(leaves, groups, schedules, clip, flags.get("accumulate_grad_batches", 1),
                state.mini_step, state.count, state.v)


def run_steps(flags: Dict, params0, batches: List[Dict], n_steps: int, precision: str,
              fields: Callable, make_opt: Callable, pose_of: Callable,
              after: Callable, regularized: bool, chunk_points: int = 1 << 18) -> Dict:
    """n_steps training steps from params0 in float32 (TF32 off), or with
    products in ``precision``; batch i with its draws u_strat, u_pdf.
    ``fields(tree)`` picks the fields of the tree, ``make_opt(live)`` builds
    the optimizer over the live leaves, ``pose_of(tree, batch)`` is the
    batch's pose table [K, 7] or None, ``after(tree)`` runs after each
    optimizer step; ``regularized``: STaR's regularizers in the loss.
    Returns each step's loss, each leaf's gradient at the first step and
    each leaf's change after the n_steps (float32, on the CPU, by leaf
    path), and the global norms the clip read."""
    model = Model.from_flags(flags)
    dot = dot_for(precision)
    init = leaves_of(params0)
    live = {n: t.detach().clone().to(torch.float32).requires_grad_(True) for n, t in init.items()}
    tree = rebuild(params0, live)
    opt = make_opt(live)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    losses, grads = [], None
    try:
        for i in range(n_steps):
            b = batches[i]
            R = b["rays_o"].shape[0]
            chunk = max(1, chunk_points // (model.n_samples + model.n_importance))
            total = 0.0
            for a in range(0, R, chunk):
                rows = slice(a, min(R, a + chunk))
                coarse, fine = render(fields(tree), model, b["rays_o"][rows], b["rays_d"][rows],
                                      pose_of(tree, b), b["u_strat"][rows], b["u_pdf"][rows],
                                      dot)
                share = loss_share(coarse, fine, b, rows, R, model, regularized)
                share.backward()
                total += float(share.detach())
            losses.append(total)
            g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in live.items()}
            if i == 0:
                grads = {n: t.detach().to("cpu", copy=True) for n, t in g.items()}
            opt.step(g)
            with torch.no_grad():
                after(tree)
            for p in live.values():
                p.grad = None
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    changes = {n: (live[n].detach() - init[n].to(torch.float32)).to("cpu") for n in live}
    return {"losses": losses, "grads": grads, "changes": changes, "clip_norms": opt.clip_norms}

