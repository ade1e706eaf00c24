"""Faults planted in the program's step, for the check's own tests and for
reading the upper ends of its limits (calibrate.py). A run of the
benchmark plants none.

Each is plant(prog) on a built step (steps/common.Program) and returns an
undo function. ``unchanged`` and ``half_batch`` are the faults a training
step on one chip can have (it has no exchange between chips, and no
per-request answer to alter); ``sum_for_mean`` and ``no_clip`` break the
optimizer's accumulation and clip, where the step has them.
"""

from __future__ import annotations


def unchanged(prog):
    """A step that returns its state unchanged: the optimizer never
    updates the parameters."""
    opt = prog.opt
    opt.step = lambda: False
    return lambda: opt.__dict__.pop("step", None)


def half_batch(prog):
    """Half of the batch left out: the step sees the first half of the rays
    (and of their draws), its loss the mean over them."""
    step = prog.step

    def halved(b):
        n = b["rays_o"].shape[0] // 2
        return step({k: (v[:n] if hasattr(v, "shape") and v.dim() > 0 else v)
                     for k, v in b.items()})

    prog.step = halved

    def undo():
        prog.step = step
    return undo


def sum_for_mean(prog):
    """The accumulation's sum in place of its mean: every mini-step's
    gradient enters k times over."""
    opt = prog.opt
    k = opt.accumulate_steps
    step = type(opt).step

    def summed():
        for p in opt.leaves:
            if p.grad is not None:
                p.grad.mul_(k)
        return step(opt)

    opt.step = summed
    return lambda: opt.__dict__.pop("step", None)


def no_clip(prog):
    """The global-norm clip left out."""
    opt = prog.opt
    clip = opt.grad_clip
    opt.grad_clip = None

    def undo():
        opt.grad_clip = clip
    return undo


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "sum_for_mean": sum_for_mean,
          "no_clip": no_clip}
