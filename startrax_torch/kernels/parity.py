"""The fused-MLP kernels held against their plain version on the same inputs.

``compare`` runs ``fused_field_apply`` (the kernels, on CUDA tensors) and
``fused_mlp_plain`` on one batch, differentiates both with the cotangent of
the JAX kernel tests' loss, sum(sin(alpha)) + sum(rgb^2), taken from the
plain output, and measures how far apart they are. ``LIMITS`` bounds each
measure; chip_smoke.py and tests/test_torch_cuda.py both check against it.

Measures, each relative to the plain version's own scale:

- ``fwd``: max |kernel - plain| over max |plain|, for raw alpha and for raw
  rgb apart; the larger of the two.
- ``fwd_rms``: the same with the root-mean-square in place of the max.
- ``w``: for each weight and bias grad, max |kernel - plain| over max
  |plain|; the largest over the grads.
- ``pose``: the same on the gradient of the pose 7-vector behind the warp.

Both sides round matmul operands to bf16 and accumulate in f32, in another
order, so an operand near a bf16 rounding boundary may round the other way.
The limits sit between the largest reading of the sound kernels and the
smallest reading of kernels with planted faults, at the step's shapes (the
readings are in PERF.md, Findings).
"""

from __future__ import annotations

from typing import Dict

import torch

from .fused_mlp import flatten_params, fused_field_apply, fused_mlp_plain

# Largest sound reading -> smallest reading of a planted fault that the
# measure is there to catch (H100, chip_smoke.py's cases and the card tests'):
# fwd_rms 7.7e-4 -> 3.4e-3 (residual stream rounded to bf16 between blocks);
# w 7.0e-4 -> 1.8e-2 (one of 64 weight-gradient splits dropped); pose 5.5e-3
# -> 2.6e-2 (the bf16 residual stream, unmasked; dx unwarped by M instead of
# M^T reads 0.55 and more). fwd bounds single-point outliers.
LIMITS = {"fwd": 1e-2, "fwd_rms": 1.5e-3, "w": 2e-3, "pose": 1.5e-2}


def _max_rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _rms_rel(a, b):
    return float((a - b).norm() / (b.norm() + 1e-12))


def compare(params, x, d, n_blocks: int, pe, pe_masks=None, warp=None, pose=None):
    """Kernels against plain version on x, d [N, 3]. warp is the packed [16]
    warp made from the leaf ``pose``, or None. Returns (errors, run): errors
    maps each measure above (plus ``fwd_abs`` and ``grad_abs``, the largest
    absolute differences) to its reading; run holds the outputs, the
    cotangent and the differentiated leaves, for timing."""
    weights = flatten_params(params, n_blocks)
    leaves = list(weights) + ([pose] if pose is not None else [])
    a, r = fused_field_apply(params, x, d, n_blocks, pe, pe_masks=pe_masks, warp=warp)
    out_k = torch.cat([a[:, None], r], -1)
    out_p = fused_mlp_plain(x, d, weights, n_blocks, pe, warp=warp, masks=pe_masks)
    cot = torch.cat([torch.cos(out_p[:, :1]), 2.0 * out_p[:, 1:]], -1).detach()
    g_k = torch.autograd.grad(out_k, leaves, cot, retain_graph=True)
    g_p = torch.autograd.grad(out_p, leaves, cot, retain_graph=True)
    k, p = out_k.detach(), out_p.detach()
    errors: Dict[str, float] = {
        "fwd": max(_max_rel(k[:, :1], p[:, :1]), _max_rel(k[:, 1:], p[:, 1:])),
        "fwd_rms": max(_rms_rel(k[:, :1], p[:, :1]), _rms_rel(k[:, 1:], p[:, 1:])),
        "w": max(_max_rel(u, v) for u, v in zip(g_k[:len(weights)], g_p[:len(weights)])),
        "fwd_abs": float((k - p).abs().max()),
        "grad_abs": max(float((u - v).abs().max()) for u, v in zip(g_k, g_p)),
        "finite": bool(torch.isfinite(k).all()) and all(bool(torch.isfinite(g).all())
                                                        for g in g_k),
    }
    if pose is not None:
        errors["pose"] = _max_rel(g_k[-1], g_p[-1])
    run = {"out_k": out_k, "out_p": out_p, "cot": cot, "leaves": leaves}
    return errors, run


def failures(errors: Dict[str, float]):
    """The measures that are over their limit (and "finite" if any kernel
    output or grad is not finite)."""
    bad = [k for k, lim in LIMITS.items() if k in errors and not errors[k] <= lim]
    return bad + ([] if errors["finite"] else ["finite"])
