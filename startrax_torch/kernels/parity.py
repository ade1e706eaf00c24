"""The fused-MLP kernels held against their plain version on the same inputs.

``compare`` runs the kernels (``fused_field_apply`` for one field,
``fused_stacked_apply`` for a stack of K fields, each on raw points or,
with pe=None, on pre-encoded features; on CUDA tensors) and the
plain version (``fused_mlp_plain``, ``fused_stacked_plain``) on one batch,
differentiates both with the cotangent of the JAX kernel tests' loss,
sum(sin(alpha)) + sum(rgb^2), taken from the plain output, and measures how
far apart they are. ``LIMITS`` (``ENC_LIMITS`` in the pre-encoded mode)
bounds each measure; chip_smoke.py and tests/test_torch_cuda.py both check
against it.

Measures, each relative to the plain version's own scale, and for a stack
the worst over its fields:

- ``fwd``: max |kernel - plain| over max |plain|, for raw alpha and for raw
  rgb apart; the larger of the two.
- ``fwd_rms``: the same with the root-mean-square in place of the max.
- ``w``: for each weight and bias grad, max |kernel - plain| over max
  |plain|; the largest over the grads.
- ``input``: the same on the grads of the points and of the directions, when
  they require grad (the input-gradient mode). A point's grad passes the
  encoding's top frequency (2^9), so a relu flip at one point shows at full
  size here: this measure bounds single-point outliers.
- ``input_rms``: the same with the root-mean-square in place of the max.
- In the pre-encoded mode (pe=None) the input grads are dx_emb and dd_emb.
  They pass no encoding frequency, yet a relu flip at one point still shows
  (up to 0.15 max-scaled), so ``input`` keeps its limit; ``input_rms`` is
  held to the tighter one of ``ENC_LIMITS``.
- ``pose``: the same on the gradient of the pose 7-vector behind a packed
  warp.
- ``ray_pose``: for a per-ray pose leaf [R, K, 7] that reaches x and d
  through warp_to_vehicle_frames, the root-mean-square of the difference of
  its grads over that of the plain version's. Each ray's pose grad sums only
  its own samples, so, like a point's grad, it carries single-ray outliers.

Both sides round matmul operands to bf16 and accumulate in f32, in another
order, so an operand near a bf16 rounding boundary may round the other way.
The limits sit between the largest reading of the sound kernels and the
smallest reading of kernels with planted faults, at the step's shapes (the
readings are in PERF.md, Findings).
"""

from __future__ import annotations

from typing import Dict

import torch

from .fused_mlp import (
    flatten_params,
    fused_field_apply,
    fused_mlp_plain,
    fused_stacked_apply,
    fused_stacked_plain,
)

# Largest sound reading -> smallest reading of a planted fault that the
# measure is there to catch (H100, chip_smoke.py's cases and the card tests'):
# fwd_rms 7.7e-4 -> 3.4e-3 (residual stream rounded to bf16 between blocks);
# w 7.0e-4 -> 1.8e-2 (one of 64 weight-gradient splits dropped); pose 5.5e-3
# -> 2.6e-2 (the bf16 residual stream, unmasked; dx unwarped by M instead of
# M^T reads 0.55 and more). fwd bounds single-point outliers. The field-axis
# kernel's input-gradient mode: input 0.14 -> 0.36 (field 0's last ragged
# tile spilling into field 1; dd left at zero reads 1.0, the BARF mask left
# out of dx, dd 60 and more); input_rms 9.1e-3 -> 4.4e-2 (the spill);
# ray_pose 5.3e-3 -> 1.5e-2 (the spill); w 1.5e-3 -> 1.3e-2 (the spill;
# swapped fields' weight grads read 1.8 and more).
LIMITS = {"fwd": 1e-2, "fwd_rms": 1.5e-3, "w": 2e-3, "input": 0.3, "input_rms": 2e-2,
          "pose": 1.5e-2, "ray_pose": 1e-2}
# The pre-encoded mode (chip_smoke.py phase 5's cases and the card tests',
# scripts/torch_planted_faults.py): the same forward and weight-grad limits
# (sound fwd 5.5e-3, fwd_rms 8.4e-4, w 1.5e-3; the ragged tile running past n
# reads w 3.5e-3 and more). dx_emb and dd_emb pass no encoding frequency but
# still carry single-point outliers: input 0.15 -> 0.46 (the pad columns
# left unzeroed; the ragged spill 0.68, dd_emb at zero 1.0); input_rms
# 7.5e-3 -> 2.0e-2 (the pad columns).
ENC_LIMITS = dict(LIMITS, input_rms=1.5e-2)


def _max_rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _rms_rel(a, b):
    return float((a - b).norm() / (b.norm() + 1e-12))


def compare(params, x, d, n_blocks: int, pe=None, pe_masks=None, warp=None, pose=None,
            stacked: bool = False, cot_mask=None, plain_rows=None):
    """Kernels against plain version on x, d [N, 3] (one field), on
    pre-encoded x [N, in_ch], d [N, view_ch] (pe=None), or on x, d [K, N, 3]
    (pre-encoded [K, N, in_ch], [K, N, view_ch]) with stacked params
    (stacked=True). warp is the packed
    [16] warp made from the 7-vector leaf ``pose`` (one field), or None; or
    ``pose`` is a per-ray pose leaf [R, K, 7] from which x and d were made.
    cot_mask [N] (0 or 1) multiplies the cotangent, as a render's masked
    slots zero it. plain_rows runs the plain version of one field with
    weight grads only in slices of that many rows (its outputs joined, its
    grads summed), for calls too large for its memory.
    Returns (errors, run): errors maps each measure above (plus ``fwd_abs``
    and ``grad_abs``, the largest absolute differences, and ``finite``) to
    its reading, and ``encoded`` to whether pe is None; run holds the
    outputs, the cotangent and the
    differentiated leaves, for timing (without plain_rows)."""
    weights = flatten_params(params, n_blocks)
    inputs = [t for t in (x, d) if t.requires_grad]
    leaves = list(weights) + inputs + ([pose] if pose is not None else [])

    def cot_of(out, rows=slice(None)):
        cot = torch.cat([torch.cos(out[..., :1]), 2.0 * out[..., 1:]], -1).detach()
        return cot if cot_mask is None else cot * cot_mask[rows, None]

    if stacked:
        a, r = fused_stacked_apply(params, x, d, n_blocks, pe, pe_masks=pe_masks)
    else:
        a, r = fused_field_apply(params, x, d, n_blocks, pe, pe_masks=pe_masks, warp=warp)
    out_k = torch.cat([a[..., None], r], -1)
    if plain_rows is None:
        out_p = (fused_stacked_plain(x, d, weights, n_blocks, pe, masks=pe_masks) if stacked
                 else fused_mlp_plain(x, d, weights, n_blocks, pe, warp=warp, masks=pe_masks))
        cot = cot_of(out_p)
        g_p = torch.autograd.grad(out_p, leaves, cot, retain_graph=True)
    else:
        if stacked or len(leaves) != len(weights):
            raise ValueError("plain_rows takes one field with weight grads only")
        outs, cots, g_p = [], [], None
        for i in range(0, x.shape[0], plain_rows):
            rows = slice(i, i + plain_rows)
            o = fused_mlp_plain(x[rows], d[rows], weights, n_blocks, pe, warp=warp,
                                masks=pe_masks)
            c = cot_of(o, rows)
            g = torch.autograd.grad(o, leaves, c)
            g_p = g if g_p is None else [u + v for u, v in zip(g_p, g)]
            outs.append(o.detach())
            cots.append(c)
        out_p, cot = torch.cat(outs), torch.cat(cots)
    g_k = torch.autograd.grad(out_k, leaves, cot, retain_graph=True)
    k, p = out_k.detach(), out_p.detach()

    def worst(fn, u, v):  # per field when stacked
        return max(fn(u[i], v[i]) for i in range(u.shape[0])) if stacked else fn(u, v)

    n_w, n_in = len(weights), len(inputs)
    errors: Dict[str, float] = {
        "fwd": max(worst(_max_rel, k[..., :1], p[..., :1]),
                   worst(_max_rel, k[..., 1:], p[..., 1:])),
        "fwd_rms": max(worst(_rms_rel, k[..., :1], p[..., :1]),
                       worst(_rms_rel, k[..., 1:], p[..., 1:])),
        "w": max(worst(_max_rel, u, v) for u, v in zip(g_k[:n_w], g_p[:n_w])),
        "fwd_abs": float((k - p).abs().max()),
        "grad_abs": max(float((u - v).abs().max()) for u, v in zip(g_k, g_p)),
        "finite": bool(torch.isfinite(k).all()) and all(bool(torch.isfinite(g).all())
                                                        for g in g_k),
        "encoded": pe is None,
    }
    if inputs:
        pairs = list(zip(g_k[n_w:n_w + n_in], g_p[n_w:n_w + n_in]))
        errors["input"] = max(worst(_max_rel, u, v) for u, v in pairs)
        errors["input_rms"] = max(worst(_rms_rel, u, v) for u, v in pairs)
    if pose is not None and pose.dim() == 1:
        errors["pose"] = _max_rel(g_k[-1], g_p[-1])
    elif pose is not None:
        errors["ray_pose"] = _rms_rel(g_k[-1], g_p[-1])
    run = {"out_k": out_k, "out_p": out_p, "cot": cot, "leaves": leaves}
    return errors, run


def limits(errors: Dict[str, float]) -> Dict[str, float]:
    """The limits that hold a reading of compare: LIMITS, or ENC_LIMITS for
    the pre-encoded mode."""
    return ENC_LIMITS if errors.get("encoded") else LIMITS


def failures(errors: Dict[str, float]):
    """The measures that are over their limit (and "finite" if any kernel
    output or grad is not finite)."""
    bad = [k for k, lim in limits(errors).items() if k in errors and not errors[k] <= lim]
    return bad + ([] if errors["finite"] else ["finite"])
