#!/usr/bin/env python3
"""How far the pre-encoded kernels' weight grads sit from their plain
version, and from float32, on the card test's small shape.

    python3 scripts/torch_enc_w_reading.py    (on a machine with an H100)

K = 2 time-conditioned 4x256 fields on 3,000 points a field, built as
tests/test_torch_cuda.py's stacked pre-encoded test builds them (seed 10),
the time column as drawn (normal) and in [0, 1]. For each field, the
largest weight-grad error, each grad scaled by its largest entry as
kernels.parity.compare scales it, of: the kernel against the bf16 plain
version (parity's w), the kernel against the plain version in float32,
and the bf16 plain version against float32. The kernel is the field-axis
launch (fused_stacked_apply with pe=None); the script also checks that
each field's outputs and grads equal the per-field pre-encoded launch's
bit for bit.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from startrax_torch import convert  # noqa: E402
from startrax_torch.kernels import fused_mlp as fm  # noqa: E402
from startrax_torch.models import fields  # noqa: E402
from startrax_torch.ops.encoding import positional_encoding  # noqa: E402
from startrax_torch.utils.tree import tree_map  # noqa: E402

N = 3000


def _setup(time01):
    cfg = fields.FieldConfig(depth=4, width=256, input_dims=4)
    g = torch.Generator().manual_seed(10)
    params = fields.init_stacked_fields(cfg, 2, g, device="cpu")
    for blk in params["blocks"]:  # nonzero fc1, as the card test
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    pts = torch.randn(2, N, 4, generator=g)
    dirs = torch.nn.functional.normalize(torch.randn(2, N, 3, generator=g), dim=-1)
    if time01:
        pts[..., 3] = torch.rand(2, N, generator=torch.Generator().manual_seed(3))
    return (cfg, params, positional_encoding(pts, cfg.multires).cuda(),
            positional_encoding(dirs, cfg.multires_views).cuda())


def _rel(u, v):
    return float((u - v).abs().max() / (v.abs().max() + 1e-12))


def main():
    if not torch.cuda.is_available():
        print("torch_enc_w_reading: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for time01 in (False, True):
        cfg, params, x, d = _setup(time01)
        weights = fm.flatten_params(params, cfg.n_blocks)
        a, r = fm.fused_stacked_apply(params, x, d, cfg.n_blocks)
        out_k = torch.cat([a[..., None], r], -1)
        out_b = fm.fused_stacked_plain(x, d, weights, cfg.n_blocks)
        out_f = fm.fused_stacked_plain(x, d, weights, cfg.n_blocks, compute_dtype=torch.float32)
        cot = torch.cat([torch.cos(out_b[..., :1]), 2.0 * out_b[..., 1:]], -1).detach()
        g_k, g_b, g_f = (torch.autograd.grad(o, weights, cot) for o in (out_k, out_b, out_f))
        for k in range(2):
            one = tree_map(lambda t: t[k].detach().requires_grad_(True), params)
            a1, r1 = fm.fused_field_apply(one, x[k], d[k], cfg.n_blocks)
            o1 = torch.cat([a1[..., None], r1], -1)
            g1 = torch.autograd.grad(o1, fm.flatten_params(one, cfg.n_blocks), cot[k])
            same = torch.equal(o1, out_k[k].detach()) and all(
                torch.equal(u[k], v) for u, v in zip(g_k, g1))
            print(f"time column {'in [0, 1]' if time01 else 'normal'}, field {k}: w kernel vs "
                  f"bf16 plain {max(_rel(u[k], v[k]) for u, v in zip(g_k, g_b)):.3e}, kernel vs "
                  f"f32 {max(_rel(u[k], f[k]) for u, f in zip(g_k, g_f)):.3e}, bf16 plain vs f32 "
                  f"{max(_rel(v[k], f[k]) for v, f in zip(g_b, g_f)):.3e}; field-axis launch "
                  f"equal to the per-field launch bit for bit: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
