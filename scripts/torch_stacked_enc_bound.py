#!/usr/bin/env python3
"""The least time one H100 could take for the stacked field kernels'
pre-encoded mode (startrax/kernels/fused_mlp.py, _stacked_fwd_kernel and
_stacked_bwd_kernel with pe=None; the port's fused_stacked_apply with
pe=None, which chip_smoke.py phase 3e times against this bound).

    python3 scripts/torch_stacked_enc_bound.py

Counts the work from shapes alone, with chip_smoke.kernel_work's rule (the
multiply-adds of every layer at its real widths; each input read once and
each output written once) and chip_smoke.bound (FLOP at 989 TFLOP/s dense
bf16 against bytes at 3.35 TB/s): K = 2 time-conditioned fields at
startrax/configs/carla_nerf_time.txt's widths (8x256 on 84 + 27 encoded
columns), on the coarse and the fine pass's points of its batch (1000 rays x
256 and x 512 samples a field), forward and backward with weight grads and,
as the stacked backward writes them, the per-point input grads. Runs on the
CPU; it times nothing.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from startrax_torch.models import fields  # noqa: E402
from startrax_torch.models.nerf_time import time_field_cfg  # noqa: E402
from startrax_torch.utils.config import Config, parse_config_file, star_config_from  # noqa: E402

K = 2


def main():
    cfg = Config(**parse_config_file(os.path.join(ROOT, "startrax", "configs",
                                                  "carla_nerf_time.txt")))
    star = star_config_from(cfg)
    for name, fine, samples in (("coarse", False, star.n_samples),
                                ("fine", True, star.n_samples + star.n_importance)):
        fcfg = time_field_cfg(star, fine)
        params = fields.init_stacked_fields(fcfg, K, device="cpu")
        n = cfg.N_rand * samples
        in_ch = params["lin_in"]["w"].shape[-2]
        x = torch.empty(K, n, in_ch, device="meta")
        work = chip_smoke.kernel_work(params, x, fcfg.n_blocks, None, True, False)
        for side in ("fwd", "bwd"):
            flop, nbytes = work[side]
            ms, by = chip_smoke.bound(flop, nbytes)
            print(f"stacked pre-encoded {side} {name}: K={K} {fcfg.depth}x{fcfg.width}, in_ch "
                  f"{in_ch}, {n} points a field: {flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, "
                  f"bound {ms:.3f} ms ({by})")


if __name__ == "__main__":
    main()
