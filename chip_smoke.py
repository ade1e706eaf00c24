#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (startrax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from startrax_torch/kernels/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the shapes one online
     step gives it (static 8x256 and dynamic 4x256 with the SE(3) warp, on
     the coarse pass's 256,000 and the fine pass's 512,000 points; and the
     dynamic field with a BARF mask), within the limits of
     startrax_torch/kernels/parity.py, and the kernels' and plain versions'
     times;
  4. the main path: StarConfig and LossConfig from
     startrax/configs/carla_star_online_multi.txt, random weights from a
     seed, app-init steps then online training steps on one fixed batch of
     1000 rays x (256 + 256) samples, through the kernels; the fused forward
     and backward launch counts must rise by 2 per app-init step and 6 per
     online step, and the loss must be finite and fall; then the median step
     time of the kernel path and of the plain path; then the kernel path's
     render against the plain path's on a small batch;
  5. one JSON line per kernel, the card's line, and the result line
     {"ok": true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device or when any phase
fails. Imports nothing of JAX: only torch, numpy, startrax_torch and the
config parser startrax.utils.config (stdlib and numpy only). Float32 matmuls
on the plain paths run in full float32 (TF32 off).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

N_APPINIT = 3
N_ONLINE = 20
N_PLAIN = 5
FRAME = 3


def _require(ok, what):
    """A check that stays under python -O: raise when a phase fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _field(cfg, seed):
    import torch

    from startrax_torch import convert
    from startrax_torch.models import fields

    g = torch.Generator().manual_seed(seed)
    params = fields.init_field(cfg, g)
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    return convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                     requires_grad=True)


def _points(n, near, far, seed):
    """Samples along bench-style rays: normal origins, unit directions."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    o = torch.randn(n // 256, 1, 3, generator=g, device="cuda")
    d = torch.nn.functional.normalize(torch.randn(n // 256, 1, 3, generator=g, device="cuda"),
                                      dim=-1)
    z = torch.linspace(near, far, 256, device="cuda")[None, :, None]
    x = (o + d * z).reshape(-1, 3).contiguous()
    return x, d.expand(-1, 256, -1).reshape(-1, 3).contiguous()


def kernel_cases(star_cfg, n_rand):
    """The field calls of one online step, as (name, field config, points,
    warped, masked, calls per online step): each field's coarse and fine
    call, the dynamic field's K times. The BARF case is off the flagship
    step (end_barf <= 0) and is checked, not timed."""
    n_coarse = n_rand * star_cfg.n_samples
    n_fine = n_rand * (star_cfg.n_samples + star_cfg.n_importance)
    K = star_cfg.num_vehicles
    return [("static coarse", star_cfg.static_field(), n_coarse, False, False, 1),
            ("static fine", star_cfg.static_field(True), n_fine, False, False, 1),
            ("dynamic coarse", star_cfg.dynamic_field(), n_coarse, True, False, K),
            ("dynamic fine", star_cfg.dynamic_field(True), n_fine, True, False, K),
            ("dynamic fine+barf", star_cfg.dynamic_field(True), n_fine, True, True, 0)]


def case_inputs(star_cfg, case, seed):
    """Random inputs of one kernel case, as parity.compare takes them."""
    import torch

    from startrax_torch.kernels.fused_mlp import pe_mask_row
    from startrax_torch.models.star import pack_warp
    from startrax_torch.ops.encoding import barf_weights

    _, fcfg, n_points, warped, masked, _ = case
    pe = (star_cfg.multires, star_cfg.multires_views)
    x, d = _points(n_points, star_cfg.near, star_cfg.far, seed=20 + seed)
    pose = torch.tensor([0.01, -0.02, 0.005, 0.1, 0.2, -0.1, 0.97], device="cuda")
    pose = (pose / torch.cat([torch.ones(3, device="cuda"), pose[3:].norm().expand(4)]))
    pose.requires_grad_(True)
    masks = None
    if masked:
        masks = tuple(pe_mask_row(barf_weights(37, 100, f, device="cuda"), f) for f in pe)
    return {"params": _field(fcfg, seed=10 + seed), "x": x, "d": d, "n_blocks": fcfg.n_blocks,
            "pe": pe, "pe_masks": masks, "warp": pack_warp(pose) if warped else None,
            "pose": pose if warped else None}


def phase_kernels(star_cfg, n_rand):
    """Each kernel against its plain version at the shapes one online step
    gives it, with both timed; returns the JSON kernel rows (launches filled
    in later). A row's ms and plain_ms sum the six calls of one online step."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm, parity

    worst = dict.fromkeys(("fwd", "fwd_rms", "w", "pose", "fwd_abs", "grad_abs"), 0.0)
    step_ms = {"fwd": 0.0, "plain_fwd": 0.0, "bwd": 0.0, "plain_bwd": 0.0}
    for i, case in enumerate(kernel_cases(star_cfg, n_rand)):
        name, fcfg, _, _, _, calls = case
        inp = case_inputs(star_cfg, case, i)
        errs, run = parity.compare(**inp)
        torch.cuda.synchronize()
        print(f"kernel-vs-plain {name} {fcfg.depth}x{fcfg.width} N={inp['x'].shape[0]}: "
              + ", ".join(f"{k} {errs[k]:.3e} (limit {lim})" for k, lim in parity.LIMITS.items()
                          if k in errs), flush=True)
        for k in worst:
            worst[k] = max(worst[k], errs.get(k, 0.0))
        _require(not parity.failures(errs), f"{name}: kernel vs plain: {parity.failures(errs)}")

        if calls:
            def kernel():
                a, r = fm.fused_field_apply(inp["params"], inp["x"], inp["d"], inp["n_blocks"],
                                            inp["pe"], pe_masks=inp["pe_masks"], warp=inp["warp"])
                return torch.cat([a[:, None], r], -1)

            def plain():
                return fm.fused_mlp_plain(inp["x"], inp["d"],
                                          fm.flatten_params(inp["params"], inp["n_blocks"]),
                                          inp["n_blocks"], inp["pe"], warp=inp["warp"],
                                          masks=inp["pe_masks"])

            # plain, kernel, kernel, plain: each side timed twice, in turns
            t = {k: [] for k in step_ms}
            for order in (("plain", "kernel"), ("kernel", "plain")):
                for side in order:
                    fwd, out = (kernel, run["out_k"]) if side == "kernel" else (plain, run["out_p"])
                    prefix = "" if side == "kernel" else "plain_"
                    with torch.no_grad():
                        t[prefix + "fwd"].append(_cuda_ms(fwd, 3))
                    t[prefix + "bwd"].append(_cuda_ms(
                        lambda: torch.autograd.grad(out, run["leaves"], run["cot"],
                                                    retain_graph=True), 3))
            t = {k: statistics.mean(v) for k, v in t.items()}
            for k, v in t.items():
                step_ms[k] += calls * v
            print(f"time {name} {fcfg.depth}x{fcfg.width} N={inp['x'].shape[0]}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)
        del inp, run
        torch.cuda.empty_cache()
    print("time of the six field calls of one online step: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms.items()), flush=True)

    src = "startrax_torch/kernels/csrc/fused_mlp.cu"
    lim = parity.LIMITS
    return [
        {"name": "fused_mlp_fwd", "route": "cuda", "source": src,
         "replaces": "startrax/kernels/fused_mlp.py:291", "launches": 0,
         "max_abs_err": worst["fwd_abs"], "max_scaled_err": worst["fwd"], "tol": lim["fwd"],
         "rms_scaled_err": worst["fwd_rms"], "tol_rms": lim["fwd_rms"],
         "ms": step_ms["fwd"], "plain_ms": step_ms["plain_fwd"]},
        {"name": "fused_mlp_bwd", "route": "cuda", "source": src,
         "replaces": "startrax/kernels/fused_mlp.py:343", "launches": 0,
         "max_abs_err": worst["grad_abs"], "max_scaled_err": worst["w"], "tol": lim["w"],
         "max_pose_rel_err": worst["pose"], "tol_pose": lim["pose"],
         "ms": step_ms["bwd"], "plain_ms": step_ms["plain_bwd"]},
    ]


def _batch(n_rand):
    """bench.py's fixed batch: normal origins, unit directions, uniform target."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    rays_o = rng.normal(size=(n_rand, 3)).astype(np.float32)
    rays_d = rng.normal(size=(n_rand, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    return {"rays_o": torch.tensor(rays_o, device="cuda"),
            "rays_d": torch.tensor(rays_d, device="cuda"),
            "target": torch.tensor(target, device="cuda"), "frame": FRAME}


def _online(star_cfg, loss_cfg, cfg, seed):
    import torch

    from startrax_torch.train import loop, optim

    params = loop.init_online_params(
        star_cfg, cfg.num_frames, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    # as bench.py builds it: three LR groups, milestone decay at epoch 60, clip 1.0
    opt = optim.make_fused_star_optimizer(params, lrate_static=cfg.lrate_static,
                                          lrate_dynamic=cfg.lrate_dynamic,
                                          lrate_pose=cfg.lrate_pose, steps_per_epoch=100,
                                          decay_milestones=cfg.lrate_decay_steps, grad_clip=1.0)
    return params, opt, loop.make_online_train_step(star_cfg, loss_cfg, opt)


def _timed_steps(step, n, *args, **kw):
    import torch

    losses, ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = step(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    return losses, ms


def phase_main_path(cfg, star_cfg, loss_cfg):
    import dataclasses

    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.models.star import render_star
    from startrax_torch.train import loop, optim

    batch = _batch(cfg.N_rand)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params, opt, step = _online(star_cfg, loss_cfg, cfg, seed=0)
    app_opt = optim.make_appinit_optimizer(params["nerf"], lrate=cfg.lrate)
    app_step = loop.make_appinit_train_step(star_cfg, loss_cfg, app_opt)

    fm.reset_launch_counts()
    app_losses, app_ms = _timed_steps(app_step, N_APPINIT, params["nerf"], batch, generator=gen)
    after_app = dict(fm.launches)
    losses, ms = _timed_steps(step, N_ONLINE, params, batch, epoch=0, generator=gen)
    counts = dict(fm.launches)
    print(f"app-init losses {app_losses}", flush=True)
    print(f"online losses {losses}", flush=True)
    print(f"launches after {N_APPINIT} app-init steps {after_app}, after {N_ONLINE} online "
          f"steps {counts}", flush=True)
    _require(after_app == {"fwd": 2 * N_APPINIT, "bwd": 2 * N_APPINIT},
             f"2 launches of each kernel per app-init step, got {after_app}")
    _require(counts == {"fwd": 2 * N_APPINIT + 6 * N_ONLINE, "bwd": 2 * N_APPINIT + 6 * N_ONLINE},
             f"6 launches of each kernel per online step, got {counts}")
    _require(all(math.isfinite(v) for v in app_losses + losses), "finite losses")
    _require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]), "the loss falls")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_ms = statistics.median(ms[2:])
    print(f"kernel path: median online step {kernel_ms:.3f} ms (steps 3-{N_ONLINE}), "
          f"app-init step {statistics.median(app_ms):.3f} ms, "
          f"{cfg.N_rand / kernel_ms * 1e3:.1f} rays/s, peak memory {peak_gb:.2f} GB",
          flush=True)

    # where the time goes: one profiled online step, kernel time by name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, batch, epoch=0, generator=gen)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)

    # the same batch through the kernel path and the plain path at a small size
    small = {k: (v[:64] if torch.is_tensor(v) else v) for k, v in batch.items()}
    plain_cfg = dataclasses.replace(star_cfg, use_fused=False)
    u_strat = torch.rand((64, star_cfg.n_samples), generator=gen, device="cuda")
    u_pdf = torch.rand((64, star_cfg.n_importance), generator=gen, device="cuda")
    pose = loop.gather_frame_pose(params["poses"], FRAME, star_cfg.num_vehicles)
    with torch.no_grad():
        outs = [render_star(params["nerf"], c, small["rays_o"], small["rays_d"], pose=pose,
                            u_strat=u_strat, u_pdf=u_pdf) for c in (star_cfg, plain_cfg)]
    for k in ("rgb0", "rgb"):
        _require(outs[0][k].shape == (64, 3) and bool(torch.isfinite(outs[0][k]).all()),
                 f"render {k}: finite [64, 3]")
        err = float((outs[0][k] - outs[1][k]).abs().max())
        print(f"render {k}: kernel path vs plain path max abs err {err:.3e} (tol 2e-2)",
              flush=True)
        _require(err <= 2e-2, f"render {k}: kernel path vs plain path")
    after = dict(fm.launches)
    del params, opt, step, app_opt, app_step, outs
    torch.cuda.empty_cache()

    # the plain path (use_fused=False), same shapes
    params, opt, step = _online(plain_cfg, loss_cfg, cfg, seed=0)
    plain_losses, plain_ms = _timed_steps(step, N_PLAIN, params, batch, epoch=0, generator=gen)
    plain_med = statistics.median(plain_ms[1:])
    print(f"plain path: losses {plain_losses}, median online step {plain_med:.3f} ms "
          f"(steps 2-{N_PLAIN}), {cfg.N_rand / plain_med * 1e3:.1f} rays/s", flush=True)
    _require(dict(fm.launches) == after, "the plain path launches no kernel")
    del params, opt, step
    torch.cuda.empty_cache()
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from startrax.utils.config import Config, parse_config_file
    from startrax_torch.kernels import build, fused_mlp as fm
    from startrax_torch.utils.config import loss_config_from, star_config_from

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, TF32 off", flush=True)

    t0 = time.perf_counter()
    fm.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds['fused_mlp']:.2f} s)", flush=True)

    cfg = Config(**parse_config_file(
        os.path.join(here, "startrax", "configs", "carla_star_online_multi.txt")))
    star_cfg, loss_cfg = star_config_from(cfg), loss_config_from(cfg)
    print(f"config: K={star_cfg.num_vehicles} {star_cfg.netdepth}x{star_cfg.netwidth} "
          f"samples {star_cfg.n_samples}+{star_cfg.n_importance} N_rand {cfg.N_rand} "
          f"near {star_cfg.near} far {star_cfg.far} compute {star_cfg.compute_dtype}", flush=True)

    rows = phase_kernels(star_cfg, cfg.N_rand)
    counts = phase_main_path(cfg, star_cfg, loss_cfg)
    rows[0]["launches"], rows[1]["launches"] = counts["fwd"], counts["bwd"]
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
