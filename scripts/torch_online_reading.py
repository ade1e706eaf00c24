#!/usr/bin/env python3
"""A long reading of the port's online app on the card, at full depth.

    python3 scripts/torch_online_reading.py [--config synthetic_star_online.txt]
        [--minutes 10] [--appinit_minutes 2] [--json online_reading.json]
        [--modes nosync[,sync,...]] [--test] [-- ONLINE_ARGS]

Runs a config's two stages (--config: a file of startrax/configs or a path)
through their entry points, unchanged but for the time budgets and the run
directories: appearance init (python -m startrax_torch.apps.app_init,
--train_minutes appinit_minutes), then online tracking warm-started from its
last checkpoint (python -m startrax_torch.apps.online, --train_minutes
minutes; ONLINE_ARGS, flags of the app, are added to its command line);
with --test, then the test protocol on the first online run's final
checkpoint (--test true). It prints, and writes to --json: the card's name
and power limit, each stage's wall time, the online epochs with their
phase, fine loss, window, pose errors and selection score, the validations,
the polish's run.log lines (gauge fits and their decisions, multi-start,
refits, the boundary snapshots), the test protocol's rows, and the step
time by kind (per-ray batches, whose [N] frames come from the ghost and
frame-0 anchor rays or mixed frames; shared-pose batches; the gauge steps
of each layout), as the median interval between the starts of consecutive
steps of one epoch on the host clock. The app reads the device once an
epoch, so in steady state that interval is the step's time as the app runs
it ("nosync"). --modes runs the online stage once a mode, in turns, from the
same checkpoint: "sync" waits for the card after every step, to read what a
per-step sync does to the step.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "startrax", "configs")
# run.log lines of the polish that the reading keeps
POLISH_LINES = ("gauge_align", "multi_start", "refit_anchor", "boundary best", "restoring",
                "curriculum", "training stopped")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="synthetic_star_online.txt")
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--appinit_minutes", type=float, default=2.0)
    ap.add_argument("--json", default="")
    ap.add_argument("--modes", default="nosync")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("online_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    args.online_args = [a for a in args.online_args if a != "--"]
    if not set(args.modes.split(",")) <= {"nosync", "sync"}:
        ap.error(f"--modes takes nosync and sync, got {args.modes}")

    import torch

    if not torch.cuda.is_available():
        print("torch_online_reading: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="online_reading_")
    try:
        return _run(args, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, card, tmp):
    from startrax_torch.apps import app_init, online
    from startrax_torch.train import loop
    from startrax_torch.utils.config import load_config

    config = (args.config if os.path.exists(args.config)
              else os.path.join(CONFIGS, args.config))
    common = ["--config", config, "--basedir", os.path.join(tmp, "runs"), "--synth_cache_dir",
              os.path.join(tmp, "cache")]
    cfg = load_config(common)

    t0 = time.perf_counter()
    app_init.main(common + ["--train_minutes", str(args.appinit_minutes)])
    appinit_s = time.perf_counter() - t0
    app_dir = os.path.join(tmp, "runs", cfg.expname, "app_init")
    app_rows = [json.loads(line) for line in open(os.path.join(app_dir, "metrics.jsonl"))]

    runs = [_online(args, online, loop, common, app_dir, os.path.join(tmp, f"online{i}"),
                    cfg, mode) for i, mode in enumerate(args.modes.split(","))]
    test = None
    if args.test:
        t0 = time.perf_counter()
        online.main(common + ["--basedir", runs[0]["basedir"], "--test", "true",
                              "--online_ckpt_path", runs[0]["run_dir"] + "/ckpts"])
        test_dir = os.path.join(runs[0]["basedir"], cfg.expname, "online_test")
        test = {"seconds": time.perf_counter() - t0, "rows": [
            {k: v for k, v in json.loads(line).items() if k.startswith("test/") or k == "step"}
            for line in open(os.path.join(test_dir, "metrics.jsonl"))]}
    out = {"card": card, "config": config,
           "appinit": {"seconds": appinit_s,
                       "fine_loss": [r["train/fine_loss"] for r in app_rows
                                     if "train/fine_loss" in r],
                       "val_psnr": [r["val/psnr"] for r in app_rows if "val/psnr" in r]},
           "online": runs[0] if len(runs) == 1 else runs, "test": test}
    print(f"app_init: {appinit_s:.1f} s, fine loss {out['appinit']['fine_loss']}, val PSNR "
          f"{out['appinit']['val_psnr']}", flush=True)
    for run in runs:
        print(f"online ({run['mode']}): {run['seconds']:.1f} s, {run['steps']} steps, "
              f"{len(run['epochs'])} epochs; step median by kind (ms) {run['step_ms_median']} "
              f"over {run['steps_by_kind']} intervals", flush=True)
        for h in run["epochs"]:
            print(f"  {h}", flush=True)
        for v in run["validations"]:
            print(f"  {v}", flush=True)
        for line in run["polish_log"]:
            print(f"  {line}", flush=True)
    if test is not None:
        summary = {}
        for r in test["rows"]:
            for k, v in r.items():
                if k != "step" and "frame_" not in k:
                    summary[k] = v
        print(f"test protocol: {test['seconds']:.1f} s; {summary}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(f"card: {card}")
    return 0


def _online(args, online, loop, common, app_dir, basedir, cfg, mode):
    """One online run from the app-init checkpoint, its steps recorded;
    "sync" waits for the card after every step."""
    import torch

    from chip_smoke import _patched

    starts = []  # (host clock, epoch, kind) at each step's call
    place = {"epoch": -1, "gauge": 0}  # a gauge step's epoch: after the last online step's

    def recording(step):
        def recorded(params, batch, epoch=0, **k):
            place.update(epoch=int(epoch), gauge=0)
            starts.append((time.perf_counter(), int(epoch), loop.batch_kind(batch)))
            out = step(params, batch, epoch=epoch, **k)
            if mode == "sync":
                torch.cuda.synchronize()
            return out

        return recorded

    def recording_gauge(step):
        def recorded(gauge, nerf, poses, batch, **k):
            epoch = place["epoch"] + 1 + place["gauge"] // cfg.steps_per_epoch
            place["gauge"] += 1
            starts.append((time.perf_counter(), epoch, "gauge_" + loop.batch_kind(batch)))
            out = step(gauge, nerf, poses, batch, **k)
            if mode == "sync":
                torch.cuda.synchronize()
            return out

        return recorded

    argv = common + ["--basedir", basedir, "--train_minutes", str(args.minutes),
                     "--appearance_ckpt_path", os.path.join(app_dir, "ckpts"), *args.online_args]
    t0 = time.perf_counter()
    with (_patched(loop, "make_online_train_step", recording),
          _patched(loop, "make_gauge_train_step", recording_gauge)):
        online.main(argv)
    seconds = time.perf_counter() - t0

    run_dir = os.path.join(basedir, cfg.expname, "online")
    history = json.load(open(os.path.join(run_dir, "history.json")))
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    periods = {}
    for (t, e, kind), (t_next, e_next, _) in zip(starts, starts[1:]):
        if e == e_next:
            periods.setdefault(kind, []).append((t_next - t) * 1e3)
    polish_log = [line.split(" INFO ")[-1] for line in open(os.path.join(run_dir, "run.log"))
                  if any(w in line for w in POLISH_LINES)]
    return {"mode": mode, "argv": argv, "basedir": basedir, "run_dir": run_dir,
            "seconds": seconds, "steps": len(starts), "epochs": history,
            "polish_log": [line.rstrip() for line in polish_log],
            "validations": [{k: v for k, v in r.items() if k.startswith("val/")}
                            | {"step": r["step"]} for r in rows if "val/psnr" in r],
            "step_ms_median": {k: statistics.median(v) for k, v in periods.items()},
            "steps_by_kind": {k: len(v) for k, v in periods.items()}}


if __name__ == "__main__":
    sys.exit(main())
