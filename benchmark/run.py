#!/usr/bin/env python3
"""Run one cell of the benchmark of startrax_torch once, on one GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's "workloads"; its traffic is
benchmark/workloads/<cell>.json, its configuration
benchmark/configs/<config>.json. Set-up makes the weights, poses and a pool
of batches with their draws and the optimizer's resumed state from the
seed on the card, builds the step the workload names
(benchmark/steps/<step>.py) as the app builds it, runs its first three
steps (the ones the check compares) and a few more, so that every shape is
warm. The window then issues steps back to back for
--seconds, as the apps train: no synchronisation between steps, a CUDA
event recorded after each, one synchronize at the end.

--trace 0 prints the cell's end-to-end metrics: rays_per_s (every ray of
every step issued in the window over the time to the synchronize that ends
it), step_ms_p95 (the 95th percentile of the steps' intervals between
their events) and setup_s (process start to the window's start).
--trace 1 prints its per-layer metrics: the same window, with the
process's CPU time taken around each step call, then a profiled stretch
(torch.profiler) whose readers are benchmark/metrics/<metric>.py.

After the window the program's state is freed and the step's reference
(benchmark/reference/<step>.py) runs the first three steps again on the
same inputs, from the same resumed optimizer state, in float32; check.py
compares them. The last lines on standard error, and the "checks" key last
in the result, give each number compared beside its limit. The last line
on standard output is the result, one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, inputs, trace  # noqa: E402

# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "startrax")
CHECKED_STEPS = 3


def load_cell(name: str):
    """(BENCHMARK.json, the cell's entry there or None, its workload file,
    its configuration file, which the workload file names)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "workloads", name + ".json")) as fp:
        workload = json.load(fp)
    with open(os.path.join(here, "configs", workload["config"] + ".json")) as fp:
        config = json.load(fp)
    return bench, entry, workload, config


def metrics_of(bench: Dict, section: str, cell: str) -> List[Dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def kind_of(workload: Dict):
    """(the step's module under steps/, its reference's under reference/),
    by the name the workload's "step" gives."""
    name = workload["step"]
    return (importlib.import_module(f"benchmark.steps.{name}"),
            importlib.import_module(f"benchmark.reference.{name}"))


def first_steps(prog, batches) -> Dict:
    """The program's first CHECKED_STEPS steps on the pool's first batches:
    each step's loss, each leaf's gradient at the first step (the leaves'
    .grad after it, as the optimizer read it) and each leaf's change over
    the steps (its value before the fourth step against the benchmark's
    input), in float32 on the CPU."""
    import torch

    start = {n: t.detach().clone() for n, t in prog.leaves.items()}
    losses, grads = [], None
    for i in range(CHECKED_STEPS):
        losses.append(prog.step(batches[i]))
        if i == 0:
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                     .to("cpu", torch.float32, copy=True) for n, p in prog.leaves.items()}
    changes = {n: (p.detach() - start[n]).to("cpu", torch.float32)
               for n, p in prog.leaves.items()}
    return {"losses": [float(v) for v in torch.stack(losses).tolist()], "grads": grads,
            "changes": changes}


def end_to_end(steps: int, rays: int, elapsed_s: float, step_ms: List[float],
               setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics of a window of ``steps`` steps of ``rays``
    rays that took ``elapsed_s`` to its closing synchronize, the steps'
    intervals ``step_ms``."""
    p95 = statistics.quantiles(step_ms, n=20)[18] if len(step_ms) > 1 else step_ms[0]
    return {"rays_per_s": steps * rays / elapsed_s, "step_ms_p95": p95, "setup_s": setup_s}


class Stages:
    """Seconds from the process's start to the end of each stage of set-up,
    the card synchronized at each mark."""

    def __init__(self, on_card: bool, t_start: float):
        self.on_card, self.t_start, self.marks = on_card, t_start, []

    def mark(self, name: str) -> float:
        if self.on_card:
            import torch

            torch.cuda.synchronize()
        t = time.perf_counter() - self.t_start
        self.marks.append((name, t))
        return t

    def __str__(self) -> str:
        return ", ".join(f"{n} {t:.3f}" for n, t in self.marks)


class Context:
    """What a per-layer metric's reader reads: the traced stretch
    (trace.Trace), the unprofiled stretch's mean step time and host CPU time
    a step (seconds), and the step's fused calls (work.FieldCall)."""

    def __init__(self, tr, step_s: float, host_cpu_s: float, calls):
        self.trace, self.step_s, self.host_cpu_s, self.calls = tr, step_s, host_cpu_s, calls


def _window(prog, batches, at: int, seconds: float, cpu: bool):
    """Steps issued back to back for ``seconds``: (steps, seconds to the
    closing synchronize, the steps' intervals in ms, their losses, and with
    ``cpu`` the process's CPU seconds a step call, every thread's: the loop
    thread's and the autograd engine's, which runs a CUDA backward)."""
    import torch

    P = len(batches)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    events, losses, thread = [], [], 0.0
    ev0.record()
    t0 = time.perf_counter()
    while True:
        c0 = time.process_time() if cpu else 0.0
        losses.append(prog.step(batches[(at + len(events)) % P]))
        if cpu:
            thread += time.process_time() - c0
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    marks = [ev0] + events
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return len(events), elapsed, ms, losses, (thread / len(events) if cpu else None)


def run(args, bench: Dict, entry: Dict, workload: Dict, config: Dict, device,
        plant: Optional[Callable] = None, stages: Optional[Stages] = None) -> Dict:
    """One run of the cell on ``device``; returns the result's fields and
    the check's readings. ``plant(prog)`` breaks the program's step for the
    harness's own tests (benchmark/tests), and is None in every run of the
    benchmark; ``stages`` holds the set-up's marks so far."""
    import torch

    flags = {**config["flags"], **config.get("stages", {}).get(workload.get("stage"), {})}
    on_card = torch.device(device).type == "cuda"
    stages = stages or Stages(on_card, time.perf_counter())
    feed = inputs.make(flags, workload, args.seed, device)
    stages.mark("inputs")
    kind, reference = kind_of(workload)
    prog = kind.build(flags, workload, feed.params, feed.resume)
    stages.mark("build")
    if plant is not None:
        plant(prog)
    first = first_steps(prog, feed.batches)
    stages.mark("checked steps")
    P, at = len(feed.batches), CHECKED_STEPS
    for _ in range(workload["warmup_steps"]):
        prog.step(feed.batches[at % P])
        at += 1
    setup_s = stages.mark("warm-up")
    print(f"set-up by stage (s): {stages}", file=sys.stderr)

    out = {"metrics": {}, "breakdown": None}
    if on_card:
        n, elapsed, ms, losses, cpu = _window(prog, feed.batches, at, args.seconds,
                                              cpu=bool(args.trace))
    else:  # the harness's tests on the CPU: the window's steps, untimed
        losses = [prog.step(feed.batches[(at + i) % P]) for i in range(2)]
        n, elapsed, ms, cpu = len(losses), 1.0, [1.0] * len(losses), 0.0
    at += n
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    print(f"steps in the window: {n} in {elapsed:.3f} s; card: {card_line() if on_card else '-'}",
          file=sys.stderr)
    if not args.trace:
        values = end_to_end(n, feed.rays, elapsed, ms, setup_s)
        for m in metrics_of(bench, "end_to_end", args.workload):
            out["metrics"][m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    elif on_card:
        steps_traced = workload["traced_steps"]
        tr = trace.profile(lambda i: prog.step(feed.batches[(at + i) % P]), steps_traced)
        ctx = Context(tr, elapsed / n, cpu, kind.calls(flags, workload))
        for m in metrics_of(bench, "per_layer", args.workload):
            value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    out["attempted"], out["failed"] = n, failed
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    del prog, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference.run_steps(flags, workload, feed.params, feed.batches[:CHECKED_STEPS],
                              CHECKED_STEPS, feed.resume)
    out["readings"] = check.readings(first, ref)
    out["clip_norms"] = ref["clip_norms"]
    out["correct"] = failed == 0 and check.judge(out["readings"], workload["limits"])
    return out


def result_line(out: Dict, entry: Dict, workload: Dict, kind: str, traced: int) -> Dict:
    """The result's JSON object from run()'s fields, the check's numbers
    beside their limits under "checks", last."""
    limits = workload["limits"]
    checks = {k: {"value": out["readings"][k], "limit": lim} for k, lim in limits.items()}
    checks["failed_steps"] = {"value": out["failed"], "limit": 0}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": kind, "count": entry["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if traced:
        result["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench, entry, workload, config = load_cell(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    stages = Stages(False, T0)
    stages.mark("imports")
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    stages.on_card = True
    stages.mark("the card")
    out = run(args, bench, entry, workload, config, device, stages=stages)
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded: {found}", file=sys.stderr)
        return 3
    result = result_line(out, entry, workload, torch.cuda.get_device_name(device), args.trace)
    checks = result["checks"]
    beside = {k: v for k, v in out["readings"].items() if k not in checks}
    print(f"readings beside the check (not compared): {beside}; the reference's global "
          f"gradient norms at its updates (the clip's input): {out['clip_norms']}",
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
