#!/usr/bin/env python3
"""Where a benchmark cell's training step spends its host time, by span
(startrax_torch.utils.profiling.span), on one card.

    python3 scripts/torch_span_table.py --workload <cell> --seed <n> [--json PATH]

Builds the cell's program from the seed as benchmark/run.py does (its
inputs, its step, the warm-up steps), then profiles the cell's traced
steps with benchmark/trace.py and prints, for every span name the trace
holds:

- host ms a step: the wall time inside the spans of that name (summed over
  the threads that open them);
- launches a step: the CUDA runtime's kernel-launch calls that start inside
  a span of that name, by time, whichever thread made them;
- idle ms a step: the gaps between device operations, each given to the
  innermost span open (on any thread) when it began, "(no span)" where none
  was.

Then the share of the launch calls that start inside a ``train.step``; each
host sync (benchmark/metrics/_spans.SYNCS) started inside a step, by the
innermost span and the four innermost host operations (not spans, not
runtime calls) open when it began, a step; the device records named like a span;
and the traced stretch's seconds a step. One JSON object a line on
standard output, and with ``--json`` the same object in PATH.
"""

import argparse
import bisect
import json
import os
import sys
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import inputs, run, trace  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402

SPAN_PREFIXES = ("train.", "render.", "optim.", "fused_mlp.", "data.")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


class _Spans:
    """The trace's spans by name, each name's intervals sorted by start."""

    def __init__(self, host):
        by_name = defaultdict(list)
        for name, a, b in host:
            if name.startswith(SPAN_PREFIXES):
                by_name[name].append((a, b))
        self.by_name = {n: sorted(v) for n, v in by_name.items()}
        self.starts = {n: [a for a, _ in v] for n, v in self.by_name.items()}

    def covering(self, name, t):
        """The interval of ``name`` open at ``t``, or None (spans of one
        name on two threads may overlap: the few before ``t`` are looked
        at)."""
        v = self.by_name[name]
        i = bisect.bisect_right(self.starts[name], t)
        for a, b in reversed(v[max(i - 8, 0):i]):
            if b > t:
                return a, b
        return None

    def innermost(self, t):
        """The name of the shortest span open at ``t``, or "(no span)"."""
        best = (None, "(no span)")
        for name in self.by_name:
            hit = self.covering(name, t)
            if hit and (best[0] is None or hit[1] - hit[0] < best[0]):
                best = (hit[1] - hit[0], name)
        return best[1]


def _gaps(ops):
    """(start ns, length ns) of every gap between device operations."""
    out, end = [], None
    for _, a, b, _ in sorted(ops, key=lambda o: o[1]):
        if end is not None and a > end:
            out.append((end, a - end))
        end = b if end is None else max(end, b)
    return out


def table(tr: trace.Trace):
    """The readings of the module docstring from a traced stretch."""
    spans, steps = _Spans(tr.host), tr.steps
    launches = [a for n, a, _ in tr.host if n in LAUNCHES]
    rows = {}
    for name, v in sorted(spans.by_name.items()):
        rows[name] = {"spans_per_step": len(v) / steps,
                      "host_ms": sum(b - a for a, b in v) / 1e6 / steps,
                      "launches": sum(1 for t in launches if spans.covering(name, t)) / steps,
                      "idle_ms": 0.0}
    idle = Counter()
    for t, g in _gaps(tr.ops):
        idle[spans.innermost(t)] += g
    for name, ns in idle.items():
        rows.setdefault(name, {"host_ms": None, "launches": None})["idle_ms"] = ns / 1e6 / steps
    in_step = sum(1 for t in launches if "train.step" in spans.by_name
                  and spans.covering("train.step", t))
    syncs = Counter()
    others = [h for h in tr.host if not h[0].startswith(SPAN_PREFIXES + ("cu",))]
    for name, a, _ in tr.host:
        if name in _spans.SYNCS and "train.step" in spans.by_name \
                and spans.covering("train.step", a):
            ops = sorted((s - e, n) for n, s, e in others if s <= a < e)  # outermost first
            chain = " > ".join(n for _, n in ops[-4:]) or "-"
            syncs[f"{spans.innermost(a)} / {chain} / {name}"] += 1
    span_names = set(spans.by_name)
    return {"steps": steps, "window_s_per_step": tr.window_s / steps,
            "busy_ms_per_step": tr.busy_s() * 1e3 / steps, "spans": rows,
            "launch_calls_per_step": len(launches) / steps,
            "launch_calls_in_train_step": in_step / max(len(launches), 1),
            "syncs_per_step": {k: v / steps for k, v in syncs.items()},
            "device_records_named_like_a_span": sum(1 for o in tr.ops if o[0] in span_names)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--json")
    args = p.parse_args(argv)

    import torch

    bench, entry, workload, config = run.load_cell(args.workload)
    flags = {**config["flags"], **config.get("stages", {}).get(workload.get("stage"), {})}
    device = torch.device("cuda", 0)
    feed = inputs.make(flags, workload, args.seed, device)
    kind, _ = run.kind_of(workload)
    prog = kind.build(flags, workload, feed.params, feed.resume)
    P = len(feed.batches)
    for i in range(workload["warmup_steps"] + run.CHECKED_STEPS):
        prog.step(feed.batches[i % P])
    at = workload["warmup_steps"] + run.CHECKED_STEPS
    tr = trace.profile(lambda i: prog.step(feed.batches[(at + i) % P]), workload["traced_steps"])
    out = {"workload": args.workload, "seed": args.seed, "card": run.card_line(),
           **table(tr)}
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump(out, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
