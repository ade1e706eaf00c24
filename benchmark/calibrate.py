#!/usr/bin/env python3
"""Readings for the check's limits, at a cell's own size on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control 3 \
        --faults half_batch,sum_for_mean --fault-seeds 3 [--first-seed N] [--json PATH]

For each seed: the program's first three steps against the float32
reference (the lower readings: sound runs); for the first --control
seeds, the reference computed with float8 products (reference/star.py,
"fp8") against the float32 one (the control); for the first --fault-seeds
seeds, the program with each planted fault (faults.py) against the
reference. Every reading of check.py is kept, and each leaf's norms
(check.leaf_norms), so that another statistic can be read from the same
runs. No measured window: the readings need none. The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, faults, inputs  # noqa: E402
from benchmark.run import CHECKED_STEPS, first_steps, kind_of, load_cell  # noqa: E402


def readings(workload_name: str, seeds, control: int, fault_names, fault_seeds: int,
             device="cuda", overrides=None):
    import torch

    bench, entry, workload, config = load_cell(workload_name)
    flags = {**config["flags"], **config.get("stages", {}).get(workload.get("stage"), {})}
    if overrides:
        flags.update(overrides.get("flags", {}))
        workload = {**workload, **overrides.get("workload", {})}
    kind, reference = kind_of(workload)
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        feed = inputs.make(flags, workload, seed, device, pool=CHECKED_STEPS)

        def program(plant=None):
            prog = kind.build(flags, workload, feed.params, feed.resume)
            undo = plant(prog) if plant else None
            try:
                return first_steps(prog, feed.batches)
            finally:
                if undo:
                    undo()

        def against(got):
            leaves = check.leaf_norms(got, ref)
            return (check.from_leaves(leaves, got["losses"], ref["losses"]),
                    {"losses": got["losses"], "leaves": leaves})

        first = program()
        t1 = time.perf_counter()
        ref = reference.run_steps(flags, workload, feed.params, feed.batches, CHECKED_STEPS,
                                  feed.resume)
        t2 = time.perf_counter()
        row = {"seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1,
               "clip_norms": ref["clip_norms"], "raw": {"reference": ref["losses"]}}
        row["sound"], row["raw"]["sound"] = against(first)
        if i < control:
            ctrl = reference.run_steps(flags, workload, feed.params, feed.batches,
                                       CHECKED_STEPS, feed.resume, "fp8")
            row["control"], row["raw"]["control"] = against(ctrl)
        if i < fault_seeds:
            for name in fault_names:
                row[name], row["raw"][name] = against(program(faults.FAULTS[name]))
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "raw"}), flush=True)
        del feed, first, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summary(rows):
    """Per reading: the sound runs' largest, the control's and each fault's
    smallest."""
    out = {}
    for key in ["sound", "control"] + list(faults.FAULTS):
        got = [r[key] for r in rows if key in r]
        if got:
            agg = max if key == "sound" else min
            out[key] = {n: agg(g[n] for g in got) for n in got[0]}
            out[key]["seeds"] = len(got)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="half_batch")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--json")
    args = p.parse_args()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    names = [f for f in args.faults.split(",") if f]
    rows = readings(args.workload, seeds, args.control, names, args.fault_seeds)
    summ = summary(rows)
    print("summary (sound: largest; control and faults: smallest) "
          + json.dumps(summ), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump({"workload": args.workload, "rows": rows, "summary": summ}, fp, indent=1)


if __name__ == "__main__":
    main()
