#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and what they cost, on one card.

    python3 scripts/torch_gloo_cuda.py [--world 2] [--json PATH]

Spawns ``--world`` ranks on cuda:0 through startrax_torch.parallel.mesh's
run_ranks with the gloo backend (NCCL refuses two ranks on one device) and
tries all_reduce, broadcast, all_gather, broadcast_object_list and barrier on
CUDA tensors, checking each result against the one the ranks' inputs give;
times all_reduce of a float32 vector of 1 MB and of the online app's grad
vector (CUDA events, median of 20); then checks that a collective that one
rank never joins fails by the group's timeout, and that nccl with more ranks
than cards raises before it makes a group. Prints one JSON object last.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HANG_TIMEOUT = 10.0
GRAD_ELEMENTS = 1_234_567  # about the online app's flat grad at 8x128 / 4x128, K = 2


def _try(name, fn, out):
    try:
        fn()
        out[name] = "ok"
    except Exception as exc:  # recorded: the point is which ones raise
        out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


def _collectives(group):
    import torch
    import torch.distributed as dist

    dev, r, w = group.device, group.rank, group.world
    out = {"device": str(dev)}

    def all_reduce():
        t = torch.full((1000,), float(r + 1), device=dev)
        group.all_reduce(t)
        assert t.is_cuda and torch.all(t == w * (w + 1) / 2), t[:4]

    def broadcast():
        t = torch.full((1000,), float(r), device=dev)
        dist.broadcast(t, src=0)
        assert t.is_cuda and torch.all(t == 0.0)

    def all_gather():
        t = torch.full((3, 2), float(r), device=dev)
        g = group.all_gather_rows(t)
        assert g.is_cuda and g.shape == (3 * w, 2)
        assert all(torch.all(g[3 * i:3 * i + 3] == i) for i in range(w))

    def broadcast_object():
        assert group.broadcast_object({"rank": r})["rank"] == 0

    _try("all_reduce", all_reduce, out)
    _try("broadcast", broadcast, out)
    _try("all_gather", all_gather, out)
    _try("broadcast_object_list", broadcast_object, out)
    _try("barrier", group.barrier, out)
    for label, n in (("all_reduce_1MB", 262_144), ("all_reduce_grad", GRAD_ELEMENTS)):
        t = torch.ones(n, device=dev)
        times = []
        for _ in range(25):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            group.barrier()
            a.record()
            group.all_reduce(t)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times = sorted(times[5:])
        out[label + "_ms"] = times[len(times) // 2]
    return out


def _hang(group):
    import torch

    t = torch.ones(4, device=group.device)
    if group.rank == 0:
        start = time.monotonic()
        try:
            group.all_reduce(t)
            return {"raised": False}
        except Exception as exc:  # the timeout under test
            return {"raised": True, "after_s": time.monotonic() - start,
                    "error": type(exc).__name__}
    time.sleep(HANG_TIMEOUT + 5)  # never joins the collective
    return {"raised": None}


def _nccl_two_on_one(_group):
    return "made a group"


def main():
    import torch

    from startrax_torch.parallel import mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__}
    t0 = time.perf_counter()
    res["ranks"] = mesh.run_ranks(_collectives, args.world, "gloo", device="cuda:0",
                                  timeout=60.0, join_timeout=300.0)
    res["spawn_and_collectives_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["hang"] = mesh.run_ranks(_hang, 2, "gloo", device="cuda:0", timeout=HANG_TIMEOUT,
                                 join_timeout=120.0)[0]
    res["hang_s"] = time.perf_counter() - t0
    try:
        mesh.run_ranks(_nccl_two_on_one, torch.cuda.device_count() + 1, "nccl",
                       timeout=30.0, join_timeout=120.0)
        res["nccl_more_ranks_than_cards"] = "no error"
    except RuntimeError as exc:
        res["nccl_more_ranks_than_cards"] = [ln for ln in str(exc).splitlines()
                                             if "RuntimeError" in ln][-1:]
    for k, v in res.items():
        print(f"{k}: {v}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
