#!/usr/bin/env python3
"""Digests of the fused-MLP kernels' outputs and grads on the GEMM core's
cases, from one tree's kernels: the record that
``tests/test_torch_cuda.py::test_gemm_core_matches_the_parent_kernel_bit_for_bit``
holds the kernels to.

    python3 scripts/torch_kernel_digests.py ROOT --json PATH [--tree TEXT]

ROOT is the root of a checkout of the repository, for example the parent
commit unpacked with ``git archive`` into ``runs/parent``. The script puts
ROOT's ``startrax_torch`` first on the path, imports this checkout's
``tests/test_torch_cuda.py`` (whose ``core_case`` makes each case's inputs
from its seed and runs it), and writes, for every case of ``CORE_INSTANCES``
x widths 128 and 256 x ``CORE_N`` x trained and forward-only, and for the
grid update's forward (``UPDATE_KEY``), the sha256 of each group of tensors
(``digests``) to PATH, with the card's name and
power limit and TEXT (what the tree is) beside them. Needs one CUDA card
and nvcc.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    args = sys.argv[1:]
    opts = {}
    for flag in ("--json", "--tree"):
        if flag in args:
            i = args.index(flag)
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    if len(args) != 1 or "--json" not in opts:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(args[0])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_digests: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    from startrax_torch.kernels import fused_mlp

    if not os.path.abspath(fused_mlp.__file__).startswith(root + os.sep):
        raise RuntimeError(f"startrax_torch comes from {fused_mlp.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cases = {}
    for instance in tests.CORE_INSTANCES:
        for width in (128, 256):
            for n in tests.CORE_N:
                for save in (True, False):
                    key = tests.core_case_key(instance, width, n, save)
                    cases[key] = tests.core_digests(instance, width, n, save)
    cases[tests.UPDATE_KEY] = tests.digests(tests.update_case())
    torch.cuda.synchronize()
    report = {"tree": opts.get("--tree", root), "card": card, "torch": torch.__version__,
              "cases": cases}
    path = opts["--json"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(report, fp, indent=1, sort_keys=True)
    print(f"torch_kernel_digests: {len(cases)} cases of {root} on {card} -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
