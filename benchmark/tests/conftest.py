"""Fixtures of the benchmark's own tests: its cells cut to a size the CPU
runs in a second (widths 16, 16 rays of 8 + 8 samples), and the card."""

import copy
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every workload file, those BENCHMARK.json lists and those it leaves out
CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "workloads")))
TINY = dict(netwidth=16, netwidth_fine=16, N_rand=16, N_samples=8, N_importance=8)


def tiny_cell(name, **flags):
    """(bench, entry, workload, config, args) of a cell at TINY size, with
    further flags; the workload's pool of 4 batches, one warm-up step."""
    from benchmark.run import load_cell

    bench, entry, workload, config = load_cell(name)
    entry = entry or {"name": name, "config": workload["config"], "chips": 1}
    config = copy.deepcopy(config)
    config["flags"].update(TINY, **flags)
    workload = dict(workload, pool=4, warmup_steps=1)
    args = types.SimpleNamespace(workload=name, seed=2**31 + 11, seconds=1.0, trace=0)
    return bench, entry, workload, config, args


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernels have no CPU mode")
    return torch.device("cuda", 0)
