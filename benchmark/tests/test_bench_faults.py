"""The check catches a broken step: a run of the harness on the CPU (the
look for a chip skipped) with the step broken underneath comes out not
correct, once for each fault a training step can have; the same run with
nothing planted comes out correct. The program runs its plain path in
float32 here, so that sound runs read at rounding."""

import pytest

from benchmark import faults
from benchmark.run import load_cell, result_line, run

from .conftest import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    bench, entry, workload, config, args = tiny_cell(name, mixed_precision=False)
    out = run(args, bench, entry, workload, config, "cpu")
    assert out["correct"], out["readings"]
    line = result_line(out, entry, workload, "cpu", 0)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(workload["limits"]) | {"failed_steps"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


def _faults():
    """(cell, fault): every cell's step faults, and the accumulation's where
    its optimizer accumulates."""
    out = []
    for name in CELLS:
        config = load_cell(name)[3]
        workload = load_cell(name)[2]
        flags = {**config["flags"], **config.get("stages", {}).get(workload.get("stage"), {})}
        out += [(name, f) for f in ("unchanged", "half_batch")]
        if flags.get("accumulate_grad_batches", 1) > 1:
            out.append((name, "sum_for_mean"))
    return out


@pytest.mark.parametrize("name,fault", _faults())
def test_fault_is_not_correct(name, fault):
    bench, entry, workload, config, args = tiny_cell(name, mixed_precision=False)
    undo = []
    try:
        out = run(args, bench, entry, workload, config, "cpu",
                  plant=lambda prog: undo.append(faults.FAULTS[fault](prog)))
    finally:
        for u in undo:
            u()
    assert not out["correct"], out["readings"]
