"""The benchmark's occupancy-grid cell (star_carla_nerfacc.occgrid_init) on
the CPU: its step kind (benchmark/steps/occgrid_init.py) and reference
(benchmark/reference/occgrid_init.py) through benchmark.run.run at a small
size, and the readers of its five per-layer metrics (benchmark/metrics/
occgrid_*.py, fused_mlp_train_roofline.py) on made-up traces.

- A sound run comes out correct, with the result line's keys; the step
  left unchanged, half the batch left out, the grid update skipped and
  the update without its decay (faults_occgrid.py) come out not correct.
- The readers give each span's device ms a step and the roofline shares
  by hand, the k-th launch, copy or set call holding the k-th device
  operation; None where the trace holds no such span, where the calls and
  the operations differ in number, and (the shares) where the step lists
  no occupancy-grid call. The fused kernels' share leaves out those
  launched inside occgrid.update, and is None where no fused kernel ran.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults, faults_occgrid, work, work_occgrid  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.metrics import (  # noqa: E402
    fused_mlp_train_roofline,
    occgrid_march_ms,
    occgrid_march_roofline,
    occgrid_update_ms,
    occgrid_update_roofline,
)
from benchmark.run import Context, result_line, run  # noqa: E402
from benchmark.tests.conftest import tiny_cell  # noqa: E402

CELL = "star_carla_nerfacc.occgrid_init"
SMALL = dict(mixed_precision=False, N_rand=32, N_samples=64, grid_resolution=16)
FAULTS = {**faults.FAULTS, **faults_occgrid.FAULTS}


def _run(fault=None):
    bench, entry, workload, config, args = tiny_cell(CELL, **SMALL)
    undo = []
    try:
        out = run(args, bench, entry, workload, config, "cpu",
                  plant=(lambda prog: undo.append(FAULTS[fault](prog))) if fault else None)
    finally:
        for u in undo:
            u()
    return bench, entry, workload, out


def test_sound_run_is_correct():
    bench, entry, workload, out = _run()
    assert out["correct"], out["readings"]
    line = result_line(out, entry, workload, "cpu", 0)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert set(line["checks"]) == set(workload["limits"]) | {"failed_steps"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_update", "no_decay"])
def test_fault_is_not_correct(fault):
    assert not _run(fault)[3]["correct"]


MS = 1_000_000  # ns
CALL = work_occgrid.OccgridCall("occgrid field", work.FieldShape(8, 256), 4096 * 128, rays=4096,
                                n_march=512, res=128)


def _trace(drop_op=False):
    """Two steps: step 0 updates the grid (two launches and a copy), each
    marches (two launches) and trains (one launch); host calls that launch
    nothing lie between. The k-th operation takes k + 1 ms."""
    host = [("train.step", 0, 100 * MS), ("occgrid.update", 1 * MS, 20 * MS),
            ("cudaLaunchKernel", 2 * MS, 3 * MS), ("cudaStreamIsCapturing", 4 * MS, 5 * MS),
            ("cuLaunchKernel", 6 * MS, 7 * MS), ("cudaMemcpyAsync", 8 * MS, 9 * MS),
            ("occgrid.march", 30 * MS, 40 * MS), ("cudaLaunchKernel", 31 * MS, 32 * MS),
            ("cudaLaunchKernelExC", 33 * MS, 34 * MS), ("cudaLaunchKernel", 50 * MS, 51 * MS),
            ("train.step", 200 * MS, 300 * MS), ("occgrid.march", 210 * MS, 220 * MS),
            ("cudaMemsetAsync", 211 * MS, 212 * MS), ("cudaLaunchKernel", 213 * MS, 214 * MS),
            ("cudaEventRecord", 215 * MS, 216 * MS), ("cudaLaunchKernel", 250 * MS, 251 * MS)]
    ops, t = [], 500 * MS
    for k in range(9 - drop_op):
        ops.append((f"op{k}", t, t + (k + 1) * MS, True))
        t += (k + 2) * MS
    return btrace.Trace(ops, host, 1.0, 2)


def _ctx(tr, calls=(CALL,)):
    return Context(tr, 0.05, 0.05, list(calls))


def test_span_device_ms_by_hand():
    ctx = _ctx(_trace())
    assert occgrid_update_ms.read(ctx) == pytest.approx((1 + 2 + 3) / 2)
    assert occgrid_march_ms.read(ctx) == pytest.approx((4 + 5 + 7 + 8) / 2)


def test_roofline_shares_by_hand():
    ctx = _ctx(_trace())
    assert occgrid_march_roofline.read(ctx) == pytest.approx(
        100 * 2 * work_occgrid.march_bound_ms(CALL) / (4 + 5 + 7 + 8))
    assert occgrid_update_roofline.read(ctx) == pytest.approx(
        100 * work_occgrid.update_bound_ms(CALL) / (1 + 2 + 3))
    # the march's least bytes and the update's bound, by hand
    assert work_occgrid.march_bytes(CALL) == (4 * 4096 * 512 + 24 * 4096 + 128 ** 3
                                              + 4096 * 128 * 5 + 8 * 4096)
    flop, nbytes = work.kernel_work(CALL.field, 128 ** 3, 1, True, False, False, save=False)["fwd"]
    assert work_occgrid.update_bound_ms(CALL) == pytest.approx(
        max(flop / work.PEAK_FLOPS, (nbytes + 24 * 128 ** 3) / work.PEAK_BYTES) * 1e3)


@pytest.mark.parametrize("reader", [occgrid_march_ms, occgrid_update_ms, occgrid_march_roofline,
                                    occgrid_update_roofline])
def test_nothing_to_read_is_none(reader):
    assert reader.read(_ctx(_trace(drop_op=True))) is None  # one operation too few
    tr = _trace()
    plain = btrace.Trace(tr.ops, [h for h in tr.host if not h[0].startswith("occgrid.")], 1.0, 2)
    assert reader.read(_ctx(plain)) is None  # a program without the spans
    if "roofline" in reader.__name__:
        assert reader.read(_ctx(tr, calls=())) is None


def _fused_trace(drop_op=False):
    """_trace with fused kernels: the update's first launch and step 0's
    training launch run fwd_kernel, step 1's bwd_kernel."""
    tr = _trace(drop_op)
    names = {0: "void fwd_kernel<0, 0>(Inputs)", 5: "void fwd_kernel<0, 0>(Inputs)",
             8: "void bwd_kernel<0, 0>(Inputs, Grads)"}
    ops = [(names.get(k, n), a, b, kernel) for k, (n, a, b, kernel) in enumerate(tr.ops)]
    return btrace.Trace(ops, tr.host, tr.window_s, tr.steps)


def test_fused_train_roofline_by_hand():
    bounds = work.call_bounds(CALL)
    assert fused_mlp_train_roofline.read(_ctx(_fused_trace())) == pytest.approx(
        100 * (bounds["fwd_kernel"] + bounds["bwd_kernel"]) / ((6 + 9) / 2))


def test_fused_train_roofline_nothing_to_read_is_none():
    assert fused_mlp_train_roofline.read(_ctx(_fused_trace(drop_op=True))) is None
    assert fused_mlp_train_roofline.read(_ctx(_fused_trace(), calls=())) is None
    assert fused_mlp_train_roofline.read(_ctx(_trace())) is None  # no fused kernel
