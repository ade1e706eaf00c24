"""The spans and counters of the occupancy-grid app's step
(apps/occgrid_init.GridStep, kernels/occgrid.py).

- On the CPU, two steps of a tiny step under torch.profiler, the first
  with a grid update: each step's train.step holds train.forward (which
  holds occgrid.march), then train.backward, then train.optimizer; the
  first step's occgrid.update runs inside its train.step, before
  train.forward; no aten::item or aten::_local_scalar_dense starts inside
  a train.step; and occgrid.counts counts two marches and one update.
- A profiler started and stopped around each step call (as chip_smoke.py's
  phase 9 wraps GridStep.__call__) records whole spans: no span is open
  across its start or its stop.
- On the card (marked cuda): the benchmark cell's step at its own sizes
  (4096 rays x 512 march steps, a 128^3 grid, the 8 x 256 field in bf16),
  two steps with one update: no host sync (benchmark/metrics/_spans.SYNCS)
  starts inside a train.step, the update's included.

These tests import no JAX, so the card's test runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_occgrid_spans.py -m cuda
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import inputs  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402
from benchmark.run import kind_of, load_cell  # noqa: E402
from startrax_torch.apps import occgrid_init as app  # noqa: E402
from startrax_torch.kernels import occgrid  # noqa: E402
from startrax_torch.models.fields import FieldConfig, init_field  # noqa: E402
from startrax_torch.train import optim  # noqa: E402
from startrax_torch.utils.tree import tree_leaves  # noqa: E402

CELL = "star_carla_nerfacc.occgrid_init"
RAYS = 16


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "cuda" not in str(e.device_type()).lower()]


def _inside(outer, name, ranges):
    return sorted((a, b) for n, a, b in ranges if n == name and outer[0] <= a and b <= outer[1])


def _started_in_steps(ranges, names):
    """The host records named in ``names`` that start inside a
    train.step."""
    steps = [(a, b) for n, a, b in ranges if n == "train.step"]
    return [(n, a) for n, a, _ in ranges if n in names and any(s <= a < e for s, e in steps)]


def _tiny():
    """(a tiny GridStep that updates at its first call, its batch, its
    generator)."""
    fcfg = FieldConfig(depth=2, width=16, multires=4, multires_views=2,
                       compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    params = init_field(fcfg, gen, "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    occ_cfg = occgrid.OccGridConfig(resolution=8, aabb_min=(-2.0,) * 3, aabb_max=(2.0,) * 3,
                                    render_step_size=0.05, n_march=32, n_selected=8)
    step = app.GridStep(params, fcfg, optim.make_appinit_optimizer(params, 5e-4), occ_cfg, 0.5,
                        3.0, occgrid.init_grid(occ_cfg, "cpu"))
    rays_d = torch.nn.functional.normalize(torch.randn(RAYS, 3, generator=gen), dim=-1)
    batch = {"rays_o": torch.zeros(RAYS, 3), "rays_d": rays_d,
             "target": torch.rand(RAYS, 3, generator=gen)}
    return step, batch, gen


@pytest.fixture(scope="module")
def profiled():
    """The host ranges of two tiny steps, the first with an update, and
    occgrid.counts after them."""
    step, batch, gen = _tiny()
    occgrid.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(batch, generator=gen)
    return _host_ranges(prof), dict(occgrid.counts)


def test_spans_nest_inside_each_step(profiled):
    ranges, _ = profiled
    steps = sorted((a, b) for n, a, b in ranges if n == "train.step")
    assert len(steps) == 2
    updates = sorted((a, b) for n, a, b in ranges if n == "occgrid.update")
    assert len(updates) == 1
    for i, step in enumerate(steps):
        (fwd,), (bwd,), (opt,) = (_inside(step, n, ranges) for n in
                                  ("train.forward", "train.backward", "train.optimizer"))
        assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
        assert len(_inside(fwd, "occgrid.march", ranges)) == 1
        update = _inside(step, "occgrid.update", ranges)
        assert update == (updates if i == 0 else [])
        assert all(b <= fwd[0] for _, b in update)


def test_counts_and_no_device_read(profiled):
    ranges, counts = profiled
    assert counts == {"marches": 2, "updates": 1}
    assert _started_in_steps(ranges, ("aten::item", "aten::_local_scalar_dense")) == []


def test_a_profiler_around_the_train_step_sees_whole_spans(monkeypatch):
    call, profs = app.GridStep.__call__, []

    def profiled(self, *args, **kw):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        try:
            return call(self, *args, **kw)
        finally:
            prof.stop()
            profs.append(prof)

    monkeypatch.setattr(app.GridStep, "__call__", profiled)
    step, batch, gen = _tiny()
    for _ in range(2):
        step(batch, generator=gen)
    names = [[n for n, _, _ in _host_ranges(p)] for p in profs]
    assert [n.count("train.step") for n in names] == [1, 1]
    assert [n.count("occgrid.update") for n in names] == [1, 0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the fused kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_no_host_sync_inside_the_cells_steps(card):
    _, _, workload, config = load_cell(CELL)
    flags = config["flags"]
    # the first step one short of an update: the second updates the grid
    workload = dict(workload, grid=dict(workload["grid"], phase=app.GRID_UPDATE_EVERY - 1))
    feed = inputs.make(flags, workload, 2**31 + 7, card, pool=3)
    kind, _ = kind_of(workload)
    prog = kind.build(flags, workload, feed.params, feed.resume)
    prog.step(feed.batches[0])  # the grid at set-up; the next step updates it
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in feed.batches[1:]:
            prog.step(b)
        torch.cuda.synchronize()
    ranges = _host_ranges(prof)
    assert [n for n, _, _ in ranges].count("occgrid.update") == 1
    assert [n for n, _, _ in ranges].count("occgrid.march") == 2
    assert _started_in_steps(ranges, _spans.SYNCS) == []
