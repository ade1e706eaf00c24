"""The spans inside the port's training step (utils/profiling.span) and the
benchmark's readers of them (benchmark/metrics/<name>.py over _spans.py).

- A tiny app-init step (an update every step) and a tiny online step (an
  update every 3rd, accumulate_steps = 3), three steps each under
  torch.profiler on the CPU: every step's spans nest by interval,
  train.step holding train.forward (render.coarse, render.resample,
  render.fine, train.losses in that order), then train.backward, then
  train.optimizer holding optim.gather; optim.adam is open once an update.
- Without a profiler the spans change nothing: a step's loss and leaves are
  bit-identical to the same step with every span a no-op.
- The readers on hand-built traces: host ms a step by span, syncs started
  inside a train.step only, None where the trace holds no span; an idle gap
  that begins outside every aten op is named by the span open there.
- No step reads a value from the device: no aten::item or
  aten::_local_scalar_dense starts inside a train.step.
- On the card (marked cuda): the flagship's online step at its widths, one
  fused_mlp.prepare a fused call and a fused_mlp.pack a forward and a
  backward, no device record named like a span; and three steps of each
  kind at the flagship's widths (one update online, three in app-init)
  with no host sync (benchmark/metrics/_spans.SYNCS) started inside a
  train.step.

These tests import no JAX, so the card's test runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m cuda
"""

import contextlib
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import trace as btrace  # noqa: E402
from benchmark.metrics import (  # noqa: E402
    _spans,
    backward_host_ms,
    forward_host_ms,
    host_syncs_per_step,
    optimizer_host_ms,
    pack_host_ms,
)
from benchmark.run import Context  # noqa: E402
from startrax_torch.kernels import fused_mlp as fm  # noqa: E402
from startrax_torch.models.star import StarConfig, init_star  # noqa: E402
from startrax_torch.train import loop, optim  # noqa: E402
from startrax_torch.utils import profiling  # noqa: E402
from startrax_torch.utils.tree import tree_leaves  # noqa: E402

STEPS = 3
ACCUMULATE = {"appinit": 1, "online": 3}
RAYS = 8
TINY = StarConfig(num_vehicles=2, netdepth=2, netdepth_fine=2, netwidth=32, netwidth_fine=32,
                  n_samples=8, n_importance=8, compute_dtype=torch.float32)
FLAGSHIP = StarConfig(num_vehicles=2)  # 8 x 256 static, 4 x 256 dynamic, 256 + 256 samples


def _built(kind, cfg, rays, device):
    """(step(i) -> loss, the leaves) of a fresh step of ``kind`` at ``cfg``
    on ``rays`` rays, from fixed seeds."""
    gen = torch.Generator(device).manual_seed(5)
    if kind == "appinit":
        params = init_star(cfg, gen, device)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        opt = optim.make_appinit_optimizer(params, 5e-4, accumulate_steps=ACCUMULATE[kind])
        step = loop.make_appinit_train_step(cfg, loop.LossConfig(), opt)
    else:
        params = loop.init_online_params(cfg, num_frames=3, generator=gen, device=device)
        opt = optim.make_fused_star_optimizer(params, 5e-4, 5e-4, 5e-4, grad_clip=1.0,
                                              accumulate_steps=ACCUMULATE[kind])
        step = loop.make_online_train_step(cfg, loop.LossConfig(), opt)
    data = torch.Generator(device).manual_seed(7)
    rays_d = torch.randn(rays, 3, generator=data, device=device)

    def run(i):
        batch = {"rays_o": torch.zeros(rays, 3, device=device),
                 "rays_d": rays_d / rays_d.norm(dim=-1, keepdim=True),
                 "target": torch.rand(rays, 3, generator=data, device=device)}
        if kind == "online":
            batch["frame"] = 1 + i % 2
        return step(params, batch, generator=gen)[0]

    return run, tree_leaves(params)


def _host_ranges(prof):
    """(name, start ns, end ns) of every host record of a finished profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "cuda" not in str(e.device_type()).lower()]


def _inside(outer, name, ranges):
    return sorted((a, b) for n, a, b in ranges if n == name and outer[0] <= a and b <= outer[1])


@pytest.fixture(scope="module")
def profiled():
    """{kind: the host ranges of STEPS steps of it under the profiler}."""
    out = {}
    for kind in ACCUMULATE:
        run, _ = _built(kind, TINY, RAYS, "cpu")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(STEPS):
                run(i)
        out[kind] = _host_ranges(prof)
    return out


@pytest.mark.parametrize("kind", list(ACCUMULATE))
def test_spans_nest_inside_each_step(profiled, kind):
    ranges = profiled[kind]
    steps = sorted((a, b) for n, a, b in ranges if n == "train.step")
    assert len(steps) == STEPS
    for step in steps:
        (fwd,), (bwd,), (opt,) = (_inside(step, n, ranges) for n in
                                  ("train.forward", "train.backward", "train.optimizer"))
        assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
        parts = [_inside(fwd, n, ranges) for n in
                 ("render.coarse", "render.resample", "render.fine", "train.losses")]
        assert [len(p) for p in parts] == [1, 1, 1, 1]
        ends = [x for p in parts for x in p[0]]
        assert ends == sorted(ends)
        assert len(_inside(opt, "optim.gather", ranges)) == 1


@pytest.mark.parametrize("kind", list(ACCUMULATE))
def test_adam_span_opens_once_an_update(profiled, kind):
    ranges = profiled[kind]
    adam = [(a, b) for n, a, b in ranges if n == "optim.adam"]
    assert len(adam) == STEPS // ACCUMULATE[kind]
    optimizer = [(a, b) for n, a, b in ranges if n == "train.optimizer"]
    assert all(any(o[0] <= a and b <= o[1] for o in optimizer) for a, b in adam)


def _started_in_steps(ranges, names):
    """The host records named in ``names`` that start inside a train.step."""
    steps = [(a, b) for n, a, b in ranges if n == "train.step"]
    return [(n, a) for n, a, _ in ranges if n in names and any(s <= a < e for s, e in steps)]


@pytest.mark.parametrize("kind", list(ACCUMULATE))
def test_no_step_reads_the_device(profiled, kind):
    assert _started_in_steps(profiled[kind], ("aten::item", "aten::_local_scalar_dense")) == []


def test_trace_totals_name_the_spans(tmp_path):
    run, _ = _built("appinit", TINY, RAYS, "cpu")
    with profiling.trace(str(tmp_path)) as prof:
        run(0)
    keys = {a.key for a in prof.key_averages()}
    assert {"train.step", "train.forward", "train.backward", "train.optimizer"} <= keys
    assert '"train.losses"' in (tmp_path / profiling.TRACE_FILE).read_text()


@pytest.mark.parametrize("kind", list(ACCUMULATE))
def test_spans_change_no_result(monkeypatch, kind):
    run, leaves = _built(kind, TINY, RAYS, "cpu")
    losses = [run(i) for i in range(STEPS)]

    patched, real = set(), profiling.span
    for name, module in list(sys.modules.items()):
        if name.startswith("startrax_torch") and getattr(module, "span", None) is real:
            monkeypatch.setattr(module, "span", lambda _: contextlib.nullcontext())
            patched.add(name.rsplit(".", 1)[-1])
    assert {"loop", "star", "optim", "fused_mlp"} <= patched
    run_off, leaves_off = _built(kind, TINY, RAYS, "cpu")
    losses_off = [run_off(i) for i in range(STEPS)]
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_off))
    assert all(torch.equal(a, b) for a, b in zip(leaves, leaves_off))


def _ctx(host, ops=(), steps=2):
    return Context(btrace.Trace(list(ops), list(host), 1.0, steps), 0.05, 0.05, [])


MS = 1_000_000  # ns
HOST = [("train.step", 0, 100 * MS), ("train.forward", 1 * MS, 40 * MS),
        ("fused_mlp.pack", 2 * MS, 5 * MS), ("aten::mm", 6 * MS, 7 * MS),
        ("train.backward", 40 * MS, 80 * MS), ("fused_mlp.pack", 50 * MS, 51 * MS),
        ("train.optimizer", 80 * MS, 99 * MS), ("cudaStreamSynchronize", 85 * MS, 90 * MS),
        ("cudaMemcpyAsync", 91 * MS, 92 * MS),
        ("cudaDeviceSynchronize", 150 * MS, 160 * MS),  # between the steps
        ("train.step", 200 * MS, 300 * MS), ("train.forward", 201 * MS, 230 * MS),
        ("fused_mlp.pack", 202 * MS, 203 * MS), ("train.backward", 230 * MS, 290 * MS),
        ("cudaMemcpy", 240 * MS, 241 * MS), ("train.optimizer", 290 * MS, 295 * MS)]


@pytest.mark.parametrize("reader, value", [
    (forward_host_ms, (39 + 29) / 2), (backward_host_ms, (40 + 60) / 2),
    (optimizer_host_ms, (19 + 5) / 2), (pack_host_ms, (3 + 1 + 1) / 2),
    (host_syncs_per_step, 2 / 2)])
def test_span_readers(reader, value):
    assert reader.read(_ctx(HOST)) == pytest.approx(value)
    plain = [h for h in HOST if not h[0].startswith(("train.", "fused_mlp."))]
    assert reader.read(_ctx(plain)) is None


def test_sync_outside_a_step_is_not_counted():
    assert host_syncs_per_step.read(_ctx(HOST[:10], steps=1)) == 1.0


def test_idle_gap_outside_every_aten_op_is_named_by_its_span():
    ops = [("k", 0, 8 * MS, True), ("k", 20 * MS, 30 * MS, True), ("k", 31 * MS, 32 * MS, True)]
    assert _ctx(HOST, ops).trace.idle_gaps() == [["train.forward", pytest.approx(0.012)],
                                                 ["train.forward", pytest.approx(0.001)]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the fused kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_spans_on_the_flagship_step(card):
    run, _ = _built("online", FLAGSHIP, 1000, card)
    run(0)
    torch.cuda.synchronize()
    fm.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(1)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e.name() for e in events if "cuda" not in str(e.device_type()).lower()]
    device = {e.name() for e in events if "cuda" in str(e.device_type()).lower()}
    calls, backwards = fm.launches["fwd"], fm.launches["bwd"]
    assert calls == 6 and backwards == 6  # static + 2 dynamic fields, coarse and fine
    assert host.count("fused_mlp.prepare") == calls
    assert host.count("fused_mlp.pack") == calls + backwards
    spans = {n for n in host if n.startswith(("train.", "render.", "optim.", "fused_mlp."))}
    assert {"train.step", "fused_mlp.pack", "render.fine"} <= spans
    assert not spans & device


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ACCUMULATE))
def test_no_host_sync_inside_a_flagship_step(card, kind):
    run, _ = _built(kind, FLAGSHIP, 1000, card)
    run(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(1, STEPS + 1):
            run(i)
        torch.cuda.synchronize()
    ranges = _host_ranges(prof)
    adam = [n for n, _, _ in ranges if n == "optim.adam"]
    assert len(adam) == STEPS // ACCUMULATE[kind]
    assert _started_in_steps(ranges, _spans.SYNCS) == []
