"""The reference computes the program's semantics: the port's plain path
(use_fused off, float32, on the CPU) and the step's reference on the same
inputs, draws and resumed optimizer state agree on each step's loss,
every leaf's gradient and every leaf's change over the steps."""

import pytest
import torch

from benchmark import inputs
from benchmark.run import CHECKED_STEPS, first_steps, kind_of

from .conftest import CELLS, tiny_cell


def _both(name, n_steps):
    bench, entry, workload, config, args = tiny_cell(name, mixed_precision=False)
    flags = {**config["flags"], **config.get("stages", {}).get(workload.get("stage"), {})}
    feed = inputs.make(flags, workload, args.seed, "cpu")
    kind, reference = kind_of(workload)
    prog = kind.build(flags, workload, feed.params, feed.resume)
    ref = reference.run_steps(flags, workload, feed.params, feed.batches, n_steps, feed.resume)
    return prog, feed, ref


def _close(a, b, rtol):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("name", CELLS)
def test_one_step_against_the_plain_path(name):
    prog, feed, ref = _both(name, 1)
    loss = float(prog.step(feed.batches[0]))
    assert loss == pytest.approx(ref["losses"][0], rel=1e-5)
    for n, g in ref["grads"].items():
        p = prog.leaves[n].grad
        got = torch.zeros_like(g) if p is None else p.detach()
        assert _close(got, g, 2e-3), n


@pytest.mark.parametrize("name", CELLS)
def test_three_steps_with_an_update(name):
    prog, feed, ref = _both(name, CHECKED_STEPS)
    got = first_steps(prog, feed.batches)
    assert got["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    moved = [n for n, c in ref["changes"].items() if float(c.norm()) > 0]
    assert moved  # the check's three steps cover an update
    for n in moved:
        assert _close(got["changes"][n], ref["changes"][n], 2e-3), n


@pytest.mark.parametrize("v0", [1e-4, 0.0])
def test_the_update_follows_the_gradients_size(v0):
    """From a second moment above the gradient's square the update is
    linear in the gradient as the optimizer gets it, so a gradient of the
    wrong size (a sum for a mean, a clip left out) moves the parameters by
    the wrong amount; from zero moments Adam's update is the gradient's
    sign, and its size is lost."""
    from benchmark.reference.star import Adam

    g = 1e-3 * torch.randn(4096, generator=torch.Generator().manual_seed(5))
    moved = []
    for scale in (1.0, 2.0):
        w = {"w": torch.zeros(4096)}
        opt = Adam(w, {"w": 0}, [lambda c: 1e-3], None, count=1000,
                   v={"w": torch.full((4096,), v0)})
        opt.step({"w": scale * g})
        moved.append(float(w["w"].norm()))
    assert moved[1] / moved[0] == pytest.approx(2.0 if v0 else 1.0, rel=2e-3)
