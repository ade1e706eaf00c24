"""The port's ref_field gauge with its held-out guard, and multi-start,
against startrax's, on the CPU; and the guard's evaluation, the optimizer
reset and the polish template that they rest on.

Both apps run on the 24x24 scene of tests/test_torch_online.py with the
feed of tests/test_torch_online_gauge.py (one numpy tree, one scene cache,
the JAX steps' uniforms for every step and the JAX app's draws for every
fresh dynamic-field init), without the warmup: two joint epochs admit the
last frames, then the polish (COMMON). GUARDED: gauge_align in ref_field
mode with the guard (refit_epochs 1, gauge_epochs 1, gauge_rounds 1,
gauge_depth_lambda 2.0), one alternation round, then one multi-start round
of 2 candidates of 1 epoch, then a field epoch. The port is re-seeded from
the JAX app's params after the last joint epoch (so that the reference fit
and the gauge fit start from one tree) and after the round's pose epoch (so
that the candidates start from one tree). The tolerances, in each test's
docstring, are ten times the readings.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.apps import online as japp
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import common as tcommon
from startrax_torch.apps import online as tapp
from startrax_torch.train import optim as toptim
from startrax_torch.utils import config as tconfig
from test_torch_online import (_close, _configs, _fresh_scene_memo,  # noqa: F401
                               _one_torch_thread)
from test_torch_online_gauge import logged, run_both
from test_torch_online_parts import _noisy_poses, _tree

COMMON = dict(steps_per_epoch=4, pose_delay_epochs=0, end_barf=0, alt_field_epochs=1,
              alt_pose_epochs=1, ghost_sample_ratio=0.1, frame0_sample_ratio=0.1,
              car_sample_ratio_pose=0.5, selection_frames=2, epoch_val=100)
GUARDED = dict(COMMON, epochs_online=12, polish_epochs=6, polish_mode="gauge_align",
               gauge_mode="ref_field", gauge_guard=True, refit_epochs=1, gauge_epochs=1,
               gauge_rounds=1, gauge_depth_lambda=2.0, multi_start_rounds=1,
               multi_start_candidates=2, multi_start_epochs=1, selection="photometric_depth",
               selection_depth_lambda=2.0, depth_loss=True, depth_lambda=0.1)
GUARDED_PHASES = ["joint", "joint", "gauge_ref", "gauge_fit", "polish_field", "polish_pose",
                  "multi_start", "polish_field"]


def _equal_trees(a, b):
    return all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _floats(items, pattern):
    """The numbers of each logged line, as lists of floats."""
    return [[float(v) for v in re.findall(pattern, line)] for line in items]


def test_ref_field_guard_and_multi_start_match_startrax(tmp_path, monkeypatch):
    """GUARDED. Measured: fine losses to 4.4e-4 relative (the joint epoch
    before the re-seed; 1.5e-4 after it), selection scores to 7.2e-5, pose
    errors equal (history's 5 decimals); the gauge to 3.4e-9 after its
    first step and 7.5e-6 after its last (entries of ~1.6e-3); the guard's
    logged held-out errors and visibilities to 2.1e-5 relative and the
    candidates' scores to 2.7e-5 (their 5 printed digits); the final poses
    to 1.1e-6. Tolerances, ten times those: 4.4e-3, 7.2e-4, 1e-5 (one unit
    of the fifth decimal); 3.4e-8 and 7.5e-5; 2.1e-4 and 2.7e-4; 1.1e-5.
    The phases, the guard's decisions (both vehicles rejected: the poses
    and the optimizers are left as they were) and the adopted candidate
    are equal. In both apps: the reference fit starts from the same fresh
    dynamic fields, trains them only, and leaves every live leaf bitwise;
    multi-start leaves the live fields bitwise."""
    ref_at, ms_at = GUARDED_PHASES.index("gauge_ref"), GUARDED_PHASES.index("multi_start")
    _, (jdir, tdir), (jh, th), fed, jepochs, jg, (jout, tout) = run_both(
        tmp_path, monkeypatch, GUARDED, reseed_after=[ref_at - 1, ms_at - 1])

    assert [h["phase"] for h in th] == [h["phase"] for h in jh] == GUARDED_PHASES
    assert [h["window"] for h in th] == [h["window"] for h in jh]
    _close([h["fine"] for h in th], [h["fine"] for h in jh], rtol=4.4e-3, what="fine")
    for k in ("trans", "rot"):
        _close([h[k] for h in th], [h[k] for h in jh], atol=1e-5, what=k)
    _close([h["score"] for h in th if "score" in h], [h["score"] for h in jh if "score" in h],
           rtol=7.2e-4, what="score")
    assert len(fed["gauges"]) == len(jg) == GUARDED["steps_per_epoch"]
    _close(fed["gauges"][0], jg[0], atol=3.4e-8, what="first gauge step")
    _close(np.stack(fed["gauges"]), np.stack(jg), atol=7.5e-5, what="gauge")

    guard = r"gauge_align guard: vehicle \d .*"
    tg, jgl = logged(tdir, guard), logged(jdir, guard)
    assert [g.endswith("(reject)") for g in tg] == [g.endswith("(reject)") for g in jgl] == [
        True, True]
    _close(_floats(tg, r"\d\.\d{4}e[-+]\d\d"), _floats(jgl, r"\d\.\d{4}e[-+]\d\d"), rtol=2.1e-4,
           what="guard")
    for d in (tdir, jdir):
        assert len(logged(d, "guard rejected every vehicle -> alternate")) == 1
    # the reference fit: one fresh start, the dynamic fields trained, the
    # rest of the scratch tree and every live leaf left bitwise
    tref, jref = fed["epochs"][ref_at], jepochs[ref_at]
    assert _equal_trees(tref[0], jref[0])
    for before, after in (tref, jref):
        for name in ("static_coarse", "static_fine"):
            assert _equal_trees(before["nerf"][name], after["nerf"][name])
        assert not _equal_trees(before["nerf"]["dynamic_fine"], after["nerf"]["dynamic_fine"])
    live = jepochs[ref_at - 1][1]
    assert not _equal_trees(live["nerf"]["dynamic_coarse"], jref[0]["nerf"]["dynamic_coarse"])
    for first_after in (fed["epochs"][ref_at + 2][0], jepochs[ref_at + 2][0]):
        assert _equal_trees(first_after, live)

    # multi-start: the candidates' scores, the adopted one, the fields
    cand = r"multi_start: candidate \d .*"
    _close(_floats(logged(tdir, cand), r"\d\.\d{4}e[-+]\d\d"),
           _floats(logged(jdir, cand), r"\d\.\d{4}e[-+]\d\d"), rtol=2.7e-4, what="candidates")
    adopted = r"multi_start: adopted candidate (\d)"
    assert logged(tdir, adopted) == logged(jdir, adopted) == ["1"]
    base = jepochs[ms_at - 1][1]
    for first_after in (fed["epochs"][ms_at + 1][0], jepochs[ms_at + 1][0]):
        assert _equal_trees(first_after["nerf"], base["nerf"])
        assert not np.array_equal(first_after["poses"], base["poses"])
    _close(tout["poses"], jout["poses"], atol=1.1e-5, what="final poses")


@pytest.mark.parametrize("n_importance, depth", [(12, 2.0), (0, 2.0), (12, 0.0)],
                         ids=["fine_depth", "coarse_only", "no_depth"])
def test_guard_eval_matches_startrax(tmp_path, n_importance, depth):
    """Both packages' held-out guard evaluation of one tree: the score to
    1.5e-6 relative (as selection_score's, tests/test_torch_online_parts.py)
    and the visibility mass to 1.9e-4 (1.9e-5 measured, the fine pass's
    transmittance; 1e-7 with the coarse pass alone); N_importance = 0 reads
    the "0"-suffixed outputs."""
    kw = dict(N_importance=n_importance, gauge_depth_lambda=depth, selection_stride=2,
              selection_frames=3)
    jcfg, tcfg = _configs(tmp_path, **kw)
    tree = _tree(jcfg, _noisy_poses(tcfg))
    jval = japp.make_dataset(jcfg, "val")
    tval = tcommon.make_dataset(tcfg, "val", "cpu")
    jstar, tstar = jconfig.star_config_from(jcfg), tconfig.star_config_from(tcfg)
    js, jm = japp._guard_eval(jcfg, jstar, jax.tree.map(jnp.asarray, tree), jval,
                              jcfg.num_frames)
    ts, tm = tapp._guard_eval(tcfg, tstar, convert.params_from_numpy(tree, device="cpu"), tval,
                              tcfg.num_frames, device="cpu")
    assert np.isfinite(ts) and abs(ts - js) <= 1.5e-6 * abs(js)
    assert tm.shape == (2,) and np.abs(jm).max() > 0
    _close(tm, jm, atol=1.9e-4, what="visibility")


def test_guard_decisions_match_startrax_rule():
    """guard_gauge against startrax's inline loop on one scripted
    evaluation: the base is the identity's score, vehicle k's candidate
    carries the rows accepted before it, and a vehicle is kept as
    _gauge_accept rules."""
    G = np.tile(np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32), (3, 1))
    G[:, 0] = [0.01, 0.02, 0.03]
    table = {(): (1.0, np.array([0.5, 0.5, 0.2])),
             (0,): (0.9, np.array([0.5, 0.5, 0.2])),
             (0, 1): (0.9995, np.array([0.5, 0.5, 0.2])),
             (0, 2): (0.5, np.array([0.5, 0.5, 0.05]))}

    def evaluate(g):
        rows = tuple(k for k in range(3) if g[k, 0] != 0)
        return table[rows]

    accepted, decisions = tapp.guard_gauge(G, evaluate, 0.3)
    # startrax's loop (apps/online.py, the gauge_guard branch)
    want = np.array(jax.numpy.tile(jnp.array([0.0] * 6 + [1.0]), (3, 1)))
    base, base_mass = evaluate(want)
    oks = []
    for k in range(3):
        gk = want.copy()
        gk[k] = G[k]
        sk, mk = evaluate(gk)
        ok = japp._gauge_accept(base, sk, base_mass[k], mk[k], min_vis=0.3)
        oks.append(ok)
        if ok:
            want[k] = G[k]
    assert [d[-1] for d in decisions] == oks == [True, False, False]
    np.testing.assert_array_equal(accepted, want)


def test_polish_template_matches_startrax():
    assert tapp._polish_template() == japp._polish_template()
    assert (tapp._ALT_PHASES, tapp._REFIT_STAGES, tapp._GA_STAGES) == (
        japp._ALT_PHASES, japp._REFIT_STAGES, japp._GA_STAGES)


@pytest.mark.parametrize("accumulate, steps", [(1, 3), (4, 6)], ids=["plain", "mid_accumulation"])
def test_optimizer_reset_equals_a_new_optimizer(accumulate, steps):
    """FusedGroupAdam.reset() after `steps` steps (with accumulation 4, two
    mini-steps into the second update) puts the optimizer in a newly built
    one's state, buffers kept: both then take the same steps bitwise, the
    schedules restarted (count 0)."""
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(5, 3, generator=gen).requires_grad_(True),
              torch.randn(4, generator=gen).requires_grad_(True)]
    grads = [[torch.randn(p.shape, generator=gen) for p in leaves] for _ in range(steps + 8)]

    def make(ls):
        return toptim.FusedGroupAdam(ls, [0, 1], [lambda c: 1e-2 * 0.9 ** c, lambda c: 5e-3],
                                     grad_clip=1.0, accumulate_steps=accumulate)

    def run(opt, ls, gs):
        for g in gs:
            for p, gi in zip(ls, g):
                p.grad = gi.clone()
            opt.step()

    opt = make(leaves)
    run(opt, leaves, grads[:steps])
    assert opt.count > 0 and bool(opt.m.abs().max() > 0)
    buffers = (opt.m, opt.v, opt.acc)
    opt.reset()
    assert all(a is b for a, b in zip((opt.m, opt.v, opt.acc), buffers))
    copies = [t.detach().clone().requires_grad_(True) for t in leaves]
    fresh = make(copies)
    for name in ("m", "v", "acc"):
        a, b = getattr(opt, name), getattr(fresh, name)
        assert (a is None and b is None) or torch.equal(a, b)
    assert (opt.count, opt.mini_step) == (fresh.count, fresh.mini_step) == (0, 0)
    run(opt, leaves, grads[steps:])
    run(fresh, copies, grads[steps:])
    assert all(torch.equal(a, b) for a, b in zip(leaves, copies))
    assert torch.equal(opt.m, fresh.m) and torch.equal(opt.v, fresh.v)
    assert (opt.count, opt.mini_step) == (fresh.count, fresh.mini_step)
