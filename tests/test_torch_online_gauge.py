"""The port's gauge_align polish against startrax's, on the CPU: the scaled
recipe's whole app with the frame0 gauge and boundary-only selection, its
resumes, the frame0 caps, the guard's acceptance rule, and the gauge step
on a shared-pose batch. The ref_field guard is in
tests/test_torch_online_polish.py.

test_scaled_recipe_matches_startrax runs both apps on the 24x24 scene of
tests/test_torch_online.py (K = 2, netwidth 32, 4 steps an epoch, one numpy
tree, one scene cache, the JAX steps' uniforms fed to every step the port
builds, gauge steps included) with the recipe of
startrax/configs/synthetic_star_online_scaled.txt: depth loss 0.1,
photometric_depth selection at stride 2 (selection_frames 2, for time),
boundary-only selection, gauge_align in frame0 mode with gauge_epochs 2 and
gauge_depth_lambda 2.0. Its 10 epochs: fieldform, barf, two joint epochs
that admit the last frames, two gauge_fit epochs and the correction, then
two alternation rounds, each ending on a boundary. The port's params are
re-seeded from the JAX app's after the last joint epoch, so that the gauge
fit starts from one tree in both apps (Adam's sign steps amplify float32
rounding, tests/test_torch_online.py).

Measured: the warmup's fine losses and pose errors equal; the later fine
losses to 4.3e-3 relative, translation and rotation errors to 4.2e-4 and
5.4e-4, selection scores to 4.9e-3; the gauge to 3.3e-9 after its first
step (from one tree) and to 9.3e-5 after its last (entries up to 2e-3: its
plain Adam amplifies rounding as the fields' does), the logged correction
as the gauge; the final poses to 2.0e-3. Tolerances, ten times those (the
warmup's as tests/test_torch_online.py's, 8e-5 and 1e-5): 4.3e-2, 4.2e-3,
5.4e-3, 4.9e-2; 3.3e-8 and 9.3e-4; 2e-2. The phase and window sequences,
the boundary rows, the caps' decisions and the boundary snapshot that ships
are equal; in the port the applied jump is G^-1 o p to 1e-6. The resumes:
one from the checkpoint of the first gauge_fit epoch restarts the gauge
round in both apps; one from the final checkpoint restores the
boundary-best snapshot, bitwise in the port. The readings here and in
tests/test_torch_online_{polish,refit}.py were taken with one torch thread
(tests/test_torch_online._one_torch_thread).
"""

import ast
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.apps import online as japp
from startrax.models import fields as jfields
from startrax.train import loop as jloop
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import online as tapp
from startrax_torch.ops import lie as tlie
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import loop as tloop
from startrax_torch.train import optim as toptim
from startrax_torch.utils.tree import tree_leaves
from test_torch_online import (_close, _configs, _fresh_scene_memo, _history,  # noqa: F401
                               _jax_epochs, _one_torch_thread, _record, _shared_init)
from test_torch_train import LR, _batch, _noisy_online_params, _tcfg, _uniforms

SCALED = dict(epochs_online=12, steps_per_epoch=4, pose_delay_epochs=1, end_barf=2,
              barf_freeze_rot=True, polish_epochs=6, polish_mode="gauge_align",
              gauge_mode="frame0", gauge_epochs=2, gauge_rounds=1, gauge_depth_lambda=2.0,
              alt_field_epochs=1, alt_pose_epochs=1, selection="photometric_depth",
              selection_depth_lambda=2.0, selection_stride=2, selection_frames=2,
              selection_boundary_only=True, depth_loss=True, depth_lambda=0.1,
              ghost_sample_ratio=0.1, frame0_sample_ratio=0.1, car_sample_ratio_pose=0.5,
              epoch_val=5)
SCALED_PHASES = ["fieldform", "barf", "joint", "joint", "gauge_fit", "gauge_fit",
                 "polish_field", "polish_pose", "polish_field", "polish_pose"]


def _draw(state, n_importance, batch):
    """The importance uniforms of one JAX step: the app splits its key once
    a step, the render splits the step's key into the stratified,
    importance and noise keys."""
    state["key"], sub = jax.random.split(state["key"])
    _, k_pdf, _ = jax.random.split(sub, 3)
    n = batch["rays_o"].shape[0]
    state["steps"] += 1
    return torch.tensor(np.asarray(jax.random.uniform(k_pdf, (n, n_importance))))


def _snapshot(params):
    """A numpy copy of a parameter tree (numpy() of a CPU tensor shares its
    memory)."""
    return jax.tree.map(np.array, convert.params_to_numpy(params))


def feed(monkeypatch, jcfg):
    """Give every step the port's app builds (online and gauge) the uniforms
    of the JAX app's, and every fresh dynamic-field init the JAX app's
    draws (its key split three ways); record each online epoch's params
    (state["epochs"], as tests/test_torch_online._record) and each gauge
    step's gauge (state["gauges"]). After the last step of an epoch in
    state["reseed_after"], the live params become the tree given there."""
    jstar = jconfig.star_config_from(jcfg)
    state = {"key": jax.random.PRNGKey(jcfg.seed), "steps": 0, "epochs": {}, "calls": {},
             "reseed_after": {}, "gauges": []}
    make, make_gauge = tloop.make_online_train_step, tloop.make_gauge_train_step

    def online(star_cfg, loss_cfg, opt, **kw):
        step = make(star_cfg, loss_cfg, opt, **kw)

        def fed(params, batch, epoch=0, generator=None):
            u_pdf = _draw(state, star_cfg.n_importance, batch)
            before = _snapshot(params)
            out = step(params, batch, epoch=epoch, u_pdf=u_pdf)
            _record(state["epochs"], epoch, before, _snapshot(params))
            state["calls"][epoch] = state["calls"].get(epoch, 0) + 1
            if state["calls"][epoch] == jcfg.steps_per_epoch and epoch in state["reseed_after"]:
                tckpt.copy_into(params, state["reseed_after"][epoch])
            return out

        return fed

    def gauge(star_cfg, opt, **kw):
        step = make_gauge(star_cfg, opt, **kw)

        def fed(g, nerf, poses, batch, generator=None):
            loss = step(g, nerf, poses, batch, u_pdf=_draw(state, star_cfg.n_importance, batch))
            state["gauges"].append(g.detach().numpy().copy())
            return loss

        return fed

    def fresh(star_cfg, names, generator, device):
        state["key"], kc, kf = jax.random.split(state["key"], 3)
        inits = {"dynamic_coarse": (kc, jstar.dynamic_field()),
                 "dynamic_fine": (kf, jstar.dynamic_field(fine=True))}
        tree = {n: jax.tree.map(np.asarray, jfields.init_stacked_fields(
            inits[n][0], inits[n][1], jstar.num_vehicles)) for n in names}
        return convert.params_from_numpy(tree, device=device, requires_grad=True)

    monkeypatch.setattr(tloop, "make_online_train_step", online)
    monkeypatch.setattr(tloop, "make_gauge_train_step", gauge)
    monkeypatch.setattr(tapp, "fresh_dynamic_fields", fresh)
    return state


def jax_gauges(monkeypatch):
    """Record the gauge after each of the JAX app's gauge steps."""
    make = jloop.make_gauge_train_step
    gauges = []

    def patched(*args, **kw):
        step = make(*args, **kw)

        def recorded(g, opt_state, nerf, poses, batch, key):
            out = step(g, opt_state, nerf, poses, batch, key)
            gauges.append(np.array(out[0]))
            return out

        return recorded

    monkeypatch.setattr(jloop, "make_gauge_train_step", patched)
    return gauges


def logged(run_dir, pattern):
    """Every match of pattern in run.log, as tuples of its groups."""
    with open(os.path.join(run_dir, "run.log")) as f:
        return re.findall(pattern, f.read())


def applied(run_dir):
    """The corrections the app logged as applied, [K, 3] arrays."""
    return [np.array(ast.literal_eval(t)) for t in
            logged(run_dir, r"gauge_align: applied gauge t=(\[\[.*?\]\])")]


class FullQueuePrefetcher:
    """The apps' BatchPrefetcher with one worker, as it runs when the worker
    keeps its queue full (an app's step outlasts a sampling): depth + 1
    batches are sampled ahead, and each batch taken is replaced by one
    sampled under the state of that moment. Synchronous, so that the stale
    batches at a phase change do not depend on how the threads are
    scheduled on a loaded machine."""

    def __init__(self, sample_fn, state, seed=0, depth=4, workers=1):
        assert workers == 1
        self.sample_fn, self.state = sample_fn, state
        self.rng = np.random.default_rng(seed)
        self.ahead = [sample_fn(self.rng, state) for _ in range(depth + 1)]

    def __iter__(self):
        return self

    def __next__(self):
        self.ahead.append(self.sample_fn(self.rng, self.state))
        return self.ahead.pop(0)

    def close(self):
        pass


def run_both(tmp_path, monkeypatch, kw, reseed_after):
    """Both apps on one config from one tree; the port re-seeded from the
    JAX app's params after each epoch in reseed_after. Returns the configs,
    the run directories, the histories, the feed state, the JAX epochs and
    gauges, and both apps' returned params (numpy)."""
    jcfg, tcfg = _configs(tmp_path, **kw)
    for app in (japp, tapp):
        monkeypatch.setattr(app, "BatchPrefetcher", FullQueuePrefetcher)
    _shared_init(monkeypatch, jcfg)
    fed = feed(monkeypatch, jcfg)
    jepochs, jg = _jax_epochs(monkeypatch), jax_gauges(monkeypatch)
    jout = jax.tree.map(np.asarray, japp.train(jcfg))
    for e in reseed_after:
        fed["reseed_after"][e] = jepochs[e][1]
    tout = convert.params_to_numpy(tapp.train(tcfg, device="cpu"))
    dirs = tuple(str(tmp_path / p / "smoke" / "online") for p in ("jax", "torch"))
    return (jcfg, tcfg), dirs, tuple(_history(d) for d in dirs), fed, jepochs, jg, (jout, tout)


def test_scaled_recipe_matches_startrax(tmp_path, monkeypatch):
    gauge_at = SCALED_PHASES.index("gauge_fit")
    (jcfg, tcfg), (jdir, tdir), (jh, th), fed, jepochs, jg, (jout, tout) = run_both(
        tmp_path, monkeypatch, SCALED, reseed_after=[gauge_at - 1])

    assert [h["phase"] for h in th] == [h["phase"] for h in jh] == SCALED_PHASES
    assert [h["window"] for h in th] == [h["window"] for h in jh]
    boundaries = [h["epoch"] for h in jh if h.get("boundary")]
    assert boundaries == [7, 9] and [h["epoch"] for h in th if h.get("boundary")] == boundaries
    assert fed["steps"] == len(SCALED_PHASES) * SCALED["steps_per_epoch"]
    for idx, rtol, atol in (([0, 1], 8e-5, (1e-5, 1e-5)), (range(2, len(jh)), 4.3e-2,
                                                           (4.2e-3, 5.4e-3))):
        _close([th[i]["fine"] for i in idx], [jh[i]["fine"] for i in idx], rtol=rtol, what="fine")
        for k, a in zip(("trans", "rot"), atol):
            _close([th[i][k] for i in idx], [jh[i][k] for i in idx], atol=a, what=k)
    assert [("score" in h) for h in th] == [("score" in h) for h in jh]
    _close([h["score"] for h in th if "score" in h], [h["score"] for h in jh if "score" in h],
           rtol=4.9e-2, what="score")

    # the gauge fit, from one tree: the gauge after every step, and the
    # correction g^-1 that the caps let through for both vehicles
    n_gauge = SCALED["gauge_epochs"] * SCALED["steps_per_epoch"]
    assert len(fed["gauges"]) == len(jg) == n_gauge
    _close(fed["gauges"][0], jg[0], atol=3.3e-8, what="first gauge step")
    _close(np.stack(fed["gauges"]), np.stack(jg), atol=9.3e-4, what="gauge")
    (tcorr,), (jcorr,) = applied(tdir), applied(jdir)
    _close(tcorr, jcorr, atol=9.3e-4, what="correction")
    assert np.abs(jcorr).max() > 1e-4
    for d in (tdir, jdir):
        assert logged(d, r"\((\d)/2 within bounds; selection guards\)") == ["2"]
    # the correction is the inverse of the fitted gauge, applied to the
    # poses the gauge was fit against, in the port
    before = jepochs[gauge_at - 1][1]["poses"]
    want = tlie.se3_multiply(tlie.se3_inverse(torch.tensor(fed["gauges"][-1]))[None],
                             torch.tensor(before))
    _close(fed["epochs"][gauge_at + 2][0]["poses"], want.numpy(), atol=1e-6, what="G^-1 p")
    _close(tcorr, tlie.se3_inverse(torch.tensor(fed["gauges"][-1]))[:, :3].numpy(), atol=1e-6,
           what="logged correction")

    # the boundary best is the active snapshot (two boundaries): the final
    # _best checkpoint, and the returned params
    for d in (tdir, jdir):
        assert max(int(s) for s in os.listdir(f"{d}/ckpts_best")) == 9
        assert os.listdir(f"{d}/ckpts_bbound") == ["9"]
    _close(tout["poses"], jout["poses"], atol=2e-2, what="final poses")
    best = tckpt.restore_checkpoint(tdir + "/ckpts_best", device="cpu")["params"]
    bbound = tckpt.restore_checkpoint(tdir + "/ckpts_bbound", device="cpu")["params"]
    assert all(np.array_equal(a, b.numpy()) and np.array_equal(a, c.numpy()) for a, b, c in
               zip(jax.tree.leaves(tout), tree_leaves(best), tree_leaves(bbound)))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))

    # resume from the first gauge_fit epoch's checkpoint: the round
    # restarts (a fresh gauge) in both apps
    for cfg, d, app, kw in ((jcfg, jdir, japp, {}), (tcfg, tdir, tapp, {"device": "cpu"})):
        shutil.copytree(f"{d}/ckpts/{gauge_at}", f"{d}/mid/{gauge_at}")
        shutil.copytree(f"{d}/ckpts_best", f"{d}/mid_best")
        app.train(type(cfg)(**{**cfg.__dict__, "online_ckpt_path": f"{d}/mid",
                               "epochs_online": gauge_at + 2}), **kw)
        assert [h["phase"] for h in _history(d)] == ["gauge_fit"]
        log = open(f"{d}/run.log").read().split("resumed online training")[-1]
        assert "ga=ref_field/0" in log and "fitting the frame-0 gauge (round 0)" in log
    assert len(jg) == len(fed["gauges"]) == n_gauge + SCALED["steps_per_epoch"]

    # resume from the final checkpoint (no epoch left): the boundary-best
    # snapshot is restored and returned, bitwise in the port
    pattern = r"restored boundary-best snapshot \(epoch (\d+)"
    for cfg, d, app, kw in ((jcfg, jdir, japp, {}), (tcfg, tdir, tapp, {"device": "cpu"})):
        out = app.train(type(cfg)(**{**cfg.__dict__, "online_ckpt_path": f"{d}/ckpts",
                                     "epochs_online": SCALED["epochs_online"] + 1}), **kw)
        assert logged(d, pattern) == ["9"]
        if app is tapp:
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(bbound)))


W = np.float32(np.cos(0.25))  # a quaternion's w: a rotation of 0.5 rad
ROT = 2.0 * float(np.arccos(W))  # that angle, as the caps compute it (float32)
T = float(np.float32(0.2))  # a translation of 0.2, as a float32 row holds it


@pytest.mark.parametrize("G, max_trans, max_rot, within", [
    ([[T, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]], T, 0.5, [True]),
    ([[0.0, 0.2 + 1e-6, 0.0, 0.0, 0.0, 0.0, 1.0]], 0.2, 0.5, [False]),
    ([[0.0, 0.0, 0.0, 0.0, 0.0, np.sin(0.25), W]], 0.2, ROT, [True]),
    ([[0.0, 0.0, 0.0, 0.0, 0.0, -np.sin(0.25), -W]], 0.2, ROT, [True]),
    ([[0.0, 0.0, 0.0, 0.0, 0.0, np.sin(0.25), W]], 0.2, np.nextafter(ROT, 0.0), [False]),
    ([[0.0, 0.0, 0.0, 0.0, np.sin(0.3), 0.0, -np.cos(0.3)]], 0.2, 0.5, [False]),
    ([[0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], [0.3, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]], 0.2, 0.5,
     [True, False]),
    ([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0 + 1e-6]], 0.2, 0.0, [True]),
], ids=["trans_at_cap", "trans_over", "rot_at_cap", "negative_w", "rot_over_by_an_ulp",
        "rot_over", "per_vehicle", "w_over_one"])
def test_gauge_caps_match_startrax(G, max_trans, max_rot, within):
    """The port's cap decision, row by row, against the rule startrax's app
    applies inline to its float32 G: at the caps (equal counts as within),
    a negative q_w (the same rotation as -q), an unnormalised |q_w| > 1."""
    G = np.asarray(G, np.float32)
    got = tapp.gauge_within_caps(G, max_trans, max_rot)
    assert [ok for ok, _, _ in got] == within
    for g, (ok, tnorm, ang) in zip(G, got):
        j_t = float(np.linalg.norm(g[:3]))
        j_a = 2.0 * float(np.arccos(min(1.0, abs(g[6]))))
        assert (tnorm, ang) == (j_t, j_a) and ok == (j_t <= max_trans and j_a <= max_rot)


@pytest.mark.parametrize("base, cand, base_vis, cand_vis", [
    (1.0, 1.0 - 1e-3, 0.5, 0.5), (1.0, 0.998, 0.5, 0.5), (1.0, 0.9, 0.5, 0.15),
    (1.0, 0.9, 0.5, 0.149), (1.0, 0.9, 0.0, 0.0), (1.0, 0.9, 9.9e-5, 0.0), (1.0, 0.9, 1e-4, 0.0),
    (1.0, 1.1, 0.0, 0.5)],
    ids=["at_margin", "better", "vis_at_min", "vis_under", "zero_vis", "vis_under_floor",
         "vis_at_floor", "worse"])
def test_gauge_accept_matches_startrax(base, cand, base_vis, cand_vis):
    for min_vis in (0.3, 0.5):
        assert (tapp._gauge_accept(base, cand, base_vis, cand_vis, min_vis=min_vis)
                == japp._gauge_accept(base, cand, base_vis, cand_vis, min_vis=min_vis))


def test_gauge_step_on_a_shared_pose_batch_matches_startrax():
    """A stale batch of one frame (a Python int) in the gauge step, depth
    term 2.0, from a gauge that moves the vehicles: the port's loss and
    gauge gradient equal its per-ray step's on the same rays all at that
    frame (the loss exactly, the gradient to 1.2e-7 of its largest entry
    measured, tolerance 1.2e-6), and the JAX step's (the loss to 1.5e-5
    relative and the gradient to 5.0e-4 of its largest entry measured;
    1.5e-4 and 5e-3). Then three steps with the rotation frozen: the losses
    and the gauge as tests/test_torch_train.py holds the per-ray gauge
    steps (2e-3 relative, 2 x lr x steps)."""
    import optax

    from __graft_entry__ import _flagship_cfg

    jcfg = _flagship_cfg(tiny=True)
    jparams, tparams = _noisy_online_params(jcfg, seed=22)
    jbatch, tbatch = _batch(23, frame=2)
    depth = np.random.default_rng(24).uniform(jcfg.near, jcfg.far, size=len(tbatch["target"]))
    jbatch["target_depth"] = jnp.asarray(depth, jnp.float32)
    tbatch["target_depth"] = torch.tensor(depth, dtype=torch.float32)
    per_ray = dict(tbatch, frame=torch.full((len(depth),), 2))
    assert tloop.batch_kind(tbatch) == "shared" and tloop.batch_kind(per_ray) == "per_ray"
    g0 = np.array([[0.01, -0.02, 0.005, 0.0, 0.0, 0.0, 1.0]] * 2, np.float32)
    key = jax.random.PRNGKey(25)

    capture = optax.GradientTransformation(jnp.zeros_like,
                                           lambda g, s, p=None: (jnp.zeros_like(g), g))
    jcap = jloop.make_gauge_train_step(jcfg, capture, depth_lambda=2.0)
    _, jgrad, jl = jcap(jnp.asarray(g0), capture.init(jnp.asarray(g0)), jparams["nerf"],
                        jparams["poses"], jbatch, key)
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad[:, :3]).min() > 0
    got = {}
    for name, batch in (("shared", tbatch), ("per_ray", per_ray)):
        probe = torch.tensor(g0, requires_grad=True)
        step = tloop.make_gauge_train_step(_tcfg(jcfg), toptim.make_gauge_optimizer(probe, LR),
                                           depth_lambda=2.0)
        got[name] = (float(step(probe, tparams["nerf"], tparams["poses"], batch,
                                *_uniforms(key, jcfg))), probe.grad.numpy())
    (ls, gs), (lr_, gr) = got["shared"], got["per_ray"]
    assert ls == lr_
    np.testing.assert_allclose(gs, gr, rtol=0, atol=1.2e-6 * np.abs(gr).max())
    np.testing.assert_allclose(ls, float(jl), rtol=1.5e-4)
    np.testing.assert_allclose(gs, jgrad, rtol=0, atol=5e-3 * np.abs(jgrad).max())

    jtx = optax.adam(LR)
    jgauge = jnp.asarray(g0)
    jopt = jtx.init(jgauge)
    jstep = jloop.make_gauge_train_step(jcfg, jtx, freeze_rot=True, depth_lambda=2.0)
    tgauge = torch.tensor(g0, requires_grad=True)
    tstep = tloop.make_gauge_train_step(_tcfg(jcfg), toptim.make_gauge_optimizer(tgauge, LR),
                                        freeze_rot=True, depth_lambda=2.0)
    for i in range(3):
        key, sub = jax.random.split(key)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        jgauge, jopt, jl = jstep(jgauge, jopt, jparams["nerf"], jparams["poses"], jbatch, sub)
        tl = tstep(tgauge, tparams["nerf"], tparams["poses"], tbatch, u_strat=u_strat,
                   u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1.5e-4 if i == 0 else 2e-3)
    np.testing.assert_allclose(tgauge.detach().numpy(), np.asarray(jgauge), rtol=0,
                               atol=2 * LR * 3)
    np.testing.assert_array_equal(tgauge.detach()[:, 3:].numpy(), g0[:, 3:])
    assert all(t.grad is None for t in tree_leaves(tparams))
