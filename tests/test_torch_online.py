"""The port's online tracking app against startrax's, on the CPU.

Both apps run the phase-machine config of tests/test_apps.py
(test_online_phase_machine_and_selection) on a 24x24 synthetic scene with
K = 2 vehicles (so that the dynamic fields run stacked), netwidth 32,
10 epochs of 4 steps: field-forming warmup, BARF with frozen rotations,
joint curriculum epochs, then 4 epochs of the alternate polish with
photometric selection. They start from one numpy tree (init_online_params
patched in both apps) and the same noisy poses (both draw them from the
seeded numpy generator), train on the same batches (one prefetch worker,
the same seed, one scene cache that the JAX app writes and the port reads)
and the same uniforms (every step the port's app builds is given the
importance-sample uniforms that the JAX app's step draws from its one key,
split once a step; perturb = 0 and raw_noise_std = 0 leave no other
randomness), in float32 on the plain field path.

The two runs start equal to float32 rounding and drift apart through
Adam: its early updates are lr * sign(g) for every gradient far above eps,
so a rounding-level difference on a near-zero gradient flips a whole
lr-sized step (tests/test_torch_train.py). Per step, the fine losses agree
to 1e-6 relative through the warmup and drift from the first joint step on,
where the rotations unfreeze with fresh moments. So that the polish's pose
optimizer is held step for step, the port's first polish_pose epoch starts
from the JAX app's params at that epoch.

Each phase kind must train what it trains in startrax, in both apps: the
field phases leave the translations bitwise and the quaternions to their
renormalisation's rounding; BARF leaves the quaternions bitwise; the
pose-only phases leave every field weight bitwise; each pose-updating epoch
moves some pose entry by more than 1e-4 (7.1e-4 to 1.9e-3 measured).

Measured, by epoch: the warmup's (fieldform, barf) fine losses to 8.0e-6
relative and its pose errors exactly (history rounds them to 5 decimals);
the later epochs' fine losses to 3.9e-3 relative, translation and rotation
errors to 7e-5 and 1.4e-4 absolute, selection scores to 1.6e-3 relative;
the validation PSNR to 4.0e-3 dB and SSIM to 1.3e-4. Each epoch's change
of the poses, entry by entry: the BARF epoch's to 3.4e-6 and the re-seeded
polish_pose epoch's to 1.9e-6 (against changes up to 1.9e-3 and 7.1e-4);
the mean absolute change of every pose-updating epoch to 9.0e-3 relative.
Tolerances, ten times those: warmup fine losses 8e-5 relative and pose
errors 1e-5 absolute; later fine losses 4e-2, scores 1.6e-2 relative, pose
errors 1.4e-3 absolute; PSNR 4e-2 dB, SSIM 1.3e-3; pose changes 3.4e-5
(BARF) and 2e-5 (polish_pose) absolute, mean changes 9e-2 relative. The
phase and window sequences and the metric keys are equal.

test(), resume, warm start, the refusals and the host parts are in
tests/test_torch_online_parts.py.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from startrax.apps import online as japp
from startrax.data import synthetic as jsyn
from startrax.train import loop as jloop
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import online as tapp
from startrax_torch.data import synthetic as tsyn
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import loop as tloop
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(
    expname="smoke", dataset_type="synthetic", num_frames=6, num_vehicles=2, near=2.0, far=8.0,
    scale_factor=-1.0, netdepth=4, netdepth_fine=4, netwidth=32, netwidth_fine=32,
    N_samples=12, N_importance=12, N_rand=128, mixed_precision=False, synth_height=24,
    synth_views=4, synth_val_views=2, num_workers=1, data_parallel="off", perturb=0.0,
    raw_noise_std=0.0, noisy_pose_init=True, initial_num_frames=5, online_thres=1e9,
    online_thres_tightened=1e9, epochs_between_frames=0, selection="photometric",
    selection_patience=0)
# tests/test_apps.py's phase machine, validated and checkpointed every 5 epochs
PHASES = dict(epochs_online=10, steps_per_epoch=4, pose_delay_epochs=1, end_barf=2,
              barf_freeze_rot=True, polish_epochs=4, polish_mode="alternate",
              alt_field_epochs=1, alt_pose_epochs=1, ghost_sample_ratio=0.1,
              frame0_sample_ratio=0.1, epoch_val=5)
EXPECTED_PHASES = ["fieldform", "barf", "joint", "joint", "polish_field", "polish_pose",
                   "polish_field", "polish_pose"]


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _history(run_dir):
    with open(os.path.join(run_dir, "history.json")) as f:
        return json.load(f)


def _configs(tmp_path, **kw):
    cache = str(tmp_path / "cache")
    jcfg = jconfig.Config(**{**BASE, **kw}, basedir=str(tmp_path / "jax"), synth_cache_dir=cache)
    tcfg = tconfig.Config(**{**BASE, **kw}, basedir=str(tmp_path / "torch"),
                          synth_cache_dir=cache)
    return jcfg, tcfg


def _shared_init(monkeypatch, jcfg):
    """Patch init_online_params in both packages to return one numpy tree."""
    tree = jax.tree.map(np.asarray, jloop.init_online_params(
        jax.random.PRNGKey(0), jconfig.star_config_from(jcfg), jcfg.num_frames))
    monkeypatch.setattr(jloop, "init_online_params",
                        lambda key, cfg, n: jax.tree.map(jax.numpy.asarray, tree))
    monkeypatch.setattr(tloop, "init_online_params",
                        lambda cfg, n, gen=None, dev=None: convert.params_from_numpy(
                            tree, device=dev, requires_grad=True))
    return tree


def _record(epochs, epoch, before, after):
    """Keep an epoch's params (numpy trees) at its first step's start and at
    its last step's end."""
    epochs.setdefault(int(epoch), [before, None])[1] = after


def _uniform_feed(monkeypatch, seed):
    """Give every online step the port's app builds the uniforms that the
    JAX app's steps draw: the JAX app splits its one key once a step, over
    all of its step functions (key, sub = split(key)), and its render splits
    sub into the stratified, importance and noise keys. state["epochs"]
    records each epoch's params (_record); an epoch in state["reseed"] starts
    from the params tree given there."""
    make = tloop.make_online_train_step
    state = {"key": jax.random.PRNGKey(seed), "steps": 0, "epochs": {}, "reseed": {}}

    def patched(star_cfg, loss_cfg, opt, **kw):
        step = make(star_cfg, loss_cfg, opt, **kw)

        def fed(params, batch, epoch=0, generator=None):
            state["key"], sub = jax.random.split(state["key"])
            _, k_pdf, _ = jax.random.split(sub, 3)
            n = batch["rays_o"].shape[0]
            u_pdf = torch.tensor(np.asarray(jax.random.uniform(k_pdf, (n, star_cfg.n_importance))))
            state["steps"] += 1
            if epoch in state["reseed"] and epoch not in state["epochs"]:
                tckpt.copy_into(params, state["reseed"][epoch])
            before = jax.tree.map(np.array, convert.params_to_numpy(params))
            out = step(params, batch, epoch=epoch, u_pdf=u_pdf)
            _record(state["epochs"], epoch, before,
                    jax.tree.map(np.array, convert.params_to_numpy(params)))
            return out

        return fed

    monkeypatch.setattr(tloop, "make_online_train_step", patched)
    return state


def _jax_epochs(monkeypatch):
    """Record each epoch's params in the JAX app's online steps (_record)."""
    make = jloop.make_online_train_step
    epochs = {}

    def patched(*args, **kw):
        step = make(*args, **kw)

        def recorded(params, opt_state, batch, key, epoch):
            before = jax.tree.map(np.array, params)
            out = step(params, opt_state, batch, key, epoch)
            _record(epochs, epoch, before, jax.tree.map(np.array, out[0]))
            return out

        return recorded

    monkeypatch.setattr(jloop, "make_online_train_step", patched)
    return epochs


def _moves(history, epochs):
    """Per epoch of history: (phase, the change of the poses from the
    epoch's first step to its last [F-1, K, 7], whether a field weight
    changed)."""
    out = []
    for h in history:
        before, after = epochs[h["epoch"]]
        d = after["poses"].astype(np.float64) - before["poses"]
        field = any(not np.array_equal(a, b) for a, b in
                    zip(jax.tree.leaves(before["nerf"]), jax.tree.leaves(after["nerf"])))
        out.append((h["phase"], d, field))
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test. The apps' tensors here are tiny, so a
    thread pool buys nothing, and when the suite's worker processes run
    side by side its spinning threads slow every one of them; one thread
    also keeps the port's float reductions independent of the machine's
    core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_scene_memo():
    """Each test reads its scene from its own cache directory."""
    jsyn._GEN_MEMO.clear()
    tsyn._GEN_MEMO.clear()
    yield
    jsyn._GEN_MEMO.clear()
    tsyn._GEN_MEMO.clear()


def _close(t, j, rtol=0.0, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def test_online_app_matches_startrax(tmp_path, monkeypatch):
    jcfg, tcfg = _configs(tmp_path, **PHASES)
    _shared_init(monkeypatch, jcfg)
    fed = _uniform_feed(monkeypatch, jcfg.seed)
    jepochs = _jax_epochs(monkeypatch)

    japp.train(jcfg)
    assert len(os.listdir(tmp_path / "cache")) == 1  # the JAX app wrote the scene
    # the port's first polish_pose epoch starts from the JAX app's params, so
    # that the polish's own optimizer (fresh moments, its LR) is held step
    # for step
    polish_pose = EXPECTED_PHASES.index("polish_pose")
    fed["reseed"][polish_pose] = jepochs[polish_pose][0]
    tout = tapp.train(tcfg, device="cpu")

    jdir, tdir = (str(tmp_path / p / "smoke" / "online") for p in ("jax", "torch"))
    jh, th = _history(jdir), _history(tdir)
    assert [h["phase"] for h in th] == [h["phase"] for h in jh] == EXPECTED_PHASES
    assert [h["window"] for h in th] == [h["window"] for h in jh]
    assert fed["steps"] == len(EXPECTED_PHASES) * PHASES["steps_per_epoch"]
    warm = [i for i, h in enumerate(jh) if h["phase"] in ("fieldform", "barf")]
    later = [i for i in range(len(jh)) if i not in warm]
    assert warm == [0, 1]
    for idx, rtol, atol in ((warm, 8e-5, 1e-5), (later, 4e-2, 1.4e-3)):
        _close([th[i]["fine"] for i in idx], [jh[i]["fine"] for i in idx], rtol=rtol,
               what="fine")
        for k in ("trans", "rot"):
            _close([th[i][k] for i in idx], [jh[i][k] for i in idx], atol=atol, what=k)
    assert [("score" in h) for h in th] == [("score" in h) for h in jh]
    _close([h["score"] for h in th if "score" in h], [h["score"] for h in jh if "score" in h],
           rtol=1.6e-2, what="score")
    assert th[1]["fine"] < th[0]["fine"]

    jrows, trows = _rows(jdir), _rows(tdir)
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    vals = [(t, j) for t, j in zip(trows, jrows) if "val/psnr" in j]
    assert len(vals) == 1  # epoch 4 (the run stops on the polish budget at epoch 8)
    for t, j in vals:
        assert abs(t["val/psnr"] - j["val/psnr"]) < 4e-2
        assert abs(t["val/ssim"] - j["val/ssim"]) < 1.3e-3
    jimg = sorted(os.listdir(os.path.join(jdir, "images")))
    assert sorted(os.listdir(os.path.join(tdir, "images"))) == jimg

    # the best-epoch snapshot and the final checkpoint exist; the final one
    # holds the returned params, which are the best epoch's
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    best_epoch = min((h for h in th if "score" in h), key=lambda h: h["score"])["epoch"]
    assert max(int(d) for d in os.listdir(os.path.join(tdir, "ckpts_best"))) == best_epoch
    final = tckpt.restore_checkpoint(os.path.join(tdir, "ckpts"), device="cpu")
    assert final["epoch"] == PHASES["epochs_online"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(final["params"]),
                                                 tree_leaves(tout)))
    best = tckpt.restore_checkpoint(os.path.join(tdir, "ckpts_best"), device="cpu")["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(best), tree_leaves(tout)))
    assert all(leaf.requires_grad and leaf.is_leaf for leaf in tree_leaves(tout))

    # each phase kind trains what it should, in both apps: the field phases
    # leave the translations bitwise and the quaternions to their
    # renormalisation's rounding (< 1.2e-7); BARF leaves the quaternions
    # bitwise; the pose-only phases leave every field weight bitwise; every
    # pose-updating phase moves the poses by more than 1e-4
    tm, jm = _moves(th, fed["epochs"]), _moves(jh, jepochs)
    for moves in (tm, jm):
        for phase, d, field in moves:
            assert field == (phase not in ("pose", "polish_pose")), phase
            if phase in ("fieldform", "polish_field"):
                assert not d[..., :3].any() and np.abs(d[..., 3:]).max() < 1.2e-7, phase
            else:
                assert np.abs(d).max() > 1e-4, phase
            if phase == "barf":
                assert not d[..., 3:].any()
    # and moves the poses as startrax's does: step for step in the first
    # pose-updating epoch (BARF) and in the re-seeded polish_pose epoch, by
    # the same mean amount in every pose-updating epoch
    for e, ((phase, d, _), (_, jd, _)) in enumerate(zip(tm, jm)):
        if e in (warm[-1], polish_pose):
            _close(d, jd, atol={"barf": 3.4e-5, "polish_pose": 2e-5}[phase], what=phase)
        if phase not in ("fieldform", "polish_field"):
            _close(np.abs(d).mean(), np.abs(jd).mean(), rtol=9e-2, what=phase)
