"""The port's appearance-init app against startrax's, on the CPU.

Both apps train a tiny synthetic config (tests/test_apps.py's shape at a
24x24 scene) from one set of weights (each app module's ``init_star``
patched to return one numpy tree), on the same batches (one prefetch worker,
the same seed, one scene cache that the JAX app writes and the port reads)
and the same uniforms (the port's step gets the importance-sample uniforms
that the JAX step draws from its key; perturb = 0 and raw_noise_std = 0
leave no other randomness). Both run in float32 on the plain field path, so
the two ``metrics.jsonl`` files differ only by float32 rounding, amplified
by Adam: its first update is lr * sign(g) for every gradient far above eps,
so a rounding-level difference on a near-zero gradient flips a whole
lr-sized step (tests/test_torch_train.py). Measured: the epoch fine losses
agree to 4.4e-5 relative, the validation PSNR to 4.3e-4 dB and SSIM to
4.4e-5. Tolerances, ten times those: the fine losses within 5e-4 relative,
PSNR within 5e-3 dB, SSIM within 5e-4 absolute; the final parameters within
2 x lr x steps (test_torch_train.py's bound).

Also: the app's eval render (train.loop.make_eval_render) against
startrax's, and the app's refusals (data_parallel = on with one rank, no CUDA
device).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from startrax.apps import app_init as japp
from startrax.train import loop as jloop
from startrax.models.star import init_star as jinit_star
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import app_init as tapp
from startrax_torch.models.star import StarConfig
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import loop as tloop
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    expname="smoke", dataset_type="synthetic", num_frames=6, num_vehicles=1, near=2.0, far=8.0,
    scale_factor=-1.0, netdepth=4, netdepth_fine=4, netwidth=32, netwidth_fine=32,
    N_samples=12, N_importance=12, N_rand=128, steps_per_epoch=10, epochs_appearance=2,
    epoch_val=1, mixed_precision=False, synth_height=24, synth_views=4, synth_val_views=2,
    num_workers=1, data_parallel="off", perturb=0.0, raw_noise_std=0.0,
    appearance_init_thres=1e-9, car_sample_ratio=0.25)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _uniform_feed(monkeypatch, seed):
    """Give the port's app-init step the uniforms the JAX app's step draws:
    the JAX app splits its key once a step (key, sub = split(key)) and its
    render splits sub into the stratified, importance and noise keys."""
    make = tloop.make_appinit_train_step

    def patched(star_cfg, loss_cfg, opt):
        step = make(star_cfg, loss_cfg, opt)
        state = {"key": jax.random.PRNGKey(seed)}

        def fed(params, batch, generator=None):
            state["key"], sub = jax.random.split(state["key"])
            _, k_pdf, _ = jax.random.split(sub, 3)
            n = batch["rays_o"].shape[0]
            u_pdf = torch.tensor(np.asarray(jax.random.uniform(k_pdf, (n, star_cfg.n_importance))))
            return step(params, batch, u_pdf=u_pdf)

        return fed

    monkeypatch.setattr(tloop, "make_appinit_train_step", patched)


def test_app_init_matches_startrax(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    jcfg = jconfig.Config(**CFG, basedir=str(tmp_path / "jax"), synth_cache_dir=cache)
    tcfg = tconfig.Config(**CFG, basedir=str(tmp_path / "torch"), synth_cache_dir=cache)
    jparams = jinit_star(jax.random.PRNGKey(0), jconfig.star_config_from(jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(japp, "init_star", lambda key, cfg: jparams)
    monkeypatch.setattr(tapp, "init_star",
                        lambda cfg, gen, dev: convert.params_from_numpy(tree, device=dev))
    _uniform_feed(monkeypatch, jcfg.seed)

    jout = japp.train(jcfg)
    assert len(os.listdir(cache)) == 1  # the JAX app wrote the scene; the port reads it
    tout = tapp.train(tcfg, device="cpu")

    jrows = _rows(str(tmp_path / "jax" / "smoke" / "app_init"))
    trows = _rows(str(tmp_path / "torch" / "smoke" / "app_init"))
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    losses = [(t["train/fine_loss"], j["train/fine_loss"]) for t, j in zip(trows, jrows)
              if "train/fine_loss" in j]
    vals = [(t, j) for t, j in zip(trows, jrows) if "val/psnr" in j]
    assert len(losses) == 2 and len(vals) == 2
    np.testing.assert_allclose(*zip(*losses), rtol=5e-4)
    for t, j in vals:
        assert abs(t["val/psnr"] - j["val/psnr"]) < 5e-3
        assert abs(t["val/ssim"] - j["val/ssim"]) < 5e-4
    assert losses[-1][0] < losses[0][0]

    # the same image files, and the final checkpoint holds the returned params
    jimg = sorted(os.listdir(tmp_path / "jax" / "smoke" / "app_init" / "images"))
    timg = sorted(os.listdir(tmp_path / "torch" / "smoke" / "app_init" / "images"))
    assert timg == jimg and len(timg) == 4
    ckpts = str(tmp_path / "torch" / "smoke" / "app_init" / "ckpts")
    restored = tckpt.restore_checkpoint(ckpts, device="cpu")["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(tout)))
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * jcfg.lrate * 2 * jcfg.steps_per_epoch)


@pytest.mark.parametrize("setting", ["on", "sideways"])
def test_app_init_refuses_data_parallel(setting, tmp_path):
    cfg = tconfig.Config(**dict(CFG, data_parallel=setting), basedir=str(tmp_path))
    # on: startrax's RuntimeError, there being one rank (no launcher)
    err = RuntimeError if setting == "on" else ValueError
    with pytest.raises(err, match="only one device is visible" if setting == "on"
                       else "auto/on/off"):
        tapp.train(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "smoke")


def test_app_init_defaults_to_the_card(tmp_path, monkeypatch):
    """Through main's argv parser: without a CUDA device the app raises and
    names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "startrax", "configs", "synthetic_star_online_scaled.txt")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapp.main(["--config", config, "--basedir", str(tmp_path), "--epochs_appearance", "1"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("with_pose", [False, True], ids=["appinit", "online"])
def test_make_eval_render_matches_startrax(with_pose):
    """The eval render the app validates with, against startrax's, on the
    tiny flagship shape in float32: within 1e-4 (relative and absolute), as
    tests/test_torch_star.py holds the eval render; no graph is kept."""
    jcfg = _flagship_cfg(tiny=True)
    tcfg = StarConfig(**dict(dataclasses.asdict(jcfg), compute_dtype=torch.float32))
    tree = jax.tree.map(np.asarray, jinit_star(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    rays_o = rng.normal(size=(6, 3)).astype(np.float32)
    rays_d = rng.normal(size=(6, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    pose = None
    if with_pose:
        q = rng.normal(size=(jcfg.num_vehicles, 4)).astype(np.float32)
        pose = np.concatenate([0.2 * rng.normal(size=(jcfg.num_vehicles, 3)),
                               q / np.linalg.norm(q, axis=-1, keepdims=True)], -1)
        pose = pose.astype(np.float32)
    out_j = jloop.make_eval_render(jcfg)(jax.tree.map(jax.numpy.asarray, tree), rays_o, rays_d,
                                         pose)
    params = convert.params_from_numpy(tree, device="cpu", requires_grad=True)
    out_t = tloop.make_eval_render(tcfg)(params, torch.tensor(rays_o), torch.tensor(rays_d),
                                         None if pose is None else torch.tensor(pose))
    for k in ("rgb", "rgb0", "depth", "acc"):
        assert not out_t[k].requires_grad
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
