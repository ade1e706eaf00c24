"""The port's nerf_time app (train, _validate, test) against startrax's, on
the CPU.

Both apps train one tiny synthetic config from one set of weights (each
app's init_nerf_time patched to return one numpy tree), on the same batches
(FullQueuePrefetcher, one scene cache that the JAX app writes and the port
reads) and the same uniforms (the port's step gets the importance-sample
uniforms the JAX step draws from its key; perturb = 0 leaves no other
randomness), float32 on the plain field path. The port's step is
train.loop.make_nerf_time_train_step: tests/test_torch_nerf_time.py holds it
step by step against the JAX step_fn rebuilt as apps/nerf_time.py builds it,
and here the whole app's rows hold it against the app itself. Adam
amplifies float32 rounding (tests/test_torch_app_init.py); measured: the
epoch fine losses to 1.1e-5 relative, the validation PSNR to 2.5e-4 dB and
SSIM to 1.8e-5. Tolerances, ten times those: fine losses 1.1e-4 relative,
PSNR 2.5e-3 dB, SSIM 1.8e-4; the final parameters within 2 x lr x steps.

test() renders every held-out view and frame from one checkpoint (the same
tree saved by each package): every row within the test protocol's
tolerances of tests/test_torch_online_parts.py (PSNR 4e-4 dB, SSIM 2e-4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.apps import nerf_time as japp
from startrax.models import nerf_time as jnt
from startrax.train import checkpoint as jckpt
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import nerf_time as tapp
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import loop as tloop
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves
from test_torch_online import _fresh_scene_memo, _one_torch_thread  # noqa: F401
from test_torch_online_gauge import FullQueuePrefetcher
from test_torch_online_parts import TEST_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    expname="smoke", dataset_type="synthetic", num_frames=4, num_vehicles=1, near=2.0, far=8.0,
    scale_factor=-1.0, netdepth=2, netdepth_fine=2, netwidth=32, netwidth_fine=32,
    N_samples=8, N_importance=8, N_rand=64, steps_per_epoch=5, epochs_online=2, epoch_val=1,
    epoch_ckpt=1, mixed_precision=False, synth_height=16, synth_views=3, synth_val_views=2,
    num_workers=1, perturb=0.0, raw_noise_std=0.0, online_thres=1e-9)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _configs(tmp_path, **kw):
    cache = str(tmp_path / "cache")
    return (jconfig.Config(**{**CFG, **kw}, basedir=str(tmp_path / "jax"), synth_cache_dir=cache),
            tconfig.Config(**{**CFG, **kw}, basedir=str(tmp_path / "torch"),
                           synth_cache_dir=cache))


def _tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jnt.init_nerf_time(jax.random.PRNGKey(seed),
                                                       jconfig.star_config_from(jcfg)))


def _uniform_feed(monkeypatch, seed):
    """Give the port's nerf_time step the uniforms the JAX app's step draws:
    the app splits its key once a step and the render splits that into the
    stratified and importance keys."""
    make = tloop.make_nerf_time_train_step
    state = {"key": jax.random.PRNGKey(seed), "steps": 0}

    def patched(star_cfg, loss_cfg, opt, num_frames):
        step = make(star_cfg, loss_cfg, opt, num_frames)

        def fed(params, batch, generator=None):
            state["key"], sub = jax.random.split(state["key"])
            _, k_pdf = jax.random.split(sub)
            n = batch["rays_o"].shape[0]
            state["steps"] += 1
            return step(params, batch, u_pdf=torch.tensor(np.asarray(
                jax.random.uniform(k_pdf, (n, star_cfg.n_importance)))))

        return fed

    monkeypatch.setattr(tloop, "make_nerf_time_train_step", patched)
    return state


def test_nerf_time_app_matches_startrax(tmp_path, monkeypatch):
    jcfg, tcfg = _configs(tmp_path)
    tree = _tree(jcfg)
    monkeypatch.setattr(japp.nt, "init_nerf_time",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tapp.nt, "init_nerf_time",
                        lambda cfg, gen, dev: convert.params_from_numpy(tree, device=dev))
    for app in (japp, tapp):
        monkeypatch.setattr(app, "BatchPrefetcher", FullQueuePrefetcher)
    fed = _uniform_feed(monkeypatch, jcfg.seed)

    jout = japp.train(jcfg)
    tout = tapp.train(tcfg, device="cpu")
    assert fed["steps"] == 10

    dirs = [str(tmp_path / p / "smoke" / "nerf_time") for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [5, 5, 10, 10]
    losses = [(t["train/fine_loss"], j["train/fine_loss"]) for t, j in zip(trows, jrows)
              if "train/fine_loss" in j]
    vals = [(t, j) for t, j in zip(trows, jrows) if "val/psnr" in j]
    assert len(losses) == 2 and len(vals) == 2
    np.testing.assert_allclose(*zip(*losses), rtol=1.1e-4)
    assert losses[-1][0] < losses[0][0]
    for t, j in vals:
        assert abs(t["val/psnr"] - j["val/psnr"]) <= 2.5e-3
        assert abs(t["val/ssim"] - j["val/ssim"]) <= 1.8e-4
    assert sorted(os.listdir(os.path.join(dirs[1], "images"))) == sorted(
        os.listdir(os.path.join(dirs[0], "images")))
    assert sorted(os.listdir(os.path.join(dirs[1], "ckpts"))) == sorted(
        os.listdir(os.path.join(dirs[0], "ckpts")))
    restored = tckpt.restore_checkpoint(os.path.join(dirs[1], "ckpts"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]),
                                                  tree_leaves(tout)))
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * jcfg.lrate * 10)


def test_nerf_time_test_matches_startrax(tmp_path):
    jcfg, tcfg = _configs(tmp_path)
    tree = _tree(jcfg, seed=3)
    jpath, tpath = str(tmp_path / "jckpt"), str(tmp_path / "tckpt")
    jckpt.save_checkpoint(jpath, {"params": tree}, step=2)
    tckpt.save_checkpoint(tpath, {"params": convert.params_from_numpy(tree, device="cpu")},
                          step=2)
    jcfg, _ = _configs(tmp_path, test=True, online_ckpt_path=jpath, eval_last_frame=3)
    _, tcfg = _configs(tmp_path, test=True, online_ckpt_path=tpath, eval_last_frame=3)
    japp.test(jcfg)
    tapp.test(tcfg, device="cpu")

    jdir, tdir = (tmp_path / p / "smoke" / "nerf_time_test" for p in ("jax", "torch"))
    jrows, trows = _rows(str(jdir)), _rows(str(tdir))
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    assert len(trows) == 2 * (3 + 1)  # two held-out views: 3 frames and a mean each
    keys = set().union(*map(set, trows))
    for k in ("test/view0_frame_psnr", "test/view1_frame_ssim_dynamic", "test/view1_psnr_static"):
        assert k in keys, k
    for t, j in zip(trows, jrows):
        for k in j:
            if k.startswith("test/"):
                tol = next(v for part, v in TEST_TOL if part in k)
                assert np.isfinite(t[k]) and abs(t[k] - j[k]) <= tol, (k, t[k], j[k])
    assert sorted(os.listdir(tdir / "images")) == sorted(os.listdir(jdir / "images"))


def test_nerf_time_main_runs_test_from_the_config(tmp_path, monkeypatch):
    """main dispatches on cfg.test, through the argv parser."""
    calls = []
    monkeypatch.setattr(tapp, "test", lambda cfg: calls.append(("test", cfg.expname)))
    monkeypatch.setattr(tapp, "train", lambda cfg: calls.append(("train", cfg.expname)))
    config = os.path.join(ROOT, "startrax", "configs", "carla_nerf_time.txt")
    tapp.main(["--config", config])
    tapp.main(["--config", config, "--test", "true"])
    assert calls == [("train", "carla_nerf_time"), ("test", "carla_nerf_time")]


@pytest.mark.parametrize("entry", ["train", "test"])
def test_nerf_time_app_defaults_to_the_card(entry, tmp_path, monkeypatch):
    """Through main's argv parser: without a CUDA device the app raises and
    names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "startrax", "configs", "carla_nerf_time.txt")
    argv = ["--config", config, "--basedir", str(tmp_path)]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapp.main(argv + (["--test", "true"] if entry == "test" else []))
    assert os.listdir(tmp_path) == []


def test_nerf_time_test_refuses_lpips_weights(tmp_path):
    """LPIPS is not ported: a weights file that exists raises before a run
    directory is made, as the online app's test protocol does."""
    weights = tmp_path / "lpips.npz"
    weights.write_bytes(b"")
    _, tcfg = _configs(tmp_path, test=True, online_ckpt_path=str(tmp_path / "none"),
                       lpips_weights=str(weights))
    with pytest.raises(NotImplementedError, match="LPIPS"):
        tapp.test(tcfg, device="cpu")
    assert not os.path.exists(tmp_path / "torch")
