"""The port stands alone and runs on the card by default.

- No module of startrax_torch, and not chip_smoke.py, imports jax, the JAX
  package or an image library (imageio, PIL, cv2; the port reads and writes
  PNG files itself): an ast scan of every import statement.
- The port's own config parser reads every file in startrax/configs/ into
  the same field values as startrax.utils.config, except that an
  Optional[bool] flag (use_fused) is parsed strictly.
- Every entry point that makes tensors raises without a device where there
  is no CUDA device, and runs with device="cpu"; so do the apps' train and
  test functions, before they make a run directory.
"""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import mip as mip_app
from startrax_torch.apps import nerf_time as nerf_time_app
from startrax_torch.apps import occgrid_init
from startrax_torch.eval import render
from startrax_torch.kernels import occgrid
from startrax_torch.models import fields, mip, nerf_time, star, star_occgrid
from startrax_torch.ops import rays
from startrax_torch.train import loop
from startrax_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "startrax", "configs", "*.txt")))
TINY = star.StarConfig(num_vehicles=2, netdepth=2, netdepth_fine=2, netwidth=16,
                       netwidth_fine=16, n_samples=4, n_importance=4)
TINY_MIP = mip.MipConfig(num_vehicles=2, depth=2, width=16, num_freqs_pos=2, num_freqs_dir=2,
                         n_samples=4, n_importance=4)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "startrax_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "startrax", "optax", "chex", "flax", "imageio",
                                  "PIL", "cv2")]
    assert bad == []
    for module in ("kernels/occgrid.py", "models/star_occgrid.py", "apps/occgrid_init.py",
                   "apps/nerf_time.py", "data/carla.py", "data/blender.py", "apps/lego.py",
                   "models/mip.py", "apps/mip.py", "parallel/mesh.py", "parallel/dryrun.py",
                   "utils/mesh.py", "utils/profiling.py", "utils/vis.py"):
        assert os.path.join(ROOT, "startrax_torch", module) in files, module


def test_config_fields_match_startrax():
    tf = {f.name: (str(f.type), f.default) for f in dataclasses.fields(tconfig.Config)}
    jf = {f.name: (str(f.type), f.default) for f in dataclasses.fields(jconfig.Config)}
    assert tf == jf


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_files_parse_as_startrax_does(path):
    t = dataclasses.asdict(tconfig.Config(**tconfig.parse_config_file(path)))
    j = dataclasses.asdict(jconfig.Config(**jconfig.parse_config_file(path)))
    j["use_fused"] = tconfig.parse_bool(j["use_fused"])
    assert t == j
    assert tconfig.star_config_from(tconfig.Config(**tconfig.parse_config_file(path)))


def test_config_count_and_strict_use_fused(tmp_path):
    assert len(CONFIGS) == 19
    path = tmp_path / "c.txt"
    path.write_text("netwidth = 128  # comment\nuse_fused = 0\nlrate_decay_steps = [80, 120]\n"
                    "lrate_decay = 3.0\nwhite_bkgd = yes\nunknown_key = 1\n")
    cfg = tconfig.Config(**tconfig.parse_config_file(str(path)))
    assert (cfg.netwidth, cfg.use_fused, cfg.lrate_decay_steps, cfg.lrate_decay,
            cfg.white_bkgd) == (128, False, [80, 120], 3, True)
    assert jconfig.parse_config_file(str(path))["use_fused"] == "0"  # the reference's raw string
    assert tconfig.star_config_from(cfg).use_fused is False
    cfg = tconfig.load_config(["--config", str(path), "--use_fused", "1", "--N_rand", "64",
                               "--white_bkgd"])
    assert (cfg.use_fused, cfg.N_rand, cfg.white_bkgd, cfg.config) == (True, 64, True, str(path))
    with pytest.raises(ValueError):
        tconfig.load_config(["--no_such_flag", "1"])
    with pytest.raises(ValueError):
        tconfig.parse_bool("maybe")
    tconfig.save_config(cfg, str(tmp_path / "run"))
    assert (tmp_path / "run" / "args.json").exists()


ENTRY_POINTS = {
    "init_field": lambda device: fields.init_field(TINY.static_field(), device=device),
    "init_stacked_fields": lambda device: fields.init_stacked_fields(TINY.dynamic_field(), 2,
                                                                     device=device),
    "init_star": lambda device: star.init_star(TINY, device=device),
    "init_online_params": lambda device: loop.init_online_params(TINY, 3, device=device),
    "init_nerf_time": lambda device: nerf_time.init_nerf_time(TINY, device=device),
    "init_star_occgrid": lambda device: star_occgrid.init_star_occgrid(TINY, device=device),
    "init_grid": lambda device: occgrid.init_grid(occgrid.OccGridConfig(resolution=4),
                                                  device=device)["density_ema"],
    "params_from_numpy": lambda device: convert.params_from_numpy(
        {"w": np.ones((2, 3), np.float32)}, device=device),
    "get_rays": lambda device: rays.get_rays(4, 5, np.eye(3, dtype=np.float32),
                                             np.eye(4, dtype=np.float32), device=device),
    "render_image_nerf_time": lambda device: torch.as_tensor(render.render_image_nerf_time(
        nerf_time.init_nerf_time(TINY, device="cpu"), TINY,
        *rays.get_rays_np(2, 3, np.eye(3), np.eye(4)), 1, 4, device=device)["rgb"]),
    "init_star_mip": lambda device: mip.init_star_mip(TINY_MIP, device=device),
    "render_image_mip": lambda device: torch.as_tensor(render.render_image_mip(
        mip.init_star_mip(TINY_MIP, device="cpu"), TINY_MIP,
        *rays.get_rays_np(2, 3, np.eye(3), np.eye(4)), device=device)["rgb"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a device an entry point asks for the card: where there is none
    it raises and names device="cpu"; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](None)
    out = ENTRY_POINTS[name]("cpu")
    leaves = out if isinstance(out, tuple) else [out]
    from startrax_torch.utils.tree import tree_leaves

    assert all(t.device.type == "cpu" for t in tree_leaves(list(leaves)))


APPS = {"occgrid_init.train": occgrid_init.train, "nerf_time.train": nerf_time_app.train,
        "nerf_time.test": nerf_time_app.test, "mip.train_app_init": mip_app.train_app_init,
        "mip.train_online": mip_app.train_online, "mip.test": mip_app.test}


@pytest.mark.parametrize("name", sorted(APPS))
def test_app_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """An app run without a device asks for the card: where there is none it
    raises, names device="cpu" and makes no run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.Config(basedir=str(tmp_path), dataset_type="synthetic")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        APPS[name](cfg)
    assert os.listdir(tmp_path) == []
