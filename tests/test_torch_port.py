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
- The tools observe an app's steps by patching its step builder
  (chip_smoke._patched): the patch wraps every step built inside its block
  and is undone after it, also when the block raises; and every app looks
  each builder the tools patch up through its module when it calls it
  (an ast scan), so that no step escapes the patch.
"""

import ast
import dataclasses
import glob
import importlib.util
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
from startrax_torch.train import loop, optim
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


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# each builder chip_smoke.py's step recorder and scripts/torch_online_reading.py
# patch, the other one, and the builder's arguments
BUILDERS = {
    "make_online_train_step": ("make_gauge_train_step",
                               lambda: (TINY, loop.LossConfig(), None)),
    "make_gauge_train_step": ("make_online_train_step",
                              lambda: (TINY, optim.make_gauge_optimizer(
                                  torch.zeros(2, 7, requires_grad=True), 1e-3))),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_patched_wraps_every_built_step_and_restores(chip_smoke, builder):
    """chip_smoke._patched(loop, builder, wrap): every step the builder
    builds inside the block is wrap(step), the other builder is left alone,
    and the builder is the original again after the block, also when the
    block raises. batch_kind, which the recorder files steps by, reads a
    batch's frame layout."""
    make = getattr(loop, builder)
    other, args = BUILDERS[builder][0], BUILDERS[builder][1]
    make_other = getattr(loop, other)
    wrapped = []

    def wrap(step):
        wrapped.append(step)
        return ("wrapped", step)

    with chip_smoke._patched(loop, builder, wrap):
        built = [getattr(loop, builder)(*args()) for _ in range(2)]
        assert getattr(loop, other) is make_other
    assert built == [("wrapped", step) for step in wrapped] and len(wrapped) == 2
    assert all(callable(step) for step in wrapped) and wrapped[0] is not wrapped[1]
    assert getattr(loop, builder) is make and callable(make(*args()))
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke._patched(loop, builder, wrap):
            raise RuntimeError("inside")
    assert getattr(loop, builder) is make and len(wrapped) == 2
    assert loop.batch_kind({"frame": 3}) == "shared"
    assert loop.batch_kind({"frame": torch.zeros(4, dtype=torch.int32)}) == "per_ray"


# (app, the module that holds what the tools patch, its name): the step
# builders that chip_smoke.py and scripts/torch_online_reading.py patch to
# observe an app's steps, and the grid update that chip_smoke.py times
PATCHED = [("online", "train.loop", "make_online_train_step"),
           ("online", "train.loop", "make_gauge_train_step"),
           ("app_init", "train.loop", "make_appinit_train_step"),
           ("nerf_time", "train.loop", "make_nerf_time_train_step"),
           ("occgrid_init", "apps.occgrid_init", "make_train_step"),
           ("occgrid_init", "kernels.occgrid", "update_grid"),
           ("mip", "apps.mip", "make_train_step")]


@pytest.mark.parametrize("app, module, name", PATCHED, ids=[f"{a}.{n}" for a, _, n in PATCHED])
def test_apps_look_patched_builders_up_when_they_call_them(app, module, name):
    """The app never imports the name itself (from ... import name), and
    every reference to it is a call, inside a function, of module.name (or,
    for a name of the app's own module, of the module-level name): a name
    bound at import time would keep the original past a patch."""
    path = os.path.join(ROOT, "startrax_torch", "apps", f"{app}.py")
    tree = ast.parse(open(path).read(), filename=path)
    package, _, leaf = module.rpartition(".")
    own = module == f"apps.{app}"
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    imports = [node for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert [node.lineno for node in imports if any(a.name == name for a in node.names)] == []
    if own:
        assert any(isinstance(node, ast.FunctionDef) and node.name == name for node in tree.body)
        refs = [node for node in ast.walk(tree) if isinstance(node, ast.Name) and node.id == name]
    else:
        aliases = {a.asname or a.name for node in imports if node.level == 2
                   and node.module == package for a in node.names if a.name == leaf}
        assert aliases, f"{app} imports no {module}"
        refs = [node for node in ast.walk(tree) if isinstance(node, ast.Attribute)
                and node.attr == name and isinstance(node.value, ast.Name)
                and node.value.id in aliases]
    assert refs, f"{app} never calls {name}"
    for ref in refs:
        call = parents[ref]
        assert isinstance(call, ast.Call) and call.func is ref, f"{app}.py:{ref.lineno}"
        scope = parents[call]
        while not isinstance(scope, (ast.FunctionDef, ast.Module)):
            scope = parents[scope]
        assert isinstance(scope, ast.FunctionDef), f"{app}.py:{ref.lineno} runs at import time"
