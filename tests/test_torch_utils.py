"""The port's eval-only utilities against startrax's, on the CPU.

- utils/mesh: marching tetrahedra, the density grid, extract_mesh,
  extract_color_mesh and save_obj on the same grids and callables: vertices
  and faces equal, the OBJ files' bytes equal. The port's callables may
  return tensors (models.fields.query_density, query_rgb).
- models/fields.query_density, query_opacity, query_rgb through converted
  weights, float32 on the plain field path: within 1e-5 (float32 rounding
  of one MLP).
- utils/vis: the colormaps, composition and projection equal to startrax's;
  draw_box against cv2.line as the oracle (cv2 is on this box, not on the
  card's machine), and equal to startrax's draw_box, which calls it;
  visualize_depth_with_values is the unannotated colormap.
- utils/profiling: StepTimer's rate, trace's Chrome file, the NaN checks.
- utils/logging.write_gif read back with PIL and imageio: each frame equal
  to the frames mapped to the GIF's palette, exact where the frames hold at
  most 256 colours.
"""

import json

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from startrax.models import fields as jfields
from startrax.utils import mesh as jmesh
from startrax.utils import vis as jvis
from startrax_torch import convert
from startrax_torch.models import fields as tfields
from startrax_torch.utils import logging as tlogging
from startrax_torch.utils import mesh as tmesh
from startrax_torch.utils import profiling
from startrax_torch.utils import vis as tvis


def _grid(kind, n):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    if kind == "sphere":
        return 0.6 - np.linalg.norm(g, axis=-1)
    if kind == "torus":
        q = np.stack([np.linalg.norm(g[..., :2], axis=-1) - 0.5, g[..., 2]], -1)
        return 0.2 - np.linalg.norm(q, axis=-1)
    return np.random.default_rng(0).normal(size=(n, n, n))


@pytest.mark.parametrize("kind, n, level", [("sphere", 32, 0.0), ("torus", 28, 0.0),
                                            ("noise", 12, 0.3), ("sphere", 9, 2.0)])
def test_marching_tetrahedra_matches_startrax(kind, n, level):
    grid = _grid(kind, n)
    jv, jf = jmesh.marching_tetrahedra(grid, level, bounds=(-1, 1))
    tv, tf = tmesh.marching_tetrahedra(grid, level, bounds=(-1, 1))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert (len(tv) > 0) == (kind != "sphere" or level < 0.6)


def test_extract_meshes_write_startrax_obj_bytes(tmp_path):
    """A numpy density for startrax, the same density as a tensor for the
    port; the grids, meshes and OBJ files equal, colours included."""
    def density(pts):
        return 100.0 * (np.linalg.norm(pts, axis=-1) < 0.5) + pts[:, 0]

    def rgb(pts):
        return np.clip(0.5 + pts, 0.0, 1.0)

    np.testing.assert_array_equal(
        tmesh.eval_density_grid(lambda p: torch.from_numpy(density(p)), 20, chunk=1000),
        jmesh.eval_density_grid(density, 20, chunk=1000))
    for ext, args in (("extract_mesh", (density,)), ("extract_color_mesh", (density, rgb))):
        paths = [str(tmp_path / f"{ext}_{side}.obj") for side in ("jax", "torch")]
        jout = getattr(jmesh, ext)(*args, paths[0], resolution=24, sigma_threshold=50.0)
        targs = [lambda p, f=f: torch.from_numpy(np.asarray(f(p), np.float32)) for f in args]
        tout = getattr(tmesh, ext)(*targs, paths[1], resolution=24, sigma_threshold=50.0)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a, b)
        assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
        assert len(jout[0]) > 0


def test_field_queries_match_startrax():
    jcfg = jfields.FieldConfig(depth=4, width=32, compute_dtype=jnp.float32)
    tcfg = tfields.FieldConfig(depth=4, width=32, compute_dtype=torch.float32)
    jparams = jfields.init_field(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    pairs = [
        (tfields.query_density(tparams, tcfg, tp), jfields.query_density(jparams, jcfg, pts)),
        (tfields.query_opacity(tparams, tcfg, tp, 0.01),
         jfields.query_opacity(jparams, jcfg, pts, 0.01)),
        (tfields.query_rgb(tparams, tcfg, tp), jfields.query_rgb(jparams, jcfg, pts)),
        (tfields.query_rgb(tparams, tcfg, tp, td), jfields.query_rgb(jparams, jcfg, pts, dirs)),
    ]
    for t, j in pairs:
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_mesh_of_a_field_through_its_query():
    """extract_mesh over query_density: the grid the port builds from the
    field equals the grid startrax builds from its own field, within the
    queries' 1e-5."""
    jcfg = jfields.FieldConfig(depth=4, width=32, compute_dtype=jnp.float32)
    tcfg = tfields.FieldConfig(depth=4, width=32, compute_dtype=torch.float32)
    jparams = jfields.init_field(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tgrid = tmesh.eval_density_grid(
        lambda p: tfields.query_density(tparams, tcfg, torch.from_numpy(p)), 12, chunk=500)
    jgrid = jmesh.eval_density_grid(
        lambda p: jfields.query_density(jparams, jcfg, jnp.asarray(p)), 12, chunk=500)
    np.testing.assert_allclose(tgrid, jgrid, rtol=1e-5, atol=1e-6)


def test_vis_helpers_match_startrax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, (9, 11))
    np.testing.assert_array_equal(tvis._jet(x), jvis._jet(x))
    d = rng.uniform(2, 6, (16, 12)).astype(np.float32)
    for args in ((), (1.0, 8.0)):
        np.testing.assert_array_equal(tvis.visualize_depth(d, *args),
                                      jvis.visualize_depth(d, *args))
        np.testing.assert_array_equal(tvis.visualize_depth(np.stack([d, d]), *args),
                                      jvis.visualize_depth(np.stack([d, d]), *args))
    s, dyn = rng.uniform(size=(8, 8, 3)), rng.uniform(size=(2, 8, 8, 3))
    for dd in (dyn, dyn[0]):
        np.testing.assert_array_equal(tvis.compose_static_dynamic(s, dd),
                                      jvis.compose_static_dynamic(s, dd))
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, -0.3]
    pts = rng.normal(size=(20, 3)) + [0, 0, -5]
    np.testing.assert_array_equal(tvis.project_points(pts, K, w2c),
                                  jvis.project_points(pts, K, w2c))
    want = (tvis.visualize_depth(d) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tvis.visualize_depth_with_values(d), want)


def test_draw_box_matches_cv2_line():
    """Boxes inside, across and outside the image's edges: the port's
    raster equals cv2.line(img, pa, pb, color, 1) edge by edge, and the
    whole box equals startrax's draw_box (which calls cv2)."""
    rng = np.random.default_rng(4)
    for trial in range(60):
        h, w = rng.integers(8, 70, 2)
        centre = rng.uniform(-20, 90, 2)
        size = rng.uniform(2, 60, 2)
        corners = np.array([[centre[0] + size[0] * (((c >> 0) & 1) - 0.5)
                             + rng.uniform(-5, 5),
                             centre[1] + size[1] * (((c >> 1) & 1) - 0.5)
                             + 3 * ((c >> 2) & 1)] for c in range(8)])
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        oracle = img.copy()
        for a, b in tvis._BOX_EDGES:
            cv2.line(oracle, tuple(int(v) for v in np.round(corners[a]).astype(int)),
                     tuple(int(v) for v in np.round(corners[b]).astype(int)), (0, 255, 0), 1)
        np.testing.assert_array_equal(tvis.draw_box(img.copy(), corners), oracle)
        np.testing.assert_array_equal(jvis.draw_box(img.copy(), corners), oracle)


def test_step_timer_reports_rate():
    t = profiling.StepTimer(sync_every=5)
    loss = torch.tensor(1.0)
    for _ in range(11):
        rate = t.tick(loss, n_rays=100)
    assert rate == t.rays_per_sec and np.isfinite(rate) and rate > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    events = json.load(open(tmp_path / profiling.TRACE_FILE))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(a.key == "aten::mm" for a in prof.key_averages())


def test_enable_nan_checks():
    old = np.geterr()
    try:
        profiling.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            np.float32(1.0) / np.float32(0.0)
    finally:
        torch.autograd.set_detect_anomaly(False)
        np.seterr(**old)


@pytest.mark.parametrize("shape, colours", [
    ((1, 1, 1), 1), ((3, 5, 7), 2), ((4, 33, 17), 5), ((2, 64, 64), 200), ((3, 40, 50), 256),
    ((5, 97, 83), 257), ((2, 128, 128), None)],
    ids=["one_pixel", "two", "five", "200", "256", "257", "random"])
def test_write_gif_reads_back(tmp_path, shape, colours):
    rng = np.random.default_rng(5)
    if colours is None:
        frames = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    else:
        frames = rng.integers(0, 256, (colours, 3), dtype=np.uint8)[rng.integers(0, colours,
                                                                                  shape)]
    path = str(tmp_path / "v.gif")
    tlogging.write_gif(path, list(frames), duration_ms=250, loop=0)
    palette, idx = tlogging._gif_palette(frames)
    want = palette[idx]
    if colours is not None and colours <= 256:
        np.testing.assert_array_equal(want, frames)
    im = Image.open(path)
    assert (im.n_frames, im.info["duration"], im.info["loop"]) == (shape[0], 250, 0)
    for i in range(shape[0]):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want[i])
    got = np.stack([np.asarray(f)[..., :3] for f in imageio.mimread(path)])
    np.testing.assert_array_equal(got, want)


def test_write_gif_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        tlogging.write_gif(str(tmp_path / "x.gif"), [np.zeros((4, 4, 3), np.float32)])
    with pytest.raises(ValueError, match="uint8"):
        tlogging.write_gif(str(tmp_path / "x.gif"), [np.zeros((4, 4), np.uint8)])
