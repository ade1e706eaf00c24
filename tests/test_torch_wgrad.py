"""The host side of the backward's weight-gradient GEMM and ordered sums, on
the CPU.

One launch of ``wgrad_kernel`` covers every (field, wide layer, row tile,
split) of a backward call, from a layer table that the Python wrapper builds
(``fused_mlp.wgrad_layout``, ``_WgTable``) and passes by value. These tests
decode every CTA of such a launch by the rule the kernel follows and hold the
table to it: each output element of each layer and field is computed by
exactly one CTA a split, the splits partition the points, and the ctypes
mirror of the table has the layout of the CUDA struct (read from the source,
as test_torch_pack.py reads the descriptor's constants). The grouped plain
version, which the card holds the kernel to, is the per-layer one side by
side, and the sums' chunking fills the card within its limits.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from startrax_torch.kernels import fused_mlp as fm

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "startrax_torch",
                   "kernels", "csrc", "fused_mlp.cu")

# (width, n_blocks, lin_in's rows, fields, points per field) of every path's
# backward calls: shared-pose static and dynamic (coarse and fine), per-ray
# static and stacked K = 2 dynamic, nerf_time's pre-encoded fields
PATHS = [(256, 4, 64, 1, 256000), (256, 4, 64, 1, 512000), (256, 2, 64, 1, 256000),
         (256, 2, 64, 1, 512000), (128, 4, 64, 1, 131072), (128, 4, 64, 1, 262144),
         (128, 2, 64, 2, 131072), (128, 2, 64, 2, 262144), (256, 4, 96, 1, 256000),
         (256, 4, 96, 1, 512000)]


def _source():
    with open(SRC) as fp:
        return re.sub(r"//[^\n]*", "", fp.read())


def _decode(lay, bid):
    """(layer, split, row tile) of CTA bid along the grid's x axis, as
    wgrad_kernel finds them: the first layer whose tile0 * splits is past
    bid is the next one, and a layer's CTAs run split by split, each split's
    row tiles side by side."""
    layers, splits = lay["layers"], lay["splits"]
    li = 0
    while li + 1 < len(layers) and bid >= layers[li + 1][4] * splits:
        li += 1
    k_in, _, _, _, tile0 = layers[li]
    rows = -(-k_in // fm.WG_ROWS)
    local = bid - tile0 * splits
    return li, local // rows, local % rows


@pytest.mark.parametrize("width,n_blocks,in_rows,fields,n", PATHS[::2] + [(128, 2, 96, 2, 3000)])
def test_every_output_element_is_one_cta_tiles(width, n_blocks, in_rows, fields, n):
    shapes = fm.wgrad_shapes(width, n_blocks, in_rows)
    lay = fm.wgrad_layout(shapes, n, fields)
    splits = lay["splits"]
    # every field runs the same grid along x (the field is the grid's y)
    covered = {(li, s): np.zeros(k_in, dtype=int) for li, (k_in, _, _) in enumerate(shapes)
               for s in range(splits)}
    for bid in range(lay["tiles"] * splits):
        li, split, rt = _decode(lay, bid)
        assert 0 <= split < splits
        k_in = shapes[li][0]
        covered[(li, split)][rt * fm.WG_ROWS:min(k_in, (rt + 1) * fm.WG_ROWS)] += 1
    assert all((c == 1).all() for c in covered.values())
    # the layers' partials sit side by side in a split's row, in table order
    wofs = [entry[3] for entry in lay["layers"]]
    assert wofs == list(np.cumsum([0] + [k * m for k, _, m in shapes])[:-1])
    assert lay["wtotal"] == sum(k * m for k, _, m in shapes)
    assert [entry[:3] for entry in lay["layers"]] == [(k, m, int(r)) for k, r, m in shapes]


@pytest.mark.parametrize("n", [0, 1, 1023, 3000, 131072, 256000, 262144, 512000])
def test_splits_partition_the_points(n):
    for width, n_blocks, in_rows, fields, _ in PATHS:
        lay = fm.wgrad_layout(fm.wgrad_shapes(width, n_blocks, in_rows), n, fields)
        splits = lay["splits"]
        bounds = fm.wgrad_split_bounds(n, splits)
        assert len(bounds) == splits >= 1
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a <= b for a, b in bounds)
        assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
        assert all(b - a <= lay["per_split"] for a, b in bounds)
        assert splits * lay["per_split"] >= n
        # a split at least 1,024 points; at most two waves of one CTA an SM
        assert splits == 1 or n // splits >= 1024
        assert fields * lay["tiles"] * splits <= max(2 * fm.SMS, fields * lay["tiles"])


def test_every_path_fills_the_card():
    for width, n_blocks, in_rows, fields, n in PATHS:
        lay = fm.wgrad_layout(fm.wgrad_shapes(width, n_blocks, in_rows), n, fields)
        ctas = fields * lay["tiles"] * lay["splits"]
        assert 1.5 * fm.SMS <= ctas <= 2 * fm.SMS, (width, n_blocks, fields, n, ctas)


_CTYPES = {"const bf16*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}


def _struct_fields(src, name):
    """[(field, ctypes type or (element struct, count))] of a struct in
    the CUDA source, in declaration order."""
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.fullmatch(r"(\w+) (\w+)\[(\w+)\]", decl)
        if m:
            out.append((m.group(2), (m.group(1), m.group(3))))
            continue
        m = re.fullmatch(r"(const bf16\*|long long|int) (.+)", decl)
        assert m, decl
        out += [(f.strip(), _CTYPES[m.group(1)]) for f in m.group(2).split(",")]
    return out


def _consts(src):
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr, {}, dict(consts))  # noqa: S307 - the source's own constants
    return consts


def test_layer_table_matches_the_cuda_source():
    src = _source()
    consts = _consts(src)
    assert (consts["WG_MAXL"], consts["WG_ROWS"], consts["SR_COLS"]) == (
        fm.WG_MAXL, fm.WG_ROWS, fm.SUM_COLS)
    for struct, name in ((fm._WgLayer, "WgLayer"), (fm._WgTable, "WgTable")):
        want = []
        for field, kind in _struct_fields(src, name):
            if isinstance(kind, tuple):
                elem, count = kind
                assert elem == "WgLayer" and consts[count] == fm.WG_MAXL
                want.append((field, fm._WgLayer, fm.WG_MAXL))
            else:
                want.append((field, kind))
        got = []
        for field, ctype in struct._fields_:
            if hasattr(ctype, "_length_"):
                got.append((field, ctype._type_, ctype._length_))
            else:
                got.append((field, ctype))
        assert got == want, name


@pytest.mark.parametrize("fields", [1, 2])
def test_grouped_plain_is_the_layers_side_by_side(fields):
    rng = np.random.default_rng(fields)
    n = 3000
    shapes = fm.wgrad_shapes(128, 1, 96)

    def bf(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(torch.bfloat16)

    xs = [bf(fields, n, k) for k, _, _ in shapes]
    dys = [bf(fields, n, m) for _, _, m in shapes]
    relus = [r for _, r, _ in shapes]
    lay = fm.wgrad_layout(shapes, n, fields)
    got = fm.wgrad(xs, dys, relus)
    assert got.shape == (fields, lay["splits"], lay["wtotal"])
    for (k, relu, m), X, dY, (_, _, _, wofs, _) in zip(shapes, xs, dys, lay["layers"]):
        layer = fm.wgrad_plain(X, relu, dY, lay["splits"])
        assert torch.equal(got[..., wofs:wofs + k * m], layer)
    dw = fm.sum_rows(got)
    X, dY = xs[1], dys[1]
    want = X.float().clamp(min=0).transpose(1, 2) @ dY.float()
    wofs = lay["layers"][1][3]
    torch.testing.assert_close(dw[:, wofs:wofs + 128 * 128].reshape(fields, 128, 128), want,
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rows,cols,fields", [(8000, 3600, 1), (11, 712704, 1), (4096, 1296, 2),
                                              (47, 2576, 1), (3, 64, 2)])
def test_sum_chunks_fill_the_card_within_their_limits(rows, cols, fields):
    chunks = fm.sum_rows_chunks(rows, cols, fields)
    assert 1 <= chunks <= fm.SUM_MAX_CHUNKS
    assert chunks == 1 or rows // chunks >= 8
    slabs = -(-cols // fm.SUM_COLS)
    if chunks < min(fm.SUM_MAX_CHUNKS, rows // 8):
        assert fields * slabs * chunks >= fm.SUM_CTAS
    src = torch.tensor(np.random.default_rng(rows).normal(size=(fields, rows, cols)),
                       dtype=torch.float32)
    torch.testing.assert_close(fm.sum_rows(src), src.double().sum(1).float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [524288, 1048576, 2097152])
def test_long_calls_cap_the_points_a_split(n):
    """Above WG_SPLIT_ROWS points a split the rule adds splits, so that no
    split's f32 accumulation runs longer than at the shapes the GEMM was
    held at (the occgrid app's 256- and 512-sample budgets, 4096 rays);
    the splits still partition the points."""
    for width, n_blocks, in_rows, fields, _ in PATHS + [(256, 4, 64, 2, n)]:
        lay = fm.wgrad_layout(fm.wgrad_shapes(width, n_blocks, in_rows), n, fields)
        bounds = fm.wgrad_split_bounds(n, lay["splits"])
        assert max(b - a for a, b in bounds) <= lay["per_split"] <= fm.WG_SPLIT_ROWS
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    # the paths the two-wave rule set are unchanged
    for width, n_blocks, in_rows, fields, m in PATHS:
        tiles = fields * fm.wgrad_layout(fm.wgrad_shapes(width, n_blocks, in_rows), m,
                                         fields)["tiles"]
        assert fm.wgrad_splits(m, tiles) == max(1, min(2 * fm.SMS // tiles, m // 1024))
