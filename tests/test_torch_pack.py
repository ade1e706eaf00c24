"""The fused-MLP kernels' weight packing, on the CPU.

The CUDA kernels stream every wide weight matrix B [rows, nout] through a
ring of shared-memory slots, one KC-row chunk a bulk copy, and read it with
wgmma through a descriptor of K-major core matrices. The host packs each
matrix in that order (``fused_mlp.pack_chunks``). These tests unpack every
matrix the kernels stream by the plain index formula ``pack_offset`` and get
it back, for both weight layouts (the forward's [in, out] and the backward's
transposes), and hold ``pack_offset`` to the byte offsets that the kernel's
descriptor strides encode (``desc_offset``, with the strides read from the
CUDA source). It also checks the plain versions of the backward's
weight-gradient GEMM and ordered sums, which the card holds those kernels to.
"""

import os
import re

import numpy as np
import pytest
import torch

from startrax_torch.kernels import fused_mlp as fm

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "startrax_torch",
                   "kernels", "csrc", "fused_mlp.cu")
N_BLOCKS = 2


def _weights(width, in_ch, view_ch, fields, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(fields, *shape)), dtype=torch.float32)
            for shape in fm._param_shapes(width, N_BLOCKS, in_ch, view_ch)]


def _unpack(packed, rows, nout):
    """Packed [K, rows, nout] -> the matrices, by pack_offset alone."""
    k = torch.arange(rows)[:, None].expand(rows, nout)
    n = torch.arange(nout)[None, :].expand(rows, nout)
    return packed.reshape(packed.shape[0], -1)[:, fm.pack_offset(k, n, nout)]


@pytest.mark.parametrize("fields", [1, 2])
@pytest.mark.parametrize("in_rows", [64, 96])
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "backward"])
def test_packed_weights_unpack_to_every_streamed_matrix(transpose, width, in_rows, fields):
    in_ch, view_ch = (63, 27) if in_rows == 64 else (84, 27)
    weights = _weights(width, in_ch, view_ch, fields, seed=width + in_rows + fields)
    kw = fm._kernel_weights(weights, N_BLOCKS, transpose=transpose, in_rows=in_rows)
    bf, w2 = torch.bfloat16, width // 2

    def pad(w, rows):
        return torch.nn.functional.pad(w, (0, 0, 0, rows - w.shape[-2]))

    # (operand index in the kernels' list, the matrix as [in, out])
    streamed = [(0, pad(weights[0], in_rows))]
    for b in range(N_BLOCKS):
        streamed += [(2 + 4 * b, weights[2 + 4 * b]), (4 + 4 * b, weights[4 + 4 * b])]
    k = 2 + 4 * N_BLOCKS
    W_v = weights[k + 6]
    streamed += [(k, weights[k]), (k + 4, weights[k + 4]), (k + 6, W_v[:, :width]),
                 (k + 7, pad(W_v[:, width:], fm.EW))]
    for at, w in streamed:
        want = w.to(bf).transpose(-1, -2) if transpose else w.to(bf)
        packed = kw[at]
        assert packed.dtype == bf and packed.is_contiguous()
        assert tuple(packed.shape) == tuple(want.shape)
        assert torch.equal(_unpack(packed, *want.shape[1:]), want)
    # the narrow heads stay row-major [in, out]; biases f32 as given
    assert torch.equal(kw[k + 2], weights[k + 2].to(bf))
    assert torch.equal(kw[k + 9], weights[k + 8].to(bf))
    assert torch.equal(kw[1], weights[1])
    assert all(t.shape[0] == fields for t in kw)
    assert [tuple(t.shape[1:]) for at, t in enumerate(kw) if at in dict(streamed)] == [
        tuple((w.transpose(-1, -2) if transpose else w).shape[1:]) for _, w in streamed]
    assert tuple(kw[k + 7].shape[1:]) == ((w2, fm.EW) if transpose else (fm.EW, w2))


@pytest.mark.parametrize("nout", [256, 128, 96, 64])
def test_pack_offset_is_what_the_descriptor_reads(nout):
    rows = 96
    k = torch.arange(rows)[:, None].expand(rows, nout)
    n = torch.arange(nout)[None, :].expand(rows, nout)
    off = fm.pack_offset(k, n, nout)
    assert torch.equal(2 * off, fm.desc_offset(k, n, nout))
    # a permutation of the matrix's elements, each chunk one contiguous run
    assert torch.equal(off.reshape(-1).sort().values, torch.arange(rows * nout))
    for c in range(rows // fm.KC):
        chunk = off[c * fm.KC:(c + 1) * fm.KC]
        assert int(chunk.min()) == c * fm.KC * nout and int(chunk.max()) == (c + 1) * fm.KC * nout - 1


def test_descriptor_strides_match_the_cuda_source():
    with open(SRC) as fp:
        src = fp.read()
    consts = {}
    for name in ("KC", "LBO", "SBO"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        consts[name] = eval(m.group(1), {}, dict(consts))  # noqa: S307 - our own constant text
    assert (consts["KC"], consts["LBO"], consts["SBO"]) == (fm.KC, fm.DESC_LBO, fm.DESC_SBO)


@pytest.mark.parametrize("n", [3000, 4096])
def test_weight_gradient_plain_versions_sum_to_the_full_product(n):
    """The plain versions of the backward's weight-gradient GEMM and ordered
    sums, which the kernels are held to on the card: the split partials of
    relu(X)^T dY sum to the whole product, each split over its own points,
    and the grouped call (on the CPU, its plain version) gives the layer's
    partials at the split count of its rule."""
    rng = np.random.default_rng(n)
    X = torch.tensor(rng.normal(size=(2, n, 64)), dtype=torch.float32).to(torch.bfloat16)
    dY = torch.tensor(rng.normal(size=(2, n, 32)), dtype=torch.float32).to(torch.bfloat16)
    parts = fm.wgrad_plain(X, True, dY, 5)
    assert parts.shape == (2, 5, 64 * 32)
    full = X.float().clamp(min=0).transpose(1, 2) @ dY.float()
    torch.testing.assert_close(fm.sum_rows(parts.contiguous()).reshape(2, 64, 32), full,
                               rtol=1e-5, atol=1e-3)
    per = -(-n // 5)
    last = X[:, 4 * per:].float().clamp(min=0).transpose(1, 2) @ dY[:, 4 * per:].float()
    torch.testing.assert_close(parts[:, 4].reshape(2, 64, 32), last)
    splits = fm.wgrad_layout([(64, True, 32)], n, 2)["splits"]
    assert torch.equal(fm.wgrad([X], [dY], [True]), fm.wgrad_plain(X, True, dY, splits))
