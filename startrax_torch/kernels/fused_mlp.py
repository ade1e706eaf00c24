"""Fused radiance-field MLP: CUDA kernels, their plain PyTorch version, and
the autograd Function that joins them.

Counterpart of startrax/kernels/fused_mlp.py: `_fwd_kernel` and `_bwd_kernel`
behind `fused_field_apply` (one field), `_stacked_fwd_kernel` and
`_stacked_bwd_kernel` behind `fused_stacked_apply` (K fields in one launch).
One pair of CUDA kernels, in csrc/fused_mlp.cu, serves both: it runs over a
stack of K fields, and one field is the K = 1 case. The source's header says
what bounds the kernels on the card and how the design answers it.

- ``fused_field_apply`` and ``fused_stacked_apply`` are the wrappers. A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernels or
  raises.
- ``fused_mlp_plain`` has the kernels' signature and rounding (bf16 matmul
  operands, f32 accumulation, f32 biases and residual stream) and
  differentiates by autograd; ``fused_stacked_plain`` is K calls of it. It is
  also the field's plain path (``use_fused=False``, in bf16 or f32), and
  ``parity.compare`` holds the kernels against it.
- ``launches`` counts the wrappers' kernel launches: "fwd" and "bwd" for
  ``fused_field_apply`` on raw points, "enc_fwd" and "enc_bwd" on
  pre-encoded features, "stacked_fwd" and "stacked_bwd" for
  ``fused_stacked_apply`` on raw points, "stacked_enc_fwd" and
  "stacked_enc_bwd" on pre-encoded features; once per forward call and once
  per backward call
  (one backward call launches the per-tile backward and, when a weight
  needs a grad, one weight-gradient GEMM over every wide layer and two
  ordered sums, of the per-tile and of the per-split partials (one when
  only a pose grad is needed), which ``wgrad`` and ``sum_rows`` count in
  ``part_launches``, each with its plain version).
- Every wide weight matrix reaches the kernels packed for their weight
  ring (``pack_chunks``, ``pack_offset``): KC-row chunks of wgmma core
  matrices, one contiguous bulk copy each.

The backward runs in one of two modes. When the points or directions need a
grad (the per-ray-pose path, where they come from warp_to_vehicle_frames), it
writes per-point dx and dd. Otherwise a warped field's pose gradient leaves
through the packed warp, from 12 sums reduced in the kernel.

Input modes. With ``pe = (multires, multires_views)`` the kernels take raw
points and directions and encode them inside. With ``pe=None`` they take
pre-encoded features (``_fwd_kernel`` / ``_bwd_kernel`` with pe=None in the
JAX package): x_emb [N, in_ch] with in_ch <= XW and d_emb [N, view_ch] with
view_ch <= EW, no warp or mask. nerf_time's 4-D points with time take this
mode (models/fields.apply_field with ``time``), counted as "enc_fwd" and
"enc_bwd". Its backward writes dx_emb and dd_emb only when they need a
grad. The JAX package writes them always (``apply_field``'s
``input_grads=True``), but on the nerf_time path they flow into points that
carry no gradient, so leaving them out changes no result. K fields on
pre-encoded features [K, N, in_ch], [K, N, view_ch] go through
``fused_stacked_apply`` with pe=None (``_stacked_fwd_kernel`` /
``_stacked_bwd_kernel`` with pe=None, the default mode of the JAX package's
``fused_stacked_apply``), one launch for all K fields.

Under ``torch.no_grad`` (an eval render) the forward saves nothing: every
activation it would save for the backward goes to one [N, W] scratch
buffer, freed with the call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.encoding import encoding_dim, positional_encoding

EW = 64  # padded encoding width on the card: 63 point and 27 direction columns
XW = 96  # padded width of pre-encoded point features (nerf_time: 84 columns)
KC = 32  # weight rows per chunk of the kernels' weight ring
MAX_BLOCKS = 8

launches = {"fwd": 0, "bwd": 0, "stacked_fwd": 0, "stacked_bwd": 0, "enc_fwd": 0, "enc_bwd": 0,
            "stacked_enc_fwd": 0, "stacked_enc_bwd": 0}
# launches of the backward's two further kernels, by wgrad() and sum_rows()
part_launches = {"wgrad": 0, "sum_rows": 0}


def reset_launch_counts() -> None:
    for counts in (launches, part_launches):
        for k in counts:
            counts[k] = 0


def flatten_params(params: Dict[str, Any], n_blocks: int):
    """Field param dict -> flat tuple in kernel operand order."""
    flat = [params["lin_in"]["w"], params["lin_in"]["b"]]
    for i in range(n_blocks):
        blk = params["blocks"][i]
        flat += [blk["fc0"]["w"], blk["fc0"]["b"], blk["fc1"]["w"], blk["fc1"]["b"]]
    for name in ("lin_out", "alpha", "feature", "views", "rgb"):
        flat += [params[name]["w"], params[name]["b"]]
    return tuple(flat)


def pe_mask_row(weights_per_freq, num_freqs: int, width: int = EW):
    """BARF per-frequency weights [num_freqs] -> a [width] mask over the
    encoding columns: 1 on the raw-input columns, w[freq(j)] on the sin/cos
    columns (freq(j) = (j - 3) // 6)."""
    w = weights_per_freq.to(torch.float32)
    cols = torch.arange(width, device=w.device)
    freq = torch.clamp(torch.clamp(cols - 3, min=0) // 6, 0, num_freqs - 1)
    return torch.where(cols < 3, torch.ones_like(w[freq]), w[freq])


def _rnd(a):
    """Round to bf16 and widen back: a bf16 matmul operand read in a's type."""
    return a.to(torch.bfloat16).to(a.dtype)


class _Bf16Dot(torch.autograd.Function):
    """a @ b with bf16 operands and f32 accumulation, differentiated the way
    the kernels' backward computes it: the cotangent is rounded to bf16 as a
    matmul operand, and both grads come out in f32."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _rnd(a), _rnd(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _rnd(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def _dot(a, b):
    """bf16 operands, f32 accumulation (the kernels' matmul)."""
    return _Bf16Dot.apply(a, b)


def _dot_f32(a, b):
    return a @ b


def warp_points(v, warp, with_t: bool):
    """v [N, 3] -> M v (+ t) from the packed [16] warp (M row-major at
    [0:9], t at [9:12]), elementwise in the kernels' operation order."""
    ys = []
    for r in range(3):
        y = warp[3 * r] * v[:, 0] + warp[3 * r + 1] * v[:, 1] + warp[3 * r + 2] * v[:, 2]
        if with_t:
            y = y + warp[9 + r]
        ys.append(y)
    return torch.stack(ys, dim=-1)


def fused_mlp_plain(x, d, weights: Sequence[torch.Tensor], n_blocks: int, pe=None,
                    warp=None, masks=None, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernels, and the field's plain body. x, d:
    raw [N, 3] points and directions, or with pe=None the pre-encoded
    features [N, in_ch] and [N, view_ch]; weights: flat f32 params
    (flatten_params order); pe: (multires, multires_views) or None; warp:
    packed [16] or None; masks: ([EW], [EW]) BARF column masks or None (both
    need pe). compute_dtype bf16 rounds as the kernels do; float32 runs plain
    f32 matmuls. Returns [N, 4] = (raw alpha, raw rgb)."""
    dot = {torch.bfloat16: _dot, torch.float32: _dot_f32}[compute_dtype]
    if pe is None:
        if warp is not None or masks is not None:
            raise ValueError("a warp or BARF masks need the in-kernel encoding (pe)")
        xe, de = x, d
    else:
        if warp is not None:
            x = warp_points(x, warp, True)
            d = warp_points(d, warp, False)
        xe = positional_encoding(x, pe[0])
        de = positional_encoding(d, pe[1])
        if masks is not None:
            xe = xe * masks[0][: xe.shape[-1]]
            de = de * masks[1][: de.shape[-1]]
    it = iter(weights)
    W_in, b_in = next(it), next(it)
    blocks = [(next(it), next(it), next(it), next(it)) for _ in range(n_blocks)]
    W_out, b_out = next(it), next(it)
    W_a, b_a = next(it), next(it)
    W_f, b_f = next(it), next(it)
    W_v, b_v = next(it), next(it)
    W_r, b_r = next(it), next(it)
    width = W_in.shape[1]

    h = dot(xe, W_in) + b_in
    for W0, b0, W1, b1 in blocks:
        n = dot(F.relu(h), W0) + b0
        h = h + (dot(F.relu(n), W1) + b1)
    ho = dot(F.relu(h), W_out) + b_out
    alpha = dot(ho, W_a) + b_a
    feat = dot(ho, W_f) + b_f
    hv = F.relu(dot(feat, W_v[:width]) + dot(de, W_v[width:]) + b_v)
    rgb = dot(hv, W_r) + b_r
    return torch.cat([alpha, rgb], dim=-1)


def fused_stacked_plain(x, d, weights: Sequence[torch.Tensor], n_blocks: int, pe=None,
                        masks=None, compute_dtype=torch.bfloat16):
    """Plain version of the stacked kernels: K calls of fused_mlp_plain. x, d:
    raw [K, N, 3], or with pe=None pre-encoded [K, N, in_ch], [K, N,
    view_ch]; weights: flat stacked params ([K, ...] leaves); masks as for
    fused_mlp_plain, shared by the fields. Returns [K, N, 4]."""
    return torch.stack([fused_mlp_plain(x[k], d[k], [w[k] for w in weights], n_blocks, pe,
                                        masks=masks, compute_dtype=compute_dtype)
                        for k in range(x.shape[0])])


# --------------------------------------------------------------------------
# CUDA route
# --------------------------------------------------------------------------


_PARTIAL_FIELDS = ("b_in", "b_blocks", "b_out", "b_f", "b_v", "b_a", "b_r", "w_a", "w_r",
                   "pose", "total")


@functools.lru_cache(maxsize=None)
def _partial_offsets(width: int, n_blocks: int):
    """Where each bias grad, narrow-head weight grad and pose sum sits in a
    CTA's partials, as partial_offsets() in csrc/fused_mlp.cu lays it out."""
    lib = _lib()
    o = {k: lib.stx_partial_offset(width, n_blocks, k.encode()) for k in _PARTIAL_FIELDS}
    if min(o.values()) < 0:
        raise RuntimeError(f"fused MLP library lacks a partials field: {o}")
    return o


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from .build import load

        lib = load("fused_mlp")
        pp, pi, vp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p
        ci, cll = ctypes.c_int, ctypes.c_longlong
        for fn in (lib.stx_fused_fwd, lib.stx_fused_bwd):
            fn.argtypes = [pp, pi, vp]
            fn.restype = ci
        lib.stx_wgrad.argtypes = [vp, ci, vp, vp]
        lib.stx_wgrad.restype = ci
        lib.stx_sum_rows.argtypes = [vp, ci, cll, ci, ci, vp, vp, vp, vp]
        lib.stx_sum_rows.restype = ci
        lib.stx_partial_offset.argtypes = [ci, ci, ctypes.c_char_p]
        lib.stx_partial_offset.restype = ci
        if (lib.stx_enc_width(), lib.stx_enc_in_width()) != (EW, XW):
            raise RuntimeError(f"fused MLP library pads encodings to {lib.stx_enc_width()} and "
                               f"{lib.stx_enc_in_width()} columns, not {EW} and {XW}")
        _lib_handle = lib
    return _lib_handle


def build() -> None:
    """Build and load the kernels (also done at first launch)."""
    _lib()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _call(fn, tensors, ints, stream, what):
    ptrs = (ctypes.c_void_p * len(tensors))(*[_ptr(t) for t in tensors])
    iv = (ctypes.c_int * len(ints))(*ints)
    _check(fn(ptrs, iv, stream), what)


# The ordered sums' layout in csrc/fused_mlp.cu: columns a CTA (SR_COLS) and
# the CTAs one sum aims at (about two for each of an H100's 132 SMs).
SUM_COLS = 1024
SUM_CTAS = 264
SUM_MAX_CHUNKS = 64
_sum_counters: Dict[torch.device, torch.Tensor] = {}


def sum_rows_plain(src):
    """Plain version of sum_rows."""
    return src.sum(1)


def sum_rows_chunks(rows: int, cols: int, fields: int) -> int:
    """The row chunks of sum_rows' launch: enough CTAs (fields x column slabs
    x chunks) to fill the card, at most SUM_MAX_CHUNKS, at least 8 rows a
    chunk. A function of the shapes alone, so the order of the sum is too."""
    ctas = fields * -(-cols // SUM_COLS)
    return max(1, min(-(-SUM_CTAS // ctas), SUM_MAX_CHUNKS, rows // 8))


def sum_rows(src):
    """src [K, rows, cols] f32 (contiguous, cols a multiple of 4) -> [K,
    cols], the rows summed in one launch (sum_rows_kernel): each CTA sums a
    slab of columns over a chunk of rows in a fixed order, and the last CTA
    of a slab to finish adds the chunk sums in chunk order, so the result
    does not depend on scheduling. A CPU tensor takes sum_rows_plain."""
    if src.device.type == "cpu":
        return sum_rows_plain(src)
    if src.dim() != 3 or src.dtype != torch.float32 or not src.is_contiguous() \
            or src.shape[2] % 4 != 0:
        raise ValueError("sum_rows takes a contiguous float32 [K, rows, cols] tensor, cols a "
                         "multiple of 4")
    K, rows, cols = src.shape
    chunks = sum_rows_chunks(rows, cols, K)
    # the result [K, cols], then with chunks > 1 the chunk sums [K, chunks, cols]
    buf = torch.empty(K * cols * (1 + (chunks if chunks > 1 else 0)), dtype=torch.float32,
                      device=src.device)
    scratch = counters = None
    if chunks > 1:
        scratch = buf.data_ptr() + 4 * K * cols
        need = K * -(-cols // SUM_COLS)
        counters = _sum_counters.get(src.device)
        if counters is None or counters.numel() < need:
            # zeros the kernel leaves zero: each slab's last CTA resets its counter
            counters = torch.zeros(need, dtype=torch.int32, device=src.device)
            _sum_counters[src.device] = counters
        counters = counters.data_ptr()
    _check(_lib().stx_sum_rows(src.data_ptr(), rows, cols, K, chunks, scratch, counters,
                               buf.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream),
           "fused MLP partial sums")
    part_launches["sum_rows"] += 1
    return buf[:K * cols].view(K, cols)


# wgrad_kernel's tiling in csrc/fused_mlp.cu: output rows (columns of X) a
# CTA, and the most layers of its table; an H100's SMs, which the split
# rule fills about twice with one CTA each; and the most points a split
# sums (WG_SPLIT_ROWS).
WG_ROWS = 128
WG_MAXL = 2 * MAX_BLOCKS + 5
SMS = 132
# A CTA accumulates its split's points in the wgmma f32 accumulators, whose
# error against an exact sum grows with the points: 5.3e-5 of the largest
# entry at 47,663 points a split, 2.1e-4 at 190,651 (H100, chip_smoke.py
# phase 3c, against the plain version's cuBLAS f32 sums). Above this many
# points a split the rule adds splits.
WG_SPLIT_ROWS = 49152


class _WgLayer(ctypes.Structure):
    """struct WgLayer of csrc/fused_mlp.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("dy", ctypes.c_void_p), ("wofs", ctypes.c_longlong),
                ("k_in", ctypes.c_int), ("n_out", ctypes.c_int), ("relu", ctypes.c_int),
                ("tile0", ctypes.c_int)]


class _WgTable(ctypes.Structure):
    """struct WgTable of csrc/fused_mlp.cu: the layer table in the kernel's parameter."""
    _fields_ = [("l", _WgLayer * WG_MAXL), ("n", ctypes.c_longlong),
                ("per_split", ctypes.c_longlong), ("wtotal", ctypes.c_longlong),
                ("n_layers", ctypes.c_int), ("splits", ctypes.c_int), ("tiles", ctypes.c_int)]


def wgrad_splits(n: int, tiles: int) -> int:
    """Splits of the n points for a launch of `tiles` CTAs a split (row
    tiles of every layer and field): about two waves of one CTA on each of
    an H100's SMS SMs, and at least 1,024 points a split; more splits where
    a split would sum more than WG_SPLIT_ROWS points (n above 540,000 at
    8x256). A function of the shapes alone, so that wgrad_plain partitions
    the points the same way."""
    return max(1, min(2 * SMS // tiles, n // 1024), -(-n // WG_SPLIT_ROWS))


def wgrad_split_bounds(n: int, splits: int):
    """[(begin, end)] of each split's points: per = ceil(n / splits) points
    each, the last ones short or empty."""
    per = -(-n // splits)
    return [(min(n, i * per), min(n, (i + 1) * per)) for i in range(splits)]


def wgrad_layout(shapes, n: int, fields: int):
    """The host side of wgrad_kernel's layer table for layers [(k_in, relu,
    n_out)] on `fields` fields of n points: each layer's (k_in, n_out, relu,
    wofs, tile0), wofs its partial's offset in a split's row and tile0 the
    row tiles (ceil(k_in / WG_ROWS)) of the layers before it; the row tiles
    of all layers (``tiles``), the split count, points a split and floats a
    split's row (``wtotal``)."""
    layers, wofs, tile0 = [], 0, 0
    for k_in, relu, n_out in shapes:
        layers.append((k_in, n_out, int(relu), wofs, tile0))
        wofs += k_in * n_out
        tile0 += -(-k_in // WG_ROWS)
    splits = wgrad_splits(n, fields * tile0)
    return {"layers": layers, "tiles": tile0, "splits": splits, "per_split": -(-n // splits),
            "wtotal": wofs}


def wgrad_plain(X, relu_x: bool, dY, splits: int):
    """Plain version of one layer's wgrad: [K, splits, k_in * n_out] f32
    partials, split i the sum over its points (wgrad_split_bounds)."""
    K, n, _ = X.shape
    x = X.float().clamp(min=0) if relu_x else X.float()
    parts = [x[:, a:b].transpose(1, 2) @ dY[:, a:b].float()
             for a, b in wgrad_split_bounds(n, splits)]
    return torch.stack(parts, 1).reshape(K, splits, -1)


def wgrad_grouped_plain(xs, dys, relus, splits: int):
    """Plain version of wgrad: the layers' wgrad_plain partials side by side."""
    return torch.cat([wgrad_plain(X, r, dY, splits) for X, dY, r in zip(xs, dys, relus)], -1)


def wgrad(xs, dys, relus):
    """dW = relu?(X)^T dY of every wide layer of one backward call, in one
    launch (wgrad_kernel): xs [K, n, k_in] and dys [K, n, n_out] bf16, one
    pair a layer, relu applied to X where relus says -> [K, splits,
    wtotal] f32, split i's row holding every layer's [k_in, n_out] partial
    over its points (wgrad_split_bounds), layer after layer
    (wgrad_layout's wofs). A CPU tensor takes wgrad_grouped_plain."""
    K, n = xs[0].shape[:2]
    lay = wgrad_layout([(X.shape[2], r, dY.shape[2]) for X, dY, r in zip(xs, dys, relus)], n, K)
    if xs[0].device.type == "cpu":
        return wgrad_grouped_plain(xs, dys, relus, lay["splits"])
    dev = xs[0].device
    if not 0 < len(xs) == len(dys) == len(relus) <= WG_MAXL:
        raise ValueError(f"wgrad takes 1 to {WG_MAXL} layers, one X and dY each")
    for X, dY in zip(xs, dys):
        if (X.dtype != torch.bfloat16 or dY.dtype != torch.bfloat16 or X.device != dev
                or dY.device != dev or not X.is_contiguous() or not dY.is_contiguous()
                or X.shape[:2] != (K, n) or dY.shape[:2] != (K, n) or X.shape[2] % 16 != 0
                or dY.shape[2] not in (64, 128, 256)):
            raise ValueError("wgrad takes contiguous bf16 X [K, n, k_in] (k_in a multiple of "
                             "16) and dY [K, n, n_out] (n_out 64, 128 or 256) on one device")
    t = _WgTable(n=n, per_split=lay["per_split"], wtotal=lay["wtotal"], n_layers=len(xs),
                 splits=lay["splits"], tiles=lay["tiles"])
    for i, (X, dY, (k_in, n_out, relu, wofs, tile0)) in enumerate(zip(xs, dys, lay["layers"])):
        t.l[i] = _WgLayer(X.data_ptr(), dY.data_ptr(), wofs, k_in, n_out, relu, tile0)
    out = torch.empty((K, lay["splits"], lay["wtotal"]), dtype=torch.float32, device=dev)
    _check(_lib().stx_wgrad(ctypes.addressof(t), K, out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream),
           "fused MLP weight-gradient GEMM")
    part_launches["wgrad"] += 1
    return out


def wgrad_shapes(width: int, n_blocks: int, in_rows: int):
    """(k_in, relu on X, n_out) of every wide layer's dW = X^T dY, in the
    backward's order: lin_in, the blocks' fc0 and fc1, lin_out, feature,
    views top and bottom."""
    w2 = width // 2
    return ([(in_rows, False, width)] + [(width, True, width)] * (2 * n_blocks)
            + [(width, True, width), (width, False, width), (width, False, w2), (EW, False, w2)])


def _pad_rows(w, n_rows: int):
    return F.pad(w, (0, 0, 0, n_rows - w.shape[-2]))


# The wgmma descriptor's strides in csrc/fused_mlp.cu (LBO, SBO): bytes from a
# core matrix of a packed chunk to the next along K, and along N.
DESC_LBO, DESC_SBO = 128, (KC // 8) * 128


def pack_offset(k, n, nout: int):
    """Where element (k, n) of a streamed matrix B [rows, nout] sits in its
    packed copy, in elements: chunk k // KC (KC * nout elements each), then
    wgmma's K-major core matrices of 8 columns x 8 rows (64 elements) at
    ((n // 8) * 4 + (k % KC) // 8) * 64, column n % 8 at 8 elements, row
    k % 8 at 1. Works on ints and on integer tensors."""
    return (k // KC) * KC * nout + ((n // 8) * 4 + (k % KC) // 8) * 64 + (n % 8) * 8 + k % 8


def desc_offset(k, n, nout: int):
    """Byte offset of B's element (k, n) from its packed copy's start as the
    kernels read it: the chunk's slot holds KC * nout bf16; the descriptor
    steps DESC_SBO bytes per 8 columns and DESC_LBO per 8 rows, and a core
    matrix's column n % 8 is 16 bytes, its row k % 8 is 2 (tests hold it
    equal to 2 * pack_offset)."""
    return ((k // KC) * KC * nout * 2 + (n // 8) * DESC_SBO + (k % KC) // 8 * DESC_LBO
            + (n % 8) * 16 + (k % 8) * 2)


def pack_chunks(b, dtype=None):
    """B [..., rows, nout] (rows a multiple of KC, nout of 8; any strides) ->
    its packed copy in the kernels' weight-ring order (pack_offset), as a
    contiguous tensor of the same shape in dtype (b's by default): one copy,
    the cast included."""
    *lead, rows, nout = b.shape
    d = len(lead)
    src = (b.reshape(*lead, rows // KC, KC // 8, 8, nout // 8, 8)
           .permute(*range(d), d, d + 3, d + 1, d + 4, d + 2))
    out = torch.empty(src.shape, dtype=dtype or b.dtype, device=b.device)
    return out.copy_(src).view(*lead, rows, nout)


def _kernel_weights(weights, n_blocks: int, transpose: bool, in_rows: int):
    """Flat f32 stacked params ([K, ...] leaves) -> the kernels' operand list,
    each a contiguous stack over the fields: bf16 matrices packed for the
    weight ring (pack_chunks; lin_in zero-padded to in_rows rows, Wv_bot to
    EW, views split into top and bottom), f32 biases. transpose=True packs
    the backward's [K, out, in] matrices; the narrow heads (alpha, rgb) stay
    row-major [in, out]."""
    bf = torch.bfloat16
    it = iter(weights)
    W_in, b_in = next(it), next(it)
    width = W_in.shape[-1]

    def mat(w):
        return pack_chunks(w.transpose(-1, -2) if transpose else w, bf)

    out = [mat(_pad_rows(W_in, in_rows)), b_in.contiguous()]
    for _ in range(n_blocks):
        W0, b0, W1, b1 = next(it), next(it), next(it), next(it)
        out += [mat(W0), b0.contiguous(), mat(W1), b1.contiguous()]
    W_out, b_out = next(it), next(it)
    W_a, b_a = next(it), next(it)
    W_f, b_f = next(it), next(it)
    W_v, b_v = next(it), next(it)
    W_r, b_r = next(it), next(it)
    out += [mat(W_out), b_out.contiguous(), W_a.to(bf).contiguous(), b_a.contiguous(),
            mat(W_f), b_f.contiguous(), mat(W_v[:, :width]), mat(_pad_rows(W_v[:, width:], EW)),
            b_v.contiguous(), W_r.to(bf).contiguous(), b_r.contiguous()]
    return out


def _param_shapes(width: int, n_blocks: int, in_ch: int, view_ch: int):
    """Per-field shapes of the flat params, in flatten_params order."""
    w2 = width // 2
    shapes = [(in_ch, width), (width,)]
    shapes += [(width, width), (width,), (width, width), (width,)] * n_blocks
    shapes += [(width, width), (width,), (width, 1), (1,), (width, width), (width,),
               (width + view_ch, w2), (w2,), (w2, 3), (3,)]
    return shapes


class _FusedMLP(torch.autograd.Function):
    """K fields of one shape through the kernels, on x, d [K, N, 3] (or, with
    pe=None, pre-encoded x_emb [K, N, in_ch], d_emb [K, N, view_ch]), an
    optional packed warp [K, 16] and stacked weights [K, ...].
    Forward: the forward kernel, saving bf16 activations when ``save``.
    Backward: the per-tile backward kernel; then, when a weight needs a grad,
    one grouped split-N GEMM over the wide layers and the deterministic
    partial sums. When
    x or d needs a grad the backward writes per-point dx, dd; otherwise a
    warp's grad is dM = M G, dt = M s from the kernel's pose sums.
    ``counter`` names the launch counters ("", "stacked_", "enc_" or
    "stacked_enc_")."""

    @staticmethod
    def forward(ctx, counter, save, x, d, warp, mask_x, mask_d, n_blocks, pe, *weights):
        lib = _lib()
        K, n, width = x.shape[0], x.shape[1], weights[0].shape[-1]
        dev, bf = x.device, torch.bfloat16
        kw = _kernel_weights(weights, n_blocks, transpose=False, in_rows=_in_rows(pe))
        if save:
            acts = [torch.empty((K, n, width), dtype=bf, device=dev)
                    for _ in range(2 * n_blocks + 3)]
            acts.append(torch.empty((K, n, width // 2), dtype=bf, device=dev))
        else:  # nothing will read them: one buffer takes every activation's writes
            acts = [torch.empty((K, n, width), dtype=bf, device=dev)] * (2 * n_blocks + 4)
        out = torch.empty((K, n, 4), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call(lib.stx_fused_fwd, [x, d, warp, mask_x, mask_d, *kw, *acts, out],
              _kernel_ints(x, d, width, n_blocks, pe), stream, "fused MLP forward")
        launches[counter + "fwd"] += 1
        ctx.counter, ctx.n_blocks, ctx.pe = counter, n_blocks, pe
        if save:
            ctx.save_for_backward(x, d, warp, mask_x, mask_d, *weights, *acts)
        return out

    @staticmethod
    def backward(ctx, g):
        lib = _lib()
        n_blocks, pe = ctx.n_blocks, ctx.pe
        saved = ctx.saved_tensors
        x, d, warp, mask_x, mask_d = saved[:5]
        n_w = 2 + 4 * n_blocks + 10
        weights = saved[5:5 + n_w]
        acts = list(saved[5 + n_w:])
        K, n, width = x.shape[0], x.shape[1], weights[0].shape[-1]
        w2, in_rows = width // 2, _in_rows(pe)
        dev, bf, f32 = x.device, torch.bfloat16, torch.float32
        needs = ctx.needs_input_grad
        in_grads = needs[2] or needs[3]
        pose_grad = warp is not None and needs[4]
        w_grads = any(needs[9:])
        g = g.contiguous().to(f32)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def buf(cols, dtype=bf):
            return torch.empty((K, n, cols), dtype=dtype, device=dev)

        kw = _kernel_weights(weights, n_blocks, transpose=True, in_rows=in_rows)
        d_in = buf(width)
        d_blocks = [buf(width) for _ in range(2 * n_blocks)]
        d_out, d_f, d_v, xe, de = buf(width), buf(width), buf(w2), buf(in_rows), buf(EW)
        dx, dd = (buf(x.shape[2], f32), buf(d.shape[2], f32)) if in_grads else (None, None)
        off = _partial_offsets(width, n_blocks)
        n_tiles = math.ceil(n / lib.stx_tile_points())
        part = torch.empty((K, n_tiles, off["total"]), dtype=f32, device=dev)
        _call(lib.stx_fused_bwd,
              [x, d, warp, mask_x, mask_d, *kw, *acts, g, d_in, *d_blocks, d_out, d_f, d_v,
               xe, de, part, dx, dd],
              _kernel_ints(x, d, width, n_blocks, pe), stream, "fused MLP backward")
        launches[ctx.counter + "bwd"] += 1

        grads = [None] * n_w
        if w_grads or (pose_grad and not in_grads):
            ps = sum_rows(part)
        if w_grads:
            # dW = X^T dY for every wide layer, the X and dY of wgrad_shapes
            h_acts, h_last, ho, feat = acts[:2 * n_blocks], acts[-4], acts[-3], acts[-2]
            xs = [xe, *h_acts, h_last, ho, feat, de]
            dys = [d_in, *d_blocks, d_out, d_f, d_v, d_v]
            shapes = wgrad_shapes(width, n_blocks, in_rows)
            sizes = [k * m for k, _, m in shapes]
            dw = sum_rows(wgrad(xs, dys, [r for _, r, _ in shapes]))

            mats = torch.split(dw, sizes, dim=1)

            def mat(i, rows, cols):
                return mats[i].reshape(K, rows, cols)

            def vec(name, size, at=0):
                return ps[:, off[name] + at:off[name] + at + size]

            in_ch, view_ch = weights[0].shape[-2], weights[-4].shape[-2] - width
            grads = [mat(0, in_rows, width)[:, :in_ch], vec("b_in", width)]
            for b in range(n_blocks):
                at = 2 * width * b
                grads += [mat(1 + 2 * b, width, width), vec("b_blocks", width, at),
                          mat(2 + 2 * b, width, width), vec("b_blocks", width, at + width)]
            k = 1 + 2 * n_blocks
            grads += [mat(k, width, width), vec("b_out", width),
                      vec("w_a", width).reshape(K, width, 1), vec("b_a", 1),
                      mat(k + 1, width, width), vec("b_f", width),
                      torch.cat([mat(k + 2, width, w2), mat(k + 3, EW, w2)[:, :view_ch]], 1),
                      vec("b_v", w2), vec("w_r", 3 * w2).reshape(K, w2, 3), vec("b_r", 3)]

        dwarp = None
        if pose_grad:
            M = warp[:, :9].reshape(K, 3, 3)
            if in_grads:  # from the world-frame input grads, as the TPU rule does
                G = torch.einsum("kni,knj->kij", dx, x) + torch.einsum("kni,knj->kij", dd, d)
                s = dx.sum(1)
            else:
                G = ps[:, off["pose"]:off["pose"] + 9].reshape(K, 3, 3)
                s = ps[:, off["pose"] + 9:off["pose"] + 12]
            dM = M @ G
            dt = (M @ s[..., None])[..., 0]
            dwarp = torch.cat([dM.reshape(K, 9), dt, warp.new_zeros(K, 4)], 1)
        return (None, None, dx if needs[2] else None, dd if needs[3] else None, dwarp, None, None,
                None, None, *grads)


def _in_rows(pe) -> int:
    """Rows of lin_in's weight on the card: the padded point encoding."""
    return XW if pe is None else EW


def _kernel_ints(x, d, width: int, n_blocks: int, pe):
    """The kernels' int operands: n, width, n_blocks, then the multires of
    points and directions (the encoded widths with pe=None), the fields, and
    the pre-encoded flag."""
    cols = (x.shape[2], d.shape[2]) if pe is None else tuple(pe)
    return [x.shape[1], width, n_blocks, *cols, x.shape[0], int(pe is None)]


def _check_cuda_inputs(x, d, weights, n_blocks, pe, warp, masks):
    """Device, dtype, shape and contiguity of a stacked launch's operands.
    With pe=None, x and d are the fields' encoded features [K, N, in_ch],
    [K, N, view_ch], without warp or masks."""
    dev = x.device
    if x.dim() != 3 or d.dim() != 3:
        raise ValueError(f"x, d must be [K, N, C], got {list(x.shape)}, {list(d.shape)}")
    K, n = x.shape[0], x.shape[1]
    if pe is None:
        in_ch, view_ch = x.shape[2], d.shape[2]
        if warp is not None or masks is not None:
            raise ValueError("the pre-encoded mode takes no warp or masks")
        if not (0 < in_ch <= XW and 0 < view_ch <= EW):
            raise ValueError(f"fused MLP kernel pads encoded inputs to {XW} and {EW} columns, "
                             f"got {in_ch}, {view_ch}")
    else:
        in_ch, view_ch = encoding_dim(3, pe[0]), encoding_dim(3, pe[1])
        if in_ch > EW or view_ch > EW:
            raise ValueError(f"fused MLP kernel pads encodings to {EW} columns, "
                             f"got {in_ch}, {view_ch}")
    for name, t, cols in (("x", x, x.shape[2] if pe is None else 3),
                          ("d", d, d.shape[2] if pe is None else 3)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (K, n, cols) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [K, N, {cols}] tensor on {dev}")
    width = weights[0].shape[-1]
    if width % 128 != 0 or width > 256:
        raise ValueError(f"fused MLP kernel needs width 128 or 256, got {width}")
    if not 0 <= n_blocks <= MAX_BLOCKS:
        raise ValueError(f"fused MLP kernel takes at most {MAX_BLOCKS} blocks, got {n_blocks}")
    shapes = _param_shapes(width, n_blocks, in_ch, view_ch)
    if len(weights) != len(shapes):
        raise ValueError(f"fused MLP kernel: {len(weights)} params for {n_blocks} blocks")
    for w, shape in zip(weights, shapes):
        if w.device != dev or w.dtype != torch.float32 or tuple(w.shape) != (K, *shape):
            raise ValueError(f"fused MLP params must be float32 on {dev}, [{K}, *{list(shape)}] "
                             f"(the encoding widths and the width); got {list(w.shape)}")
    for name, t, shape in (("warp", warp, (K, 16)),
                           *((f"pe mask {i}", m, (EW,)) for i, m in enumerate(masks or ()))):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on {dev}")


def _launch(counter, x, d, warp, weights, n_blocks: int, pe, masks):
    _check_cuda_inputs(x, d, weights, n_blocks, pe, warp, masks)
    mx, md = masks if masks is not None else (None, None)
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, d, warp, *weights))
    return _FusedMLP.apply(counter, save, x, d, warp, mx, md, n_blocks,
                           None if pe is None else tuple(pe), *weights)


def fused_field_apply(params: Dict[str, Any], x, d, n_blocks: int, pe=None,
                      pe_masks=None, warp=None):
    """Fused field MLP -> (raw_alpha [N], raw_rgb [N, 3]), differentiable in
    the params, in x and d, and in the packed [16] warp. With pe =
    (multires, multires_views), x [N, 3] and d [N, 3] are raw points and
    directions; pe_masks = ([EW], [EW]) BARF column masks (see pe_mask_row)
    or None. With pe=None, x [N, in_ch] and d [N, view_ch] are pre-encoded
    features, and there is no warp or mask.

    CPU tensors take the plain version; CUDA tensors launch the kernels (as
    one field of a stack)."""
    weights = flatten_params(params, n_blocks)
    if x.device.type == "cpu":
        out = fused_mlp_plain(x, d, weights, n_blocks, pe, warp=warp, masks=pe_masks)
    elif x.device.type == "cuda":
        if x.dim() != 2:
            raise ValueError(f"x must be [N, C], got {list(x.shape)}")
        out = _launch("enc_" if pe is None else "", x[None], d[None],
                      None if warp is None else warp[None], [w[None] for w in weights], n_blocks,
                      pe, pe_masks)[0]
    else:
        raise ValueError(f"fused MLP: unsupported device {x.device}")
    return out[:, 0], out[:, 1:4]


def fused_stacked_apply(params_stacked: Dict[str, Any], x, d, n_blocks: int, pe=None,
                        pe_masks=None):
    """K stacked fields (leaves with a leading [K] axis) -> (raw_alpha [K,
    N], raw_rgb [K, N, 3]), differentiable in the params and in x and d.
    With pe = (multires, multires_views), x [K, N, 3] and d [K, N, 3] are
    per-field raw points and directions, and the BARF masks, if any, are
    shared by the fields. With pe=None (the JAX package's default), x [K,
    N, in_ch] and d [K, N, view_ch] are pre-encoded features, without masks;
    their grads are dx_emb and dd_emb.

    CPU tensors take the plain version (fused_stacked_plain); CUDA tensors
    launch the kernels once for all K fields."""
    weights = flatten_params(params_stacked, n_blocks)
    if x.device.type == "cpu":
        out = fused_stacked_plain(x, d, weights, n_blocks, pe, masks=pe_masks)
    elif x.device.type == "cuda":
        out = _launch("stacked_enc_" if pe is None else "stacked_", x, d, None, weights,
                      n_blocks, pe, pe_masks)
    else:
        raise ValueError(f"fused MLP: unsupported device {x.device}")
    return out[..., 0], out[..., 1:4]
