"""Fused radiance-field MLP: CUDA kernels, their plain PyTorch version, and
the autograd Function that joins them.

Counterpart of startrax/kernels/fused_mlp.py (`_fwd_kernel` and `_bwd_kernel`,
behind `fused_field_apply`). The kernels are in csrc/fused_mlp.cu, whose
header says what bounds them on the card and how the design answers it.

- ``fused_field_apply`` is the wrapper. A CPU tensor goes to
  ``fused_mlp_plain``; a CUDA tensor launches the kernels or raises.
- ``fused_mlp_plain`` has the kernels' signature and rounding (bf16 matmul
  operands, f32 accumulation, f32 biases and residual stream) and
  differentiates by autograd. It is also the field's plain path
  (``use_fused=False``, in bf16 or f32), and ``parity.compare`` holds the
  kernels against it.
- ``launches`` counts the wrapper's kernel launches: "fwd" once per forward
  call, "bwd" once per backward call (one backward call launches the per-tile
  backward, the weight-gradient GEMMs and the partial sums).

Only the in-kernel encoding mode with ``input_grads=False`` is ported: points
and directions carry no gradient, and a warped field's pose gradient leaves
through the packed warp. Inputs that require grad (the per-ray-pose path and
the pre-encoded mode) raise NotImplementedError on CUDA.
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
MAX_BLOCKS = 8

launches = {"fwd": 0, "bwd": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


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


def fused_mlp_plain(x, d, weights: Sequence[torch.Tensor], n_blocks: int, pe,
                    warp=None, masks=None, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernels, and the field's plain body. x, d:
    raw [N, 3] points and directions; weights: flat f32 params
    (flatten_params order); pe: (multires, multires_views); warp: packed [16]
    or None; masks: ([EW], [EW]) BARF column masks or None. compute_dtype
    bf16 rounds as the kernels do; float32 runs plain f32 matmuls. Returns
    [N, 4] = (raw alpha, raw rgb)."""
    dot = {torch.bfloat16: _dot, torch.float32: _dot_f32}[compute_dtype]
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
        for fn in (lib.stx_fused_fwd, lib.stx_fused_bwd):
            fn.argtypes = [pp, pi, vp]
            fn.restype = ctypes.c_int
        lib.stx_wgrad.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, vp, ctypes.c_longlong, vp]
        lib.stx_wgrad.restype = ctypes.c_int
        lib.stx_sum_rows.argtypes = [vp, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, vp, vp]
        lib.stx_sum_rows.restype = ctypes.c_int
        lib.stx_partial_offset.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        lib.stx_partial_offset.restype = ctypes.c_int
        if lib.stx_enc_width() != EW:
            raise RuntimeError(f"fused MLP library pads encodings to {lib.stx_enc_width()}, "
                               f"not {EW}")
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


def _pad_rows(w, n_rows: int):
    return F.pad(w, (0, 0, 0, n_rows - w.shape[0]))


def _kernel_weights(weights, n_blocks: int, transpose: bool):
    """Flat f32 params -> the kernels' operand list: bf16 matrices (lin_in
    and Wv_bot zero-padded to EW rows, views split into top and bottom),
    f32 biases. transpose=True gives the backward's [out, in] matrices; the
    narrow heads (alpha, rgb) stay as they are."""
    bf = torch.bfloat16
    it = iter(weights)
    W_in, b_in = next(it), next(it)
    width = W_in.shape[1]

    def mat(w):
        w = w.to(bf)
        return w.t().contiguous() if transpose else w.contiguous()

    out = [mat(_pad_rows(W_in, EW)), b_in.contiguous()]
    for _ in range(n_blocks):
        W0, b0, W1, b1 = next(it), next(it), next(it), next(it)
        out += [mat(W0), b0.contiguous(), mat(W1), b1.contiguous()]
    W_out, b_out = next(it), next(it)
    W_a, b_a = next(it), next(it)
    W_f, b_f = next(it), next(it)
    W_v, b_v = next(it), next(it)
    W_r, b_r = next(it), next(it)
    out += [mat(W_out), b_out.contiguous(), W_a.to(bf).contiguous(), b_a.contiguous(),
            mat(W_f), b_f.contiguous(), mat(W_v[:width]), mat(_pad_rows(W_v[width:], EW)),
            b_v.contiguous(), W_r.to(bf).contiguous(), b_r.contiguous()]
    return out


def _wgrad_splits(n: int) -> int:
    return max(1, min(64, n // 2048))


class _FusedMLP(torch.autograd.Function):
    """Forward: the forward kernel, saving bf16 activations. Backward: the
    per-tile backward kernel, one split-N GEMM per wide layer, and the
    deterministic partial sums; the pose grad is dM = M G, dt = M s."""

    @staticmethod
    def forward(ctx, x, d, warp, mask_x, mask_d, n_blocks, pe, *weights):
        lib = _lib()
        n, width = x.shape[0], weights[0].shape[1]
        dev = x.device
        kw = _kernel_weights(weights, n_blocks, transpose=False)
        bf = torch.bfloat16
        acts = [torch.empty((n, width), dtype=bf, device=dev) for _ in range(2 * n_blocks + 3)]
        acts.append(torch.empty((n, width // 2), dtype=bf, device=dev))
        out = torch.empty((n, 4), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call(lib.stx_fused_fwd, [x, d, warp, mask_x, mask_d, *kw, *acts, out],
              [n, width, n_blocks, pe[0], pe[1]], stream, "fused MLP forward")
        launches["fwd"] += 1
        ctx.n_blocks, ctx.pe = n_blocks, pe
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
        n, width = x.shape[0], weights[0].shape[1]
        w2 = width // 2
        dev, bf = x.device, torch.bfloat16
        g = g.contiguous().to(torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream

        kw = _kernel_weights(weights, n_blocks, transpose=True)
        d_in = torch.empty((n, width), dtype=bf, device=dev)
        d_blocks = [torch.empty((n, width), dtype=bf, device=dev) for _ in range(2 * n_blocks)]
        d_out = torch.empty((n, width), dtype=bf, device=dev)
        d_f = torch.empty((n, width), dtype=bf, device=dev)
        d_v = torch.empty((n, w2), dtype=bf, device=dev)
        xe = torch.empty((n, EW), dtype=bf, device=dev)
        de = torch.empty((n, EW), dtype=bf, device=dev)
        off = _partial_offsets(width, n_blocks)
        n_tiles = math.ceil(n / lib.stx_tile_points())
        part = torch.empty((n_tiles, off["total"]), dtype=torch.float32, device=dev)
        _call(lib.stx_fused_bwd,
              [x, d, warp, mask_x, mask_d, *kw, *acts, g, d_in, *d_blocks, d_out, d_f, d_v,
               xe, de, part],
              [n, width, n_blocks, pe[0], pe[1]], stream, "fused MLP backward")

        # dW = X^T dY for every wide layer: (X, k_in, relu on X, dY, n_out)
        h_acts, h_last, ho, feat = acts[:2 * n_blocks], acts[-4], acts[-3], acts[-2]
        jobs = [(xe, EW, 0, d_in, width)]
        for b in range(n_blocks):
            jobs += [(h_acts[2 * b], width, 1, d_blocks[2 * b], width),
                     (h_acts[2 * b + 1], width, 1, d_blocks[2 * b + 1], width)]
        jobs += [(h_last, width, 1, d_out, width), (ho, width, 0, d_f, width),
                 (feat, width, 0, d_v, w2), (de, EW, 0, d_v, w2)]
        sizes = [k * m for _, k, _, _, m in jobs]
        total = sum(sizes)
        splits = _wgrad_splits(n)
        wpart = torch.empty((splits, total), dtype=torch.float32, device=dev)
        start = 0
        for (X, k_in, relu, dY, n_out), size in zip(jobs, sizes):
            _check(lib.stx_wgrad(X.data_ptr(), k_in, relu, dY.data_ptr(), n_out, n, splits,
                                 wpart.data_ptr() + 4 * start, total, stream),
                   "fused MLP weight-gradient GEMM")
            start += size
        dw = torch.empty((total,), dtype=torch.float32, device=dev)
        _check(lib.stx_sum_rows(wpart.data_ptr(), splits, total, splits, dw.data_ptr(), stream),
               "fused MLP partial sums")
        chunk = 128
        n_chunks = math.ceil(n_tiles / chunk)
        mid = torch.empty((n_chunks, off["total"]), dtype=torch.float32, device=dev)
        ps = torch.empty((off["total"],), dtype=torch.float32, device=dev)
        _check(lib.stx_sum_rows(part.data_ptr(), n_tiles, off["total"], chunk, mid.data_ptr(),
                                stream), "fused MLP partial sums")
        _check(lib.stx_sum_rows(mid.data_ptr(), n_chunks, off["total"], n_chunks, ps.data_ptr(),
                                stream), "fused MLP partial sums")
        launches["bwd"] += 1

        mats = list(torch.split(dw, sizes))
        in_ch, view_ch = weights[0].shape[0], weights[-4].shape[0] - width
        grads = [mats[0].view(EW, width)[:in_ch], ps[off["b_in"]:off["b_in"] + width]]
        for b in range(n_blocks):
            o0 = off["b_blocks"] + 2 * width * b
            grads += [mats[1 + 2 * b].view(width, width), ps[o0:o0 + width],
                      mats[2 + 2 * b].view(width, width), ps[o0 + width:o0 + 2 * width]]
        k = 1 + 2 * n_blocks
        grads += [mats[k].view(width, width), ps[off["b_out"]:off["b_out"] + width],
                  ps[off["w_a"]:off["w_a"] + width].view(width, 1),
                  ps[off["b_a"]:off["b_a"] + 1],
                  mats[k + 1].view(width, width), ps[off["b_f"]:off["b_f"] + width],
                  torch.cat([mats[k + 2].view(width, w2), mats[k + 3].view(EW, w2)[:view_ch]]),
                  ps[off["b_v"]:off["b_v"] + w2],
                  ps[off["w_r"]:off["w_r"] + 3 * w2].view(w2, 3),
                  ps[off["b_r"]:off["b_r"] + 3]]

        dwarp = None
        if warp is not None and ctx.needs_input_grad[2]:
            pose = ps[off["pose"]:off["pose"] + 12]
            M = warp[:9].view(3, 3)
            dM = M @ pose[:9].view(3, 3)
            dt = M @ pose[9:12]
            dwarp = torch.cat([dM.reshape(9), dt, warp.new_zeros(4)])
        return (None, None, dwarp, None, None, None, None, *grads)


def _check_cuda_inputs(x, d, weights, n_blocks, pe, warp, masks):
    dev = x.device
    for name, t, shape in (("x", x, (x.shape[0], 3)), ("d", d, (x.shape[0], 3))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [N, 3] tensor on {dev}")
    if x.requires_grad or d.requires_grad:
        raise NotImplementedError(
            "fused MLP kernel: gradients wrt points/directions (the input_grads=True mode, "
            "used by per-ray poses and pre-encoded inputs) are not ported yet")
    width = weights[0].shape[1]
    if width % 128 != 0 or width > 256:
        raise ValueError(f"fused MLP kernel needs width 128 or 256, got {width}")
    if not 0 <= n_blocks <= MAX_BLOCKS:
        raise ValueError(f"fused MLP kernel takes at most {MAX_BLOCKS} blocks, got {n_blocks}")
    if weights[0].shape[0] != encoding_dim(3, pe[0]) or encoding_dim(3, pe[0]) > EW \
            or weights[-4].shape[0] != width + encoding_dim(3, pe[1]) \
            or encoding_dim(3, pe[1]) > EW:
        raise ValueError("fused MLP kernel: weights do not match the encoding widths")
    for w in weights:
        if w.device != dev or w.dtype != torch.float32:
            raise ValueError(f"fused MLP weights must be float32 on {dev}")
    for name, t, shape in (("warp", warp, (16,)),
                           *((f"pe mask {i}", m, (EW,)) for i, m in enumerate(masks or ()))):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on {dev}")


def fused_field_apply(params: Dict[str, Any], x, d, n_blocks: int, pe,
                      pe_masks=None, warp=None):
    """Fused field MLP on raw points x [N, 3] and directions d [N, 3] ->
    (raw_alpha [N], raw_rgb [N, 3]), differentiable in the params and the
    packed [16] warp. pe = (multires, multires_views); pe_masks = ([EW],
    [EW]) BARF column masks (see pe_mask_row) or None.

    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    weights = flatten_params(params, n_blocks)
    if x.device.type == "cpu":
        out = fused_mlp_plain(x, d, weights, n_blocks, pe, warp=warp, masks=pe_masks)
    elif x.device.type == "cuda":
        _check_cuda_inputs(x, d, weights, n_blocks, pe, warp, pe_masks)
        mx, md = pe_masks if pe_masks is not None else (None, None)
        out = _FusedMLP.apply(x, d, warp, mx, md, n_blocks, tuple(pe), *weights)
    else:
        raise ValueError(f"fused MLP: unsupported device {x.device}")
    return out[:, 0], out[:, 1:4]
