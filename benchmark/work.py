"""The yardstick's arithmetic: FLOP and bytes of the fused field MLP's
kernels, counted from shapes, and the published peaks of one H100.

A frozen copy of chip_smoke.py's ``PEAK_FLOPS``, ``PEAK_F32``,
``PEAK_BYTES``, ``kernel_work``, ``bound`` and ``kernel_cases`` as of
commit b3834b996f3b0859b50648795287590a0078e9bf, taken from shapes alone
(no tensor and no import of the program), with the kernels' layout
constants copied beside them (csrc/fused_mlp.cu: T, EW, XW, partial_offsets;
kernels/fused_mlp.py: wgrad_shapes, wgrad_splits). ``wgrad_work`` and
``sum_rows_work`` are the work chip_smoke.py's phase 3c counts for the
weight-gradient GEMM and the ordered sums. A step kind lists its own calls
(steps/<kind>.py, ``calls``) from ``field_shapes`` and ``points``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
# them, HBM3 bandwidth (700 W).
PEAK_FLOPS = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TILE_POINTS = 64  # T: points a CTA of the per-tile backward
EW = 64  # padded encoding width (63 point and 27 direction columns)
XW = 96  # padded width of pre-encoded point features
WG_ROWS = 128  # wgrad_kernel: output rows a CTA
SMS = 132
WG_SPLIT_ROWS = 49152


@dataclasses.dataclass(frozen=True)
class FieldShape:
    """One field's widths: ``depth`` layers of ``width`` (depth // 2
    residual blocks), positional encodings of ``multires`` and
    ``multires_views`` frequencies on 3-d inputs."""

    depth: int
    width: int
    multires: int = 10
    multires_views: int = 4

    @property
    def n_blocks(self) -> int:
        return self.depth // 2

    @property
    def in_ch(self) -> int:
        return 3 * (1 + 2 * self.multires)

    @property
    def view_ch(self) -> int:
        return 3 * (1 + 2 * self.multires_views)

    @property
    def n_params(self) -> int:
        W, w2 = self.width, self.width // 2
        return ((self.in_ch + 1) * W + 2 * self.n_blocks * (W + 1) * W + (W + 1) * W
                + (W + 1) + (W + 1) * W + (W + self.view_ch + 1) * w2 + (w2 + 1) * 3)


@dataclasses.dataclass(frozen=True)
class FieldCall:
    """One forward + backward call of the fused kernels in a step: K fields
    of one shape (K > 1: the field-axis instance, one launch) on n points a
    field; ``warped``: the in-kernel SE(3) warp with its pose sums;
    ``input_grads``: the backward writes per-point input grads."""

    name: str
    field: FieldShape
    n: int
    fields: int = 1
    warped: bool = False
    input_grads: bool = False


def kernel_work(f: FieldShape, n_points: int, fields: int, pe: bool, input_grads: bool,
                warped: bool, save: bool = True) -> Dict[str, Tuple[float, float]]:
    """chip_smoke.kernel_work from shapes: FLOP and bytes of one call,
    {"fwd", "bwd", "bwd_tile"}: the multiply-adds of every layer at its real
    widths (the encoding's padding and the PE's sin/cos not counted), each
    input read once and each output written once. "bwd_tile" is the
    per-tile backward kernel's share of "bwd"."""
    n = fields * n_points
    W, in_ch = f.width, f.in_ch
    view_ch, w2 = f.view_ch, W // 2
    nb = f.n_blocks
    macs = in_ch * W + (2 * nb + 2) * W * W + W + (W + view_ch) * w2 + 3 * w2
    data = macs - (0 if input_grads or warped else in_ch * W + view_ch * w2)
    param_bytes = 4 * fields * f.n_params
    in_bytes = 4 * ((in_ch + view_ch) if not pe else 6)
    act_bytes = 2 * ((2 * nb + 3) * W + w2)
    fwd = (2 * macs * n, n * (in_bytes + (act_bytes if save else 0) + 16) + param_bytes)
    bwd = (2 * (macs + data) * n,
           n * (in_bytes + act_bytes + 16 + (in_bytes if input_grads else 0)) + 2 * param_bytes)
    enc_bytes = 2 * ((EW if pe else XW) + EW)
    tile_reads = act_bytes - 2 * W  # every saved activation but feat
    dy_bytes = act_bytes
    bwd_tile = (2 * data * n, n * (in_bytes + tile_reads + dy_bytes + 16 + enc_bytes
                                   + (in_bytes if input_grads else 0)) + param_bytes)
    return {"fwd": fwd, "bwd": bwd, "bwd_tile": bwd_tile}


def bound(flop: float, nbytes: float, peak: float = PEAK_FLOPS) -> Tuple[float, str]:
    """(bound ms, "operations" or "bytes"): the larger of flop at the peak
    and bytes at the memory rate."""
    t_op, t_b = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def kernel_cases(static: FieldShape, dynamic: FieldShape, n_rand: int, n_samples: int,
                 n_importance: int, num_vehicles: int):
    """chip_smoke.kernel_cases from shapes: the field calls of one
    shared-pose online step as (name, field, points, warped, calls a step),
    the dynamic fields' K times (the BARF case, checked but never timed
    there, left out)."""
    n_coarse = n_rand * n_samples
    n_fine = n_rand * (n_samples + n_importance)
    return [("static coarse", static, n_coarse, False, 1),
            ("static fine", static, n_fine, False, 1),
            ("dynamic coarse", dynamic, n_coarse, True, num_vehicles),
            ("dynamic fine", dynamic, n_fine, True, num_vehicles)]


def field_shapes(flags: Dict) -> Tuple[FieldShape, FieldShape, FieldShape, FieldShape]:
    """The configuration's static coarse, static fine, dynamic coarse and
    dynamic fine fields (a dynamic field has half its static field's
    depth)."""
    def shape(depth, width):
        return FieldShape(depth, width, flags["multires"], flags["multires_views"])

    return (shape(flags["netdepth"], flags["netwidth"]),
            shape(flags["netdepth_fine"], flags["netwidth_fine"]),
            shape(flags["netdepth"] // 2, flags["netwidth"]),
            shape(flags["netdepth_fine"] // 2, flags["netwidth_fine"]))


def points(flags: Dict) -> Tuple[int, int]:
    """Points a field of the coarse and of the fine pass of a step."""
    n_rand, n_samples = flags["N_rand"], flags["N_samples"]
    return n_rand * n_samples, n_rand * (n_samples + flags["N_importance"])


def partial_total(width: int, n_blocks: int) -> int:
    """Floats of one CTA's partials (partial_offsets in csrc/fused_mlp.cu):
    bias grads, narrow-head weight grads and the 12 pose sums."""
    W = width
    return W + 2 * W * n_blocks + W + W + W // 2 + 1 + 3 + W + (W // 2) * 3 + 12


def wgrad_shapes(width: int, n_blocks: int, in_rows: int = EW):
    """(k_in, n_out) of every wide layer's dW = X^T dY of a backward call."""
    w2 = width // 2
    return ([(in_rows, width)] + [(width, width)] * (2 * n_blocks)
            + [(width, width), (width, width), (width, w2), (EW, w2)])


def wgrad_splits(n: int, tiles: int) -> int:
    return max(1, min(2 * SMS // tiles, n // 1024), -(-n // WG_SPLIT_ROWS))


def wgrad_work(call: FieldCall) -> Tuple[float, float]:
    """wgrad_kernel's FLOP and bytes for one backward call: every wide
    layer's X and dY read once (bf16), its f32 partial written once."""
    K, n = call.fields, call.n
    shapes = wgrad_shapes(call.field.width, call.field.n_blocks)
    sizes = [k * m for k, m in shapes]
    flop = sum(2.0 * K * n * s for s in sizes)
    nbytes = sum(2.0 * K * n * (k + m) for k, m in shapes) + 4.0 * K * sum(sizes)
    return flop, nbytes


def sum_rows_work(call: FieldCall) -> List[Tuple[float, float]]:
    """(FLOP, bytes) of each of a backward call's two sum_rows_kernel
    launches: the per-CTA partials and the GEMM's split partials, each
    input read once and each output written once in f32."""
    K, n, f = call.fields, call.n, call.field
    total = partial_total(f.width, f.n_blocks)
    shapes = wgrad_shapes(f.width, f.n_blocks)
    wtotal = sum(k * m for k, m in shapes)
    tiles = sum(-(-k // WG_ROWS) for k, _ in shapes)
    splits = wgrad_splits(n, K * tiles)
    out = []
    for rows, cols in ((-(-n // TILE_POINTS), total), (splits, wtotal)):
        n_in, n_out = K * rows * cols, K * cols
        out.append((float(n_in), 4.0 * (n_in + n_out)))
    return out


def call_bounds(call: FieldCall) -> Dict[str, float]:
    """Bound ms of each kernel name's launches in one field call (forward,
    per-tile backward, weight-gradient GEMM, the two ordered sums)."""
    w = kernel_work(call.field, call.n, call.fields, True, call.input_grads, call.warped)
    return {"fwd_kernel": bound(*w["fwd"])[0],
            "bwd_kernel": bound(*w["bwd_tile"])[0],
            "wgrad_kernel": bound(*wgrad_work(call))[0],
            "sum_rows_kernel": sum(bound(*s, PEAK_F32)[0] for s in sum_rows_work(call))}


def step_flop(calls: List[FieldCall]) -> float:
    """Model FLOP of one step: every field call's forward and backward
    (recomputation not counted)."""
    total = 0.0
    for c in calls:
        w = kernel_work(c.field, c.n, c.fields, True, c.input_grads, c.warped)
        total += w["fwd"][0] + w["bwd"][0]
    return total
