"""The traced stretch: a few steps under torch.profiler (CPU and CUDA),
read into the device's operations, its busy time, and the host's
operations that were running when the device stood idle."""

from __future__ import annotations

import dataclasses
import re
import sys
import time
from typing import Callable, List, Tuple


@dataclasses.dataclass
class Trace:
    """ops: the device's operations (kernels, copies, sets) as (name,
    start ns, end ns, is a kernel); host: the host's operations as (name,
    start ns, end ns); window_s: the stretch's length by the host's
    clock, from the first step's call to the synchronize after the last;
    steps: the steps in it."""

    ops: List[Tuple[str, int, int, bool]]
    host: List[Tuple[str, int, int]]
    window_s: float
    steps: int

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for _, a, b, _ in sorted(self.ops, key=lambda o: o[1]):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e9

    def kernel_seconds(self):
        """{base name: seconds} of the kernels (base_name)."""
        out = {}
        for name, a, b, kernel in self.ops:
            if kernel:
                key = base_name(name)
                out[key] = out.get(key, 0.0) + (b - a) / 1e9
        return out

    def device_ops(self, top: int = 10):
        """The device operations that took the most time, [name, seconds]."""
        out = {}
        for name, a, b, _ in self.ops:
            key = short_name(name)
            out[key] = out.get(key, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device operations, each named by the
        host operation (innermost, with its caller where it is a CUDA
        runtime call) that was running when the gap began, [name, seconds]."""
        ops = sorted(self.ops, key=lambda o: o[1])
        gaps, end = [], None
        for _, a, b, _ in ops:
            if end is not None and a > end:
                gaps.append((a - end, end))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        return [[self._host_at(t), g / 1e9] for g, t in gaps[:top]]

    def _host_at(self, t: int) -> str:
        covering = [h for h in self.host if h[1] <= t < h[2]]
        if not covering:
            return "no host operation"
        covering.sort(key=lambda h: h[2] - h[1])
        name = covering[0][0]
        if name.startswith("cu") and len(covering) > 1:
            name = f"{covering[1][0]} > {name}"
        return name


def base_name(name: str) -> str:
    """A kernel's name without return type, namespace, template arguments
    or parameters: "void fwd_kernel<0, 0>(Inputs, ...)" -> "fwd_kernel"."""
    n = short_name(name).replace("(anonymous namespace)::", "")
    n = re.split(r"[<(]", n, maxsplit=1)[0]
    return n.split("::")[-1].strip()


def short_name(name: str) -> str:
    """A device operation's name without return type and parameters."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(n)
    for i, c in enumerate(n):  # the first "(" outside the template arguments
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            cut = i
            break
    return n[:cut][:120]


def _is_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _kind(e):
    """"kernel", "copy" or None (an annotation or the profiler's own
    record, not an operation of the program)."""
    name = e.name()
    activity = str(getattr(e, "activity_type", lambda: "")()).lower()
    if getattr(e, "is_user_annotation", lambda: False)():
        return None
    if "memcpy" in activity or "memset" in activity:
        return "copy"
    if "kernel" in activity:
        return "kernel"
    if activity and not activity.isdigit():  # annotations, the profiler's own records
        return None
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return None if name.startswith(("ProfilerStep", "Activity Buffer")) else "kernel"


def profile(run_step: Callable[[int], None], steps: int) -> Trace:
    """steps calls of run_step(i) under the profiler, then a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run_step(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops, host, kinds = [], [], {}
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            at = str(getattr(e, "activity_type", lambda: "")())
            kinds[at] = kinds.get(at, 0) + 1
            kind = _kind(e)
            if kind is not None and d > 0:
                ops.append((e.name(), a, a + d, kind == "kernel"))
        else:
            host.append((e.name(), a, a + d))
    print(f"device records by activity: {kinds}", file=sys.stderr)
    return Trace(ops, host, window, steps)
