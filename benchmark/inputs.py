"""Everything a run feeds the program, made on the device from ``--seed``:
the weights, the pose table, the optimizer's resumed state, and a pool of
batches with their draws.

The same seed gives the same inputs. Every seed gives the same sizes (rays,
samples, frames); only the values and the order of frames differ. The
weights are one draw of normal numbers scaled leaf by leaf (He-normal,
half the variance in each residual block's second layer so that the trunk
stays in range, small random biases): a trained field's weights are not
in the repository, and every leaf then carries gradient from the first
step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.train import leaves_of


def _field_spec(width: int, multires: int, multires_views: int):
    """{layer: (rows, cols, std)} of one field's layers outside its
    residual blocks."""
    in_ch, view_ch = 3 * (1 + 2 * multires), 3 * (1 + 2 * multires_views)
    w2 = width // 2

    def he(rows):
        return math.sqrt(2.0 / rows)

    spec = {"lin_in": (in_ch, width, he(in_ch)), "lin_out": (width, width, he(width)),
            "alpha": (width, 1, he(width)), "feature": (width, width, he(width)),
            "views": (width + view_ch, w2, he(width + view_ch)),
            "rgb": (w2, 3, math.sqrt(2.0 / (w2 + 3)))}
    return spec


BIAS_STD = 0.05


@dataclasses.dataclass
class Resume:
    """The optimizer's state a run resumes from, handed to the program and
    to the reference alike: ``count`` updates made, ``mini_step`` mini-steps
    into the accumulation (k - 2 of k, so that the second step updates;
    the accumulator and the first moment zero), and the second moment
    ``v`` a leaf, by leaf path."""

    count: int
    mini_step: int
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass
class Inputs:
    params: Dict  # {"nerf": ..., "poses": ...} with frames, else the fields alone
    batches: List[Dict]  # the pool, each batch with its draws u_strat, u_pdf
    rays: int
    resume: Resume


def _fields(flags: Dict, vehicles: int, gen, device):
    """The static and dynamic fields (coarse and fine) in one normal draw."""
    shapes = []  # (field name, stack size or None, depth, width)
    for fine in (False, True):
        depth = flags["netdepth_fine" if fine else "netdepth"]
        width = flags["netwidth_fine" if fine else "netwidth"]
        sfx = "fine" if fine else "coarse"
        shapes.append(("static_" + sfx, None, depth, width))
        shapes.append(("dynamic_" + sfx, vehicles, depth // 2, width))
    plan = []  # (path, shape, std)
    for name, K, depth, width in shapes:
        lead = () if K is None else (K,)
        spec = _field_spec(width, flags["multires"], flags["multires_views"])
        for layer, (rows, cols, std) in spec.items():
            plan += [((name, layer, "w"), lead + (rows, cols), std),
                     ((name, layer, "b"), lead + (cols,), BIAS_STD)]
        for i in range(depth // 2):
            for layer in ("fc0", "fc1"):
                std = math.sqrt(2.0 / width) / (math.sqrt(2) if layer == "fc1" else 1.0)
                plan += [((name, i, layer, "w"), lead + (width, width), std),
                         ((name, i, layer, "b"), lead + (width,), BIAS_STD)]
    sizes = [math.prod(s) for _, s, _ in plan]
    stds = torch.tensor([s for _, _, s in plan], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(stds, torch.tensor(sizes, device=device))
    tree: Dict = {}
    for (path, shape, _), t in zip(plan, torch.split(flat, sizes)):
        name, rest = path[0], path[1:]
        f = tree.setdefault(name, {"blocks": []})
        if len(rest) == 3:  # a residual block's layer
            i, layer, leaf = rest
            while len(f["blocks"]) <= i:
                f["blocks"].append({})
            f["blocks"][i].setdefault(layer, {})[leaf] = t.view(shape)
        else:
            layer, leaf = rest
            f.setdefault(layer, {})[leaf] = t.view(shape)
    return tree


def second_moment_rms(path: str, table: Dict[str, float]) -> float:
    """The table's scale for a leaf: the entry named by one of the path's
    parts, the last such part first, else "*"."""
    for part in reversed(path.split("/")):
        if part in table:
            return table[part]
    return table["*"]


def _resume(flags: Dict, spec: Dict, params, gen, device) -> Resume:
    """The resumed state (Resume) from the workload's "resume": the second
    moment's root at each leaf's scale (second_moment_rms) times a factor
    log-uniform in [1/2, 2) an element, one draw for every leaf. A first
    moment of zero and a second moment above the gradient's square make the
    update linear in the gradient as the optimizer gets it (after the
    accumulation's mean and the clip), so its size is compared too."""
    leaves = list(leaves_of(params).items())
    sizes = [t.numel() for _, t in leaves]
    scales = torch.tensor([second_moment_rms(n, spec["second_moment_rms"]) for n, _ in leaves],
                          device=device)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    root = torch.repeat_interleave(scales, torch.tensor(sizes, device=device)) * 2.0 ** (2 * u - 1)
    v = {n: r.view_as(t) for (n, t), r in zip(leaves, torch.split(root * root, sizes))}
    k = flags.get("accumulate_grad_batches", 1)
    return Resume(int(spec["count"]), max(k - 2, 0), v)


def make(flags: Dict, workload: Dict, seed: int, device, pool: Optional[int] = None) -> Inputs:
    """The run's inputs from the seed (module docstring). ``workload``:
    "frames" ("shared": a pose table, and one frame a batch drawn from
    frame_range; absent: no poses), "pool" batches, "resume" (_resume);
    rays and samples as the configuration states them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    rng = np.random.default_rng(int(seed))
    K, F = flags["num_vehicles"], flags["num_frames"]
    R, S, I = flags["N_rand"], flags["N_samples"], flags["N_importance"]
    P = pool or workload["pool"]
    nerf = _fields(flags, K, gen, device)
    frames = workload.get("frames")
    if frames not in (None, "shared"):
        raise ValueError(f"unknown frames {frames!r}")
    if frames:
        noise = torch.randn(F - 1, K, 7, generator=gen, device=device)
        q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device) + 0.02 * noise[..., 3:]
        poses = torch.cat([0.05 * noise[..., :3], q / q.norm(dim=-1, keepdim=True)], -1)
        params = {"nerf": nerf, "poses": poses}
    else:
        params = nerf
    rays_o = torch.randn(P, R, 3, generator=gen, device=device)
    rays_d = torch.nn.functional.normalize(torch.randn(P, R, 3, generator=gen, device=device),
                                           dim=-1)
    target = torch.rand(P, R, 3, generator=gen, device=device)
    u_strat = torch.rand(P, R, S, generator=gen, device=device)
    u_pdf = torch.rand(P, R, I, generator=gen, device=device)
    if frames == "shared":
        lo, hi = workload["frame_range"]
        shared = [int(f) for f in rng.integers(lo, hi + 1, size=P)]
    resume = _resume(flags, workload["resume"], params, gen, device)
    batches = []
    for p in range(P):
        b = {"rays_o": rays_o[p], "rays_d": rays_d[p], "target": target[p],
             "u_strat": u_strat[p], "u_pdf": u_pdf[p]}
        if frames == "shared":
            b["frame"] = shared[p]
        batches.append(b)
    return Inputs(params, batches, R, resume)
