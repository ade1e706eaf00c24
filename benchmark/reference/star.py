"""STaR's training step in plain PyTorch: the reference that decides
``correct``.

One static NeRF field plus K rigid dynamic fields, each an MLP over the
positional encoding of points and view directions (NeRF's network with
residual blocks); the dynamic fields see the points warped into each
vehicle's frame by its SE(3) pose; coarse samples, a joint transmittance
over all fields, inverse-CDF importance samples and a fine pass; the
photometric loss with STaR's regularizers; Adam
with a learning rate per group, gradient accumulation, a global-norm clip,
and the quaternions renormalised after each step.

It imports nothing of the program and takes nothing the program made: the
caller hands it the inputs it made itself (weights, poses, batches and
draws). Matrix products run in float32 with TF32 off (``"f32"``), or, for
the control, in float8 as fp8 training runs them (``"fp8"``): the
forward's operands in e4m3, the backward's cotangent in e5m2, each under a
per-tensor scale. The rays of a batch are
rendered in chunks, each chunk's share of the loss backpropagated on its
own: every mean is over the whole batch, so the shares sum to the loss and
the grads to its gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

EPS = 1.1920928955078125e-07  # float32 machine epsilon
TRANS_EPS = 1e-10
PDF_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Model:
    """What the reference reads of a configuration's flags."""

    num_vehicles: int
    depth: int
    width: int
    depth_fine: int
    width_fine: int
    multires: int
    multires_views: int
    n_samples: int
    n_importance: int
    near: float
    far: float
    far_dist: float
    lambdas: Dict[str, float]

    @staticmethod
    def from_flags(flags: Dict) -> "Model":
        unsupported = {
            "lindisp": False, "white_bkgd": False, "raw_noise_std": 0.0, "perturb": 1.0,
            "i_embed": 0, "reference_numerics": False, "stratified_fine": True,
            "lambda_static_reg": 0.0, "lambda_dynamic_reg": 0.0, "sigma_loss": False,
            "pose_trans_only": False, "use_viewdirs": True, "depth_loss": False,
        }
        for key, want in unsupported.items():
            if flags.get(key, want) != want:
                raise NotImplementedError(f"the reference runs {key} = {want} only")
        scale = flags["scale_factor"] if flags.get("scale_factor", -1) > 0 else 1.0
        return Model(
            num_vehicles=flags["num_vehicles"], depth=flags["netdepth"], width=flags["netwidth"],
            depth_fine=flags["netdepth_fine"], width_fine=flags["netwidth_fine"],
            multires=flags["multires"], multires_views=flags["multires_views"],
            n_samples=flags["N_samples"], n_importance=flags["N_importance"],
            near=flags["near"] * scale, far=flags["far"] * scale, far_dist=flags["far_dist"],
            lambdas={k: flags.get("lambda_" + k, 0.0)
                     for k in ("alpha_entropy", "dynamic_vs_static_reg", "ray_reg")})


# ---------------------------------------------------------------- products


def _fp8(a, fmt):
    """a rounded to a float8 format under a per-tensor scale that maps its
    largest magnitude to the format's largest value, read back in float32."""
    amax = a.detach().abs().amax().clamp(min=1e-30)
    s = torch.finfo(fmt).max / amax
    return (a * s).to(fmt).to(torch.float32) / s


class _Fp8Dot(torch.autograd.Function):
    """fp8 training's usual recipe: the forward's operands in e4m3, the
    backward's cotangent in e5m2, f32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _fp8(g, torch.float8_e5m2)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def dot_for(precision: str) -> Callable:
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Dot.apply
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------------ fields


def encode(x, num_freqs: int):
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...], each group 3 wide."""
    bands = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * bands[:, None]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    return torch.cat([x, enc.reshape(x.shape[:-1] + (6 * num_freqs,))], dim=-1)


def field(p: Dict, pts, dirs, model: Model, dot):
    """NeRF's field with residual blocks on points [N, 3] and directions
    [N, 3] -> (raw density [N], raw rgb [N, 3])."""
    xe = encode(pts, model.multires)
    de = encode(dirs, model.multires_views)
    width = p["lin_in"]["w"].shape[1]

    def lin(name, a):
        return dot(a, p[name]["w"]) + p[name]["b"]

    h = lin("lin_in", xe)
    for blk in p["blocks"]:
        n = dot(F.relu(h), blk["fc0"]["w"]) + blk["fc0"]["b"]
        h = h + dot(F.relu(n), blk["fc1"]["w"]) + blk["fc1"]["b"]
    ho = lin("lin_out", F.relu(h))
    alpha = lin("alpha", ho)
    feat = lin("feature", ho)
    wv = p["views"]["w"]
    hv = F.relu(dot(feat, wv[:width]) + dot(de, wv[width:]) + p["views"]["b"])
    rgb = lin("rgb", hv)
    return alpha[:, 0], rgb


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def warp(pose7, pts, dirs):
    """Points [R, S, 3] and directions [R, 3] into a vehicle's frame by its
    pose [7], shared by the rays: x -> R(q) x + t."""
    M = quat_to_matrix(pose7[3:7])
    return pts @ M.transpose(0, 1) + pose7[:3], dirs @ M.transpose(0, 1)


# -------------------------------------------------------------- rendering


def _alpha(raw, dists):
    return 1.0 - torch.exp(-F.softplus(raw) * dists)


def _transmittance(alpha):
    ones = torch.ones_like(alpha[..., :1])
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + TRANS_EPS], -1), -1)[..., :-1]


def composite(raw_s, rgb_s, raw_d, rgb_d, z, rays_d, model: Model):
    """Static [R, S], [R, S, 3] and dynamic [R, K, S], [R, K, S, 3] raw
    outputs under one transmittance of the summed densities. raw_d None:
    the static field alone. Returns rgb, depth, weights and, with dynamic
    fields, the per-sample alphas and densities the regularizers read."""
    d = z[..., 1:] - z[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], model.far_dist)], -1)
    dists = d * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    c_s = torch.sigmoid(rgb_s)
    a_s = _alpha(raw_s, dists)
    if raw_d is None:
        w = a_s * _transmittance(a_s)
        return {"rgb": torch.sum(w[..., None] * c_s, -2), "depth": torch.sum(w * z, -1),
                "weights": w}
    c_d = torch.sigmoid(rgb_d)
    sig_s, sig_d = F.softplus(raw_s), F.softplus(raw_d)
    sig_t = sig_s + sig_d.sum(1)
    a_d = _alpha(raw_d, dists[:, None, :])
    a_t = 1.0 - torch.exp(-sig_t * dists)
    T = _transmittance(a_t)
    rgb = torch.sum(T[..., None] * (a_s[..., None] * c_s + torch.sum(a_d[..., None] * c_d, 1)),
                    -2)
    w = T * a_t
    return {"rgb": rgb, "depth": torch.sum(w * z, -1), "weights": w, "a_s": a_s, "a_d": a_d,
            "sig_d": sig_d, "sig_t": sig_t}


def sample_pdf(bins, weights, u):
    """Stratified inverse-CDF samples (i + u_i) / I of the histogram."""
    n = u.shape[-1]
    w = weights + PDF_EPS
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = ((torch.arange(n, dtype=cdf.dtype, device=cdf.device) + u) / n).contiguous()
    below = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    above = torch.clamp(below + 1, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def _fields(params: Dict, fine: bool, pts, viewdirs, z, rays_d, pose, model: Model, dot):
    R, S = z.shape
    dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    sfx = "fine" if fine else "coarse"
    a_s, c_s = field(params["static_" + sfx], pts.reshape(-1, 3), dirs, model, dot)
    a_s, c_s = a_s.reshape(R, S), c_s.reshape(R, S, 3)
    if pose is None:
        return composite(a_s, c_s, None, None, z, rays_d, model)
    dyn = params["dynamic_" + sfx]
    outs = []
    for k in range(model.num_vehicles):
        p_k = _slice(dyn, k)
        pk, dk = warp(pose[..., k, :], pts, viewdirs)
        dk = dk[:, None, :].expand(R, S, 3).reshape(-1, 3)
        outs.append(field(p_k, pk.reshape(-1, 3), dk, model, dot))
    a_d = torch.stack([o[0].reshape(R, S) for o in outs], 1)
    c_d = torch.stack([o[1].reshape(R, S, 3) for o in outs], 1)
    return composite(a_s, c_s, a_d, c_d, z, rays_d, model)


def _slice(tree, k):
    if isinstance(tree, dict):
        return {key: _slice(v, k) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_slice(v, k) for v in tree]
    return tree[k]


def render(params: Dict, model: Model, rays_o, rays_d, pose, u_strat, u_pdf, dot):
    """Coarse pass at the jittered depths, importance samples from its
    weights, fine pass over the sorted union."""
    R, S = rays_o.shape[0], model.n_samples
    t = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    z = (model.near * (1.0 - t) + model.far * t).expand(R, S)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    lower = torch.cat([z[..., :1], mids], -1)
    upper = torch.cat([mids, z[..., -1:]], -1)
    z = lower + (upper - lower) * u_strat
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    coarse = _fields(params, False, pts, viewdirs, z, rays_d, pose, model, dot)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_imp = sample_pdf(z_mid, coarse["weights"][..., 1:-1], u_pdf).detach()
    z_all, _ = torch.sort(torch.cat([z, z_imp], -1), -1)
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
    fine = _fields(params, True, pts_f, viewdirs, z_all, rays_d, pose, model, dot)
    return coarse, fine


# ------------------------------------------------------------------ losses


def loss_share(coarse, fine, batch, rows: slice, n_rays: int, model: Model, online: bool):
    """This chunk's share of the batch's loss: every mean over rays divides
    by the whole batch's n_rays."""
    target = batch["target"][rows]
    loss = sum(torch.sum((o["rgb"] - target) ** 2) / (3 * n_rays) for o in (coarse, fine))
    if online:
        K = model.num_vehicles
        for name, lam in model.lambdas.items():
            if lam > 0:
                v = sum(_reg(name, o, n_rays, K) for o in (coarse, fine)) / 2.0
                loss = loss + lam * v
    return loss


def _reg(name, o, n_rays, K):
    a_s, a_d = o["a_s"], o["a_d"]
    S = a_s.shape[-1]
    if name == "alpha_entropy":
        def ent(a):
            c = torch.clamp(a, EPS, 1.0 - EPS)
            return a * torch.log(c) + (1.0 - a) * torch.log1p(-c)
        return -(ent(a_s).sum() + ent(a_d).sum()) / (n_rays * S) / (K + 1)
    if name == "dynamic_vs_static_reg":
        tot = a_s + a_d.sum(1)
        den = torch.clamp(tot, min=EPS)
        sn = torch.clamp(a_s / den, min=EPS)
        dn = torch.clamp(a_d / den[:, None, :], min=EPS)
        return -torch.sum(tot * (sn * torch.log(sn) + torch.sum(dn * torch.log(dn), 1))) \
            / (n_rays * S)
    if name == "ray_reg":
        normed = o["sig_d"] / torch.clamp(o["sig_t"], min=EPS)[:, None, :]
        return torch.sum(torch.amax(normed, -1) ** 2) / n_rays / K
    raise ValueError(name)


# -------------------------------------------------------------- optimizer


def schedule(lrate: float, decay_rate: float = 0.5, decay_epochs: Optional[int] = None,
             decay_milestones: Optional[Sequence[int]] = None, steps_per_epoch: int = 1,
             cosine_t_max: int = 60000, cosine_eta_min: float = 1e-4):
    """The learning rate at an update count: milestones (x decay_rate at
    each), a staircase every decay_epochs, or else a cosine decay."""
    if decay_milestones:
        bounds = sorted(int(m) * steps_per_epoch for m in decay_milestones)
        return lambda c: lrate * decay_rate ** sum(c >= b for b in bounds)
    if decay_epochs:
        return lambda c: lrate * decay_rate ** (c // (int(decay_epochs) * steps_per_epoch))
    alpha = cosine_eta_min / max(lrate, 1e-12)
    return lambda c: lrate * ((1 - alpha) * 0.5 * (1 + math.cos(
        math.pi * min(c, cosine_t_max) / cosine_t_max)) + alpha)


class Adam:
    """Adam over named leaves, a schedule per group; ``accumulate`` > 1
    folds each step's grads into a running mean and updates on every
    accumulate-th step; ``clip``: the global norm of the (mean) grad.
    It resumes from ``count`` updates, ``mini_step`` mini-steps into the
    accumulation and the second moment ``v`` (a leaf's, by name; zero where
    None), with the first moment and the accumulator zero. ``clip_norms``
    records the global norm the clip read at each update."""

    def __init__(self, leaves: Dict[str, torch.Tensor], groups: Dict[str, int],
                 schedules: List, clip: Optional[float], accumulate: int = 1,
                 mini_step: int = 0, count: int = 0,
                 v: Optional[Dict[str, torch.Tensor]] = None, b1=0.9, b2=0.999, eps=1e-8):
        self.leaves, self.groups, self.schedules = leaves, groups, schedules
        self.clip, self.k, self.mini = clip, accumulate, mini_step
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = count
        self.m = {n: torch.zeros_like(p) for n, p in leaves.items()}
        self.v = {n: (torch.zeros_like(p) if v is None else
                      v[n].detach().to(p.device, torch.float32).clone())
                  for n, p in leaves.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in leaves.items()}
        self.clip_norms: List[float] = []

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        g = grads
        if self.k > 1:
            for n in self.acc:
                self.acc[n] += (g[n] - self.acc[n]) / (self.mini + 1)
            self.mini += 1
            if self.mini < self.k:
                return
            g = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
            self.mini = 0
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        self.clip_norms.append(float(norm))
        if self.clip is not None:
            scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-12), max=1.0)
            g = {n: x * scale for n, x in g.items()}
        lrs = [s(self.count) for s in self.schedules]
        self.count += 1
        for n, p in self.leaves.items():
            self.m[n].mul_(self.b1).add_((1 - self.b1) * g[n])
            self.v[n].mul_(self.b2).add_((1 - self.b2) * g[n] * g[n])
            mhat = self.m[n] / (1 - self.b1 ** self.count)
            vhat = self.v[n] / (1 - self.b2 ** self.count)
            p.add_(-lrs[self.groups[n]] * mhat / (torch.sqrt(vhat) + self.eps))
