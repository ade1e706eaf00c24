"""NeRF positional encoding and BARF coarse-to-fine weights (PyTorch).

Counterpart of startrax/ops/encoding.py. The layout is the reference
Embedder's: [x, sin(x f0), cos(x f0), sin(x f1), cos(x f1), ...], with each
sin/cos group three columns wide. The mip-NeRF IPE is not ported yet.
"""

from __future__ import annotations

import math

import torch


def encoding_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dims * (int(include_input) + 2 * num_freqs)


def barf_weights(step, end_barf: int, num_freqs: int, start: int = 0, device=None):
    """Per-frequency BARF weights in [0, 1]: frequency k fades in as
    (1 - cos(pi * clamp(alpha - k, 0, 1))) / 2, alpha = (step - start) /
    (end_barf - start) * num_freqs."""
    alpha = (float(step) - start) / (end_barf - start) * num_freqs
    k = torch.arange(num_freqs, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def positional_encoding(x, num_freqs: int, include_input: bool = True, step=None,
                        end_barf: int = -1):
    """x [..., d] -> [..., d * (include_input + 2 num_freqs)]; the sin/cos
    bands are masked by the BARF schedule when step is given and end_barf > 0."""
    bands = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * bands[:, None]  # [..., F, d]
    sin = torch.sin(scaled)
    cos = torch.cos(scaled)
    if step is not None and end_barf > 0:
        w = barf_weights(step, end_barf, num_freqs, device=x.device)[:, None].to(x.dtype)
        sin = sin * w
        cos = cos * w
    enc = torch.stack([sin, cos], dim=-2).reshape(x.shape[:-1] + (2 * num_freqs * x.shape[-1],))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
