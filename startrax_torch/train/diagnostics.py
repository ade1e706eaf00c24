"""Runtime correctness diagnostics (PyTorch).

Counterpart of startrax/train/diagnostics.py's
``check_batch_gradient_isolation`` (the reference's CheckBatchGradient
callback): backpropagate one ray's output and assert that no other ray's
inputs receive a gradient, which catches any mixing across the batch.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def check_batch_gradient_isolation(render_fn: Callable, batch: Dict, output_key: str = "rgb",
                                   ray_index: int = 0, atol: float = 0.0) -> None:
    """Raise if rays other than ``ray_index`` receive input gradients.

    render_fn(rays_o, rays_d) -> a result dict with per-ray outputs; it must
    be deterministic (an eval-mode renderer) and keep the graph from rays_o
    (so not one under torch.no_grad, as train.loop.make_eval_render is).
    batch["rays_o"], batch["rays_d"]: [R, 3] tensors or arrays."""
    rays_o = torch.as_tensor(batch["rays_o"]).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = render_fn(rays_o, torch.as_tensor(batch["rays_d"]))
        (g,) = torch.autograd.grad(out[output_key][ray_index].sum(), rays_o)
    g = g.detach().cpu().numpy()
    others = np.delete(g, ray_index, axis=0)
    if np.abs(others).max() > atol:
        bad = int(np.argmax(np.abs(others).sum(axis=-1)))
        raise AssertionError(
            f"batch gradient mixing: ray {bad} has nonzero input gradient "
            f"(max |g| = {np.abs(others).max():.3e}) when only ray "
            f"{ray_index}'s output was differentiated")
    if np.abs(g[ray_index]).max() == 0.0:
        raise AssertionError("selected ray received no gradient — check the graph")
