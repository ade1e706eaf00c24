"""Parameters between the JAX package and the port.

The layout is the same on both sides (models/fields.py): per field
{"lin_in", "blocks": [{"fc0", "fc1"}], "lin_out", "alpha", "feature",
"views", "rgb"}, each {"w": [in, out], "b": [out]}; dynamic fields stacked
on a leading [K]; online params {"nerf": ..., "poses": [F-1, K, 7]}. So the
conversion maps every leaf: numpy arrays (``np.asarray`` of the JAX leaves)
to tensors, and tensors back to numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.tree import tree_map


def params_from_numpy(tree, device=None, requires_grad: bool = False):
    """Nested dicts/lists of arrays -> the same structure of float32 tensors."""

    def leaf(a):
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
        return t.requires_grad_(requires_grad)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """Nested dicts/lists of tensors -> the same structure of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
