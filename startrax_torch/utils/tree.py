"""Helpers over nested parameter containers (dicts with sorted keys, lists).

The port keeps the JAX package's parameter layout: nested dicts and lists of
tensors, with K dynamic fields stacked on a leading axis.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_stack(trees):
    """Trees of one structure -> one tree whose leaves stack theirs on a new
    leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)
