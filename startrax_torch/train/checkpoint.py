"""Checkpoint / resume with torch.save (PyTorch).

Counterpart of startrax/train/checkpoint.py, with the same contract:

1. an appearance checkpoint warm-starts online training by restoring only
   the static field weights (``restore_static_only``; ``copy_into`` puts
   its result into live leaves; the reference filters out keys containing
   "dynamic"),
2. a full resume restores the whole state: ``copy_into`` copies saved
   params into the live leaves that the optimizers hold, and
   ``FusedGroupAdam.load_state_dict`` the optimizer states,
3. pose trajectories are exported as TUM-style flat-matrix text with
   translations x100 (``save_poses_txt``).

A state is a nested dict (and lists) of tensors, numpy arrays and Python
scalars. It is saved under ``path/<step>/state.pt``: written into a
temporary directory that is then renamed, so a step directory is whole or
absent. ``step=None`` means the latest step. Restore puts every tensor on
the resolved device (device.resolve: the card by default).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve
from ..utils.tree import tree_leaves, tree_map
from .curriculum import CurriculumState

_STATE_FILE = "state.pt"


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _steps(path: str) -> List[int]:
    """The saved steps under path, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.exists(os.path.join(path, d, _STATE_FILE)))


def _step_dir(path: str, step: Optional[int]) -> str:
    path = _abspath(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    out = os.path.join(path, str(step))
    if not os.path.exists(os.path.join(out, _STATE_FILE)):
        raise FileNotFoundError(f"no checkpoint at step {step} under {path}")
    return out


def save_checkpoint(path: str, state: Dict[str, Any], step: int) -> str:
    """Save a state under path/step (replacing one saved there before).
    Tensors are saved detached. Returns the checkpoint dir."""
    path = _abspath(path)
    final = os.path.join(path, str(step))
    tmp = os.path.join(path, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    state = tree_map(lambda v: v.detach() if isinstance(v, torch.Tensor) else v, state)
    torch.save(state, os.path.join(tmp, _STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final


def restore_checkpoint(path: str, step: Optional[int] = None, device=None):
    """Restore a state saved by save_checkpoint (the latest step if None),
    its tensors on ``device`` (None: the card, device.resolve). The file
    holds numpy arrays, so it is unpickled in full: read only checkpoints
    this program wrote."""
    device = resolve(device)
    return torch.load(os.path.join(_step_dir(path, step), _STATE_FILE), map_location=device,
                      weights_only=False)


def checkpoint_keys(path: str, step: Optional[int] = None):
    """Top-level keys of a saved checkpoint."""
    state = torch.load(os.path.join(_step_dir(path, step), _STATE_FILE), map_location="cpu",
                       weights_only=False)
    return set(state.keys())


def restore_static_only(appearance_params, online_params):
    """Copy the static coarse/fine field weights from an appearance-init
    checkpoint into an online parameter tree, leaving dynamic fields and
    poses untouched. The result holds the checkpoint's own (detached)
    tensors; to warm-start leaves that an optimizer updates, copy it into
    them (copy_into)."""
    nerf = dict(online_params["nerf"])
    for k in ("static_coarse", "static_fine"):
        if k in appearance_params:
            nerf[k] = appearance_params[k]
    out = dict(online_params)
    out["nerf"] = nerf
    return out


@torch.no_grad()
def copy_into(live, saved) -> None:
    """Copy a saved tree into the live tree's leaf tensors in place (same
    structure and shapes): the leaves keep their identity, device and
    requires_grad, so an optimizer built on them goes on updating them.
    ``saved`` may hold tensors on any device or numpy arrays."""
    dst, src = tree_leaves(live), tree_leaves(saved)
    if len(dst) != len(src):
        raise ValueError(f"copy_into: {len(src)} saved leaves for {len(dst)} live ones")
    for d, s in zip(dst, src):
        s = torch.as_tensor(s)
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"copy_into: shape {tuple(s.shape)} for a leaf of {tuple(d.shape)}")
        d.copy_(s)


def gc_checkpoints(path: str, keep_last: int = 3):
    """Delete all but the newest `keep_last` checkpoint steps; returns the
    steps left."""
    path = _abspath(path)
    steps = _steps(path)
    for s in steps[:-keep_last] if keep_last > 0 else steps:
        shutil.rmtree(os.path.join(path, str(s)))
    return _steps(path)


def curriculum_to_dict(state: CurriculumState) -> Dict[str, Any]:
    return dataclasses.asdict(state)


def curriculum_from_dict(d: Dict[str, Any]) -> CurriculumState:
    return CurriculumState(**{k: v.item() if hasattr(v, "item") else v for k, v in d.items()})


def save_poses_txt(path: str, poses_mat: np.ndarray, scale: float = 100.0):
    """Export per-frame 4x4 poses as flat 16-float rows with translations
    scaled x100 (reference save_poses_to_file, utils/io.py:497-519)."""
    poses_mat = np.asarray(poses_mat).copy()
    poses_mat[..., :3, 3] *= scale
    flat = poses_mat.reshape(poses_mat.shape[0], -1)
    with open(path, "w") as f:
        for row in flat:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def load_poses_txt(path: str, scale: float = 100.0) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 4, 4)
    rows[..., :3, 3] /= scale
    return rows
