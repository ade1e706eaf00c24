"""Vanilla NeRF on the Blender lego scene (appearance-init path, no poses)
(PyTorch).

Counterpart of startrax/apps/lego.py: the appearance-init trainer
(apps/app_init.py) with dataset_type = blender. On the card its steps run
the fused field kernels on raw points: per step a coarse and a fine
forward and backward call of the static field.

Usage: python -m startrax_torch.apps.lego --config startrax/configs/lego.txt [--key value ...]
"""

from __future__ import annotations

from ..utils.config import load_config
from . import app_init


def main(argv=None):
    """Train on the Blender capture at cfg.datadir, on the card; returns the
    parameters (app_init.train(cfg, device="cpu") runs it on the CPU)."""
    cfg = load_config(argv)
    cfg.dataset_type = "blender"
    return app_init.train(cfg)


if __name__ == "__main__":
    main()
