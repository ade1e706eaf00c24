"""startrax_torch: the PyTorch and CUDA port of startrax for NVIDIA Hopper.

The JAX package ``startrax`` beside it is the reference. Module names mirror
startrax's: ``ops/`` (Lie algebra, encoding, sampling, compositing, losses,
regularizers, rays), ``kernels/`` (the fused field MLP: hand-written CUDA
for sm_90a with a plain PyTorch version), ``models/`` (fields, STaR,
nerf_time), ``data/`` (the synthetic scene, prefetch, transforms),
``train/`` (optimizer, train steps, checkpoints, curriculum), ``eval/``
(renders, image and pose metrics), ``apps/`` (appearance init), ``utils/``
(the config parser, logging) and ``convert.py`` (parameters between the two
packages). This package never imports JAX nor anything of startrax.
"""

__version__ = "0.1.0"
