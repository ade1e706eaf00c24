"""startrax_torch: the PyTorch and CUDA port of startrax for NVIDIA Hopper.

The JAX package ``startrax`` beside it is the reference. Module names mirror
startrax's: ``ops/`` (Lie algebra, encoding, sampling, compositing, losses,
regularizers), ``kernels/`` (the fused field MLP: hand-written CUDA for
sm_90a with a plain PyTorch version), ``models/`` (fields, STaR), ``train/``
(optimizer, train steps), ``utils/config.py`` (adapter over startrax's
config parser) and ``convert.py`` (parameters between the two packages).
This package never imports JAX.
"""

__version__ = "0.1.0"
