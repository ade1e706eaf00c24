"""The port's device rule: entry points run on the card unless told otherwise.

Every entry point that makes tensors (the ``init_*`` functions,
``convert.params_from_numpy``, ``ops.rays.get_rays``, the eval renders) takes
``device=None`` and passes it through ``resolve``: None means the CUDA
device, and where there is none it raises. It never falls back to the CPU;
the CPU is asked for by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device to make tensors on: ``device`` itself, or the CUDA device
    when it is None. Raises when it is None and there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("startrax_torch runs on the GPU by default and found no CUDA device; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
