"""The fused-MLP CUDA kernels against their plain PyTorch version, on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc, and skip without a card.
They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``--noconftest`` leaves out tests/conftest.py, which sets up JAX.) The
shape is a small flagship-width field, 4 x 256, on 3000 points, so the last
point tile is ragged. The comparison and its limits are
startrax_torch.kernels.parity's, the same that chip_smoke.py applies at the
step's shapes: forward within 1e-2 (max) and 1.5e-3 (rms) of the output's
scale, weight grads within 2e-3 of each grad's largest magnitude, the pose
grad within 1.5e-2 of its largest component.
"""

import pytest
import torch

from startrax_torch import convert
from startrax_torch.kernels import fused_mlp as tfused
from startrax_torch.kernels import parity
from startrax_torch.models import fields as tfields
from startrax_torch.models.star import pack_warp
from startrax_torch.ops.encoding import barf_weights

N = 3000
PE = (10, 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(seed):
    cfg = tfields.FieldConfig(depth=4, width=256)
    g = torch.Generator().manual_seed(seed)
    params = tfields.init_field(cfg, g)
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    x = torch.randn(N, 3, generator=g).cuda()
    d = torch.nn.functional.normalize(torch.randn(N, 3, generator=g), dim=-1).cuda()
    return cfg, params, x, d


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "warped", "masked"])
def test_fused_kernels_match_plain(card, mode):
    cfg, params, x, d = _setup(seed=6)
    pose = torch.tensor([0.1, -0.2, 0.05, 0.1, 0.2, -0.1, 0.97], device=card)
    pose = (pose / torch.cat([torch.ones(3, device=card), pose[3:].norm().expand(4)]))
    pose.requires_grad_(True)
    warp = pack_warp(pose) if mode != "static" else None
    masks = None
    if mode == "masked":
        masks = tuple(tfused.pe_mask_row(barf_weights(37, 100, f, device=card), f) for f in PE)

    tfused.reset_launch_counts()
    errs, _ = parity.compare(params, x, d, cfg.n_blocks, PE, pe_masks=masks, warp=warp,
                             pose=pose if warp is not None else None)
    assert tfused.launches == {"fwd": 1, "bwd": 1}
    assert ("pose" in errs) == (warp is not None)
    assert not parity.failures(errs), errs


@pytest.mark.cuda
def test_input_grads_mode_raises(card):
    cfg, params, x, d = _setup(seed=7)
    with pytest.raises(NotImplementedError, match="input_grads"):
        tfused.fused_field_apply(params, x.requires_grad_(True), d, cfg.n_blocks, PE)
