"""Image quality metrics: MSE, PSNR (optionally over a pixel mask) and SSIM
(PyTorch).

Counterparts of startrax/eval/image.py's ``mse``, ``psnr``, ``ssim`` and
``masked_ssim``: SSIM with the 11x11 Gaussian window (sigma 1.5, k1 0.01,
k2 0.03, data range 1), a valid filter, so the full SSIM map of an [H, W, C]
image is [H-10, W-10, C]. LPIPS is not ported: it needs pretrained VGG
weights that the repository does not ship. The filter is a float32
convolution; on the card, where cuDNN may run it in TF32, callers that want
full float32 set ``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def mse(a, b):
    return torch.mean((a - b) ** 2)


def psnr(pred, target, mask=None):
    """PSNR in dB of images in [0, 1]; mask: an optional boolean pixel mask
    (broadcast over the trailing channel axes)."""
    err = (pred - target) ** 2
    if mask is None:
        v = torch.mean(err)
    else:
        m = mask.to(err.dtype)
        while m.dim() < err.dim():
            m = m[..., None]
        v = torch.sum(err * m) / torch.clamp(torch.sum(m.expand(err.shape)), min=1.0)
    return -10.0 * torch.log(v) / math.log(10.0)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred, target, return_full: bool = False, k1: float = 0.01, k2: float = 0.03,
         data_range: float = 1.0):
    """Mean SSIM of [H, W, C] images in [0, 1], or (mean, full map
    [H-10, W-10, C]) with return_full."""
    C = pred.shape[-1]
    kernel = torch.as_tensor(_gaussian_kernel(), device=pred.device)
    weight = kernel[None, None].expand(C, 1, *kernel.shape)

    def filt(img):  # depthwise valid filter: [H, W, C] -> [H-10, W-10, C]
        return F.conv2d(img.permute(2, 0, 1)[None], weight, groups=C)[0].permute(1, 2, 0)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p, mu_t = filt(pred), filt(target)
    var_p = filt(pred * pred) - mu_p * mu_p
    var_t = filt(target * target) - mu_t * mu_t
    cov = filt(pred * target) - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2))
    if return_full:
        return torch.mean(ssim_map), ssim_map
    return torch.mean(ssim_map)


def masked_ssim(pred, target, mask):
    """The full SSIM map averaged over a pixel mask [H, W], cropped as the
    valid filter crops the image."""
    _, full = ssim(pred, target, return_full=True)
    m = torch.as_tensor(mask, device=full.device)[5:-5, 5:-5].to(full.dtype)
    m = m[..., None].expand(full.shape)
    return torch.sum(full * m) / torch.clamp(torch.sum(m), min=1.0)
