"""Photometric losses and color transforms (counterpart of
``event3dgs_tpu/losses/basic.py``).

Images are [..., H, W, C] channel-last, as in the JAX package.  Formulas
match `utils/loss_utils.py` / `utils/image_utils.py`:

- grayscale: ITU-R 601 luma 0.299/0.587/0.114 (`loss_utils.py:18-23`);
- LUV-L: the X-channel weights 0.4124/0.35758/0.1804 (`loss_utils.py:24-28`)
  used by the differentiable event simulation;
- SSIM: 11×11 gaussian window, σ=1.5, C1=0.01², C2=0.03²
  (`loss_utils.py:359-418`), as a separable float32 depthwise ``conv2d``
  (TF32 is switched off around it: cuDNN would otherwise round the inputs
  to TF32 on the card).
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from event3dgs_tpu_torch.utils.device import constant

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)
_LUV_WEIGHTS = (0.4124, 0.35758, 0.1804)


def _weighted_channels(img, weights):
    if img.shape[-1] == 1:
        return img
    w = constant(weights, img.dtype, img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] → [..., H, W, 1] luma; passthrough if already 1-chan."""
    return _weighted_channels(img, _GRAY_WEIGHTS)


def rgb_to_luv_l(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] → [..., H, W, 1] CIE-X-ish channel (`rgb_to_LUVscale`)."""
    return _weighted_channels(img, _LUV_WEIGHTS)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Peak SNR in dB for images in [0, 1] (`image_utils.py:19-21`)."""
    return -10.0 * torch.log10(torch.mean((a - b) ** 2) + 1e-12)


def l1_loss_gray(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L1 between grayscale conversions (`loss_utils.py:40-48`)."""
    return l1_loss(rgb_to_grayscale(a), rgb_to_grayscale(b))


@contextlib.contextmanager
def fp32_convolutions():
    """Run ``F.conv2d`` in full float32: cuDNN on the card otherwise rounds
    its inputs to TF32 (the JAX package convolves in float32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@lru_cache(maxsize=8)
def _gauss_window_1d(size: int, sigma: float) -> tuple:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _depthwise_blur(img: torch.Tensor, window_size: int, sigma: float):
    """Separable gaussian blur on [H, W, C] with zero ("same") padding."""
    c = img.shape[-1]
    g = constant(_gauss_window_1d(window_size, sigma), torch.float32,
                 img.device)
    pad = window_size // 2
    x = img.permute(2, 0, 1)[None]  # [1, C, H, W]
    kh = g.reshape(1, 1, window_size, 1).expand(c, 1, window_size, 1)
    kw = g.reshape(1, 1, 1, window_size).expand(c, 1, 1, window_size)
    with fp32_convolutions():
        x = F.conv2d(x, kh, padding=(pad, 0), groups=c)
        x = F.conv2d(x, kw, padding=(0, pad), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [H, W, C] images (`loss_utils.py:388-418`)."""
    blur = lambda x: _depthwise_blur(x, window_size, sigma)
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def ssim_gray(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    """SSIM on grayscale conversions (`loss_utils.py:368-385`)."""
    return ssim(rgb_to_grayscale(img1), rgb_to_grayscale(img2), window_size)


def rgb_to_qe_scale(img: torch.Tensor) -> torch.Tensor:
    """Quantum-efficiency-weighted gray conversion (reference
    `rgb_to_QEscale`, `loss_utils.py:29-33`): XYZ-X-row weights
    0.4124/0.35758/0.1804, channel-last in, [..., H, W, 1] out (a
    one-channel input is weighted by all three, as the JAX package's
    broadcast does)."""
    w = constant(_LUV_WEIGHTS, img.dtype, img.device)
    return (img * w).sum(dim=-1, keepdim=True)
