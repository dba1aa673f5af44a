"""The plain reference of the port's training losses, differentiated by
autograd (frozen from the formulas that ``event3dgs_tpu_torch/losses``
documents at commit 3dea7a3, the reference's ``train.py`` and
``utils/loss_utils.py``):

- event mode: with L the X channel (0.4124, 0.35758, 0.1804), the rendered
  pair's log-difference (log(L(next) + 1e-8) − log(L(now) + 1e-8)) / c
  against the GT pair's at the fixed 0.17, L1 as ``loss1``; the main
  view's L1 as ``loss2``; coverage the share of GT log-differences that are
  not 0; loss = 0.9·loss1·coverage + 0.1·loss2·(1 − coverage);
- rgb mode: 0.8·L1 + 0.2·(1 − SSIM), SSIM over an 11-tap Gaussian window of
  σ 1.5 with zero padding, C1 = 0.01², C2 = 0.03²,

each render composed over the background as rgb + exp(log T)·bg.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LUV = (0.4124, 0.35758, 0.1804)
LOG_EPS = 1e-8
WINDOW, SIGMA = 11, 1.5
C1, C2 = 0.01 ** 2, 0.03 ** 2


def luv_l(img):
    return (img * img.new_tensor(LUV)).sum(-1, keepdim=True)


def log_diff(now, nxt, contrast):
    return (torch.log(luv_l(nxt) + LOG_EPS) - torch.log(luv_l(now) + LOG_EPS)) / contrast


def event_loss(now, nxt, main, gt_now, gt_next, gt_main, contrast,
               gt_contrast=0.17, event_weight=0.9, half=False):
    """(loss, aux) of event mode.  ``half`` keeps the pixels of the left
    half only, means over them (a fault the tests plant)."""
    if half:
        w = now.shape[1] // 2
        now, nxt, main, gt_now, gt_next, gt_main = (
            x[:, :w] for x in (now, nxt, main, gt_now, gt_next, gt_main))
    img_diff = log_diff(now, nxt, contrast)
    gt_diff = log_diff(gt_now, gt_next, gt_contrast)
    loss1 = torch.mean(torch.abs(img_diff - gt_diff))
    loss2 = torch.mean(torch.abs(main - gt_main))
    coverage = torch.mean((gt_diff != 0.0).to(img_diff.dtype))
    loss = event_weight * loss1 * coverage + (1 - event_weight) * loss2 * (1 - coverage)
    return loss, {"event_l1": loss1, "intensity_l1": loss2, "coverage": coverage}


def _blur(x):
    """Separable Gaussian blur of [H, W, C] with zero padding."""
    g = np.exp(-(np.arange(WINDOW) - WINDOW // 2) ** 2 / (2 * SIGMA ** 2))
    g = torch.as_tensor(g / g.sum(), dtype=x.dtype, device=x.device)
    c = x.shape[-1]
    y = x.permute(2, 0, 1)[None]
    y = F.conv2d(y, g.reshape(1, 1, WINDOW, 1).expand(c, 1, WINDOW, 1),
                 padding=(WINDOW // 2, 0), groups=c)
    y = F.conv2d(y, g.reshape(1, 1, 1, WINDOW).expand(c, 1, 1, WINDOW),
                 padding=(0, WINDOW // 2), groups=c)
    return y[0].permute(1, 2, 0)


def rgb_loss(x, y, lambda_dssim=0.2, half=False):
    """(loss, aux) of rgb mode."""
    if half:
        w = x.shape[1] // 2
        x, y = x[:, :w], y[:, :w]
    l1 = torch.mean(torch.abs(x - y))
    mx, my = _blur(x), _blur(y)
    sxx = _blur(x * x) - mx * mx
    syy = _blur(y * y) - my * my
    sxy = _blur(x * y) - mx * my
    m = ((2 * mx * my + C1) * (2 * sxy + C2)) / ((mx * mx + my * my + C1) * (sxx + syy + C2))
    loss = (1 - lambda_dssim) * l1 + lambda_dssim * (1 - torch.mean(m))
    return loss, {"l1": l1}
