"""Event-camera losses: the differentiable event simulation (counterpart of
``event3dgs_tpu/losses/event.py:22-104``).

Two consecutively rendered views are turned into a normalized
log-intensity difference (the event frame a DVS camera with contrast
threshold C would integrate to) and compared against the same quantity
computed from event-derived ground-truth intensity pairs.  The contrast of
the rendered pair is a learnable scalar optimized jointly (reference
`train.py:71-72,165-196`; loss formula `utils/loss_utils.py:234-249`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from event3dgs_tpu_torch.losses.basic import l1_loss, rgb_to_luv_l

LOG_EPS = 1e-8  # epsilon inside the logs (`loss_utils.py:243`)


def effective_contrast(raw, parameterization: str = "identity"):
    """Map the optimized scalar to the contrast used by the loss:
    "identity" is the reference's unconstrained c; "softplus" is the opt-in
    positivity guard c = softplus(raw) + 1e-4."""
    if parameterization == "softplus":
        return F.softplus(raw) + 1e-4
    if parameterization != "identity":
        raise ValueError(f"unknown contrast parameterization "
                         f"{parameterization!r}")
    return raw


def raw_contrast_init(c_init: float, parameterization: str = "identity"):
    """Host-side inverse of :func:`effective_contrast` for state init.

    Under "softplus" the contrast is above its 1e-4 floor, so a ``c_init``
    at or below it has no inverse and raises ``ValueError``.
    """
    if parameterization == "softplus":
        if not c_init > 1e-4:
            raise ValueError(f"softplus contrast init must exceed its 1e-4 "
                             f"floor, got {c_init}")
        return float(np.log(np.expm1(c_init - 1e-4)))
    return c_init


def event_log_diff(image, image_next, contrast) -> torch.Tensor:
    """``(log(L(I₂)+ε) − log(L(I₁)+ε)) / C`` on the LUV L-channel
    (`loss_utils.py:234-249`): [..., H, W, 3] frames → [..., H, W, 1]."""
    l1 = rgb_to_luv_l(image)
    l2 = rgb_to_luv_l(image_next)
    return (torch.log(l2 + LOG_EPS) - torch.log(l1 + LOG_EPS)) / contrast


def event_mixture_loss(render_now, render_next, render_main, gt_now, gt_next,
                       gt_main, contrast, gt_contrast: float = 0.17,
                       event_weight: float = 0.9):
    """The event-mode training loss (reference `train.py:165-196`).

    ``loss1``: L1 between the rendered pair's log-diff (learnable C) and the
    GT pair's log-diff (fixed C); ``loss2``: L1 between the main render and
    its GT.  With coverage = mean(gt_diff ≠ 0):

        loss = w·loss1·coverage + (1-w)·loss2·(1-coverage)

    Returns (loss, aux dict with event_l1 / intensity_l1 / coverage).
    """
    img_diff = event_log_diff(render_now, render_next, contrast)
    gt_diff = event_log_diff(gt_now, gt_next, gt_contrast)
    loss1 = l1_loss(img_diff, gt_diff)
    loss2 = l1_loss(render_main, gt_main)
    coverage = torch.mean((gt_diff != 0.0).to(img_diff.dtype))
    loss = event_weight * loss1 * coverage + (1.0 - event_weight) * loss2 * (
        1.0 - coverage)
    return loss, {"event_l1": loss1, "intensity_l1": loss2,
                  "coverage": coverage}
