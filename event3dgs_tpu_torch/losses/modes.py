"""Per-training-mode total losses (counterpart of
``event3dgs_tpu/losses/modes.py``): vanilla RGB, grayscale, event (with
the learnable contrast) and the event-assisted deblur mix
(`train.py:149-296`).  All take channel-last images."""

from __future__ import annotations

from event3dgs_tpu_torch.losses.basic import l1_loss, l1_loss_gray, ssim, ssim_gray
from event3dgs_tpu_torch.losses.event import event_mixture_loss


def rgb_total_loss(render, gt, lambda_dssim: float = 0.2):
    """Vanilla 3DGS loss: (1-λ)·L1 + λ·(1-SSIM) (`train.py:292-296`)."""
    ll1 = l1_loss(render, gt)
    loss = (1.0 - lambda_dssim) * ll1
    if lambda_dssim > 0.0:
        loss = loss + lambda_dssim * (1.0 - ssim(render, gt))
    return loss, {"l1": ll1}


def gray_total_loss(render, gt, lambda_dssim: float = 0.2):
    """Gray mode: (1-λ)·L1_gray + λ·(1-SSIM_gray) (`train.py:213-223`)."""
    ll1 = l1_loss_gray(render, gt)
    loss = (1.0 - lambda_dssim) * ll1
    if lambda_dssim > 0.0:
        loss = loss + lambda_dssim * (1.0 - ssim_gray(render, gt))
    return loss, {"l1": ll1}


def event_total_loss(render_now, render_next, render_main, gt_now, gt_next,
                     gt_main, contrast, gt_contrast: float = 0.17,
                     event_weight: float = 0.9):
    """Event mode (`train.py:149-196`; λ_dssim is forced to 0 there)."""
    return event_mixture_loss(render_now, render_next, render_main, gt_now,
                              gt_next, gt_main, contrast,
                              gt_contrast=gt_contrast,
                              event_weight=event_weight)


def deblur_mix(loss, render_main, gt_blurry, blur_alpha: float = 0.5):
    """Deblur mode: ``(1-α)·loss + α·L1(render, blurry)``
    (`train.py:197-203`)."""
    ll1 = l1_loss(render_main, gt_blurry)
    return (1.0 - blur_alpha) * loss + blur_alpha * ll1, {"blur_l1": ll1}
