"""Loss library: L1/SSIM (+gray), the event simulation loss, mode losses."""

from event3dgs_tpu_torch.losses.basic import (
    l1_loss,
    l1_loss_gray,
    psnr,
    rgb_to_grayscale,
    rgb_to_luv_l,
    ssim,
    ssim_gray,
)
from event3dgs_tpu_torch.losses.event import (
    effective_contrast,
    event_log_diff,
    event_mixture_loss,
    raw_contrast_init,
)
from event3dgs_tpu_torch.losses.modes import (
    deblur_mix,
    event_total_loss,
    gray_total_loss,
    rgb_total_loss,
)

__all__ = [
    "l1_loss",
    "l1_loss_gray",
    "psnr",
    "rgb_to_grayscale",
    "rgb_to_luv_l",
    "ssim",
    "ssim_gray",
    "effective_contrast",
    "event_log_diff",
    "event_mixture_loss",
    "raw_contrast_init",
    "deblur_mix",
    "event_total_loss",
    "gray_total_loss",
    "rgb_total_loss",
]
