"""Colorimetry: sRGB → luminance for physically-based simulator input.

Counterpart of ``event3dgs_tpu/utils/colorimetry.py`` in torch, and of the
reference's `sgrb2lum` C++/OpenCV extension
(`Event_sensor/utils/display.cpp`, `SGRB2Luminance`): converts sRGB frames
to photometric luminance for the DVS model.  The reference routes through
31-band spectral tables; photometrically the composition collapses to
linearized sRGB → CIE Y (the spectral round trip is the identity on the
luminance axis), so this implements the direct form.  The functions run on
the device of their input; a numpy array becomes a CPU tensor.
"""

from __future__ import annotations

import torch

# Rec.709/sRGB primaries → CIE Y row of the RGB→XYZ matrix
_Y_WEIGHTS = (0.2126729, 0.7151522, 0.0721750)


def srgb_to_linear(c) -> torch.Tensor:
    """Inverse sRGB EOTF (IEC 61966-2-1)."""
    c = torch.clamp(torch.as_tensor(c), 0.0, 1.0)
    return torch.where(
        c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    )


def linear_to_srgb(c) -> torch.Tensor:
    c = torch.clamp(torch.as_tensor(c), 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055
    )


def srgb_to_luminance(img, max_nits: float = 255.0) -> torch.Tensor:
    """[..., H, W, 3] sRGB in [0,1] → photometric luminance in (0, max_nits].

    Drop-in for `sgrb2lum.SGRB2Luminance` as used by the simulator input
    path (`Event_sensor/utils/test.py:15`).
    """
    lin = srgb_to_linear(img)
    w = torch.tensor(_Y_WEIGHTS, dtype=lin.dtype, device=lin.device)
    y = torch.sum(lin * w, dim=-1)
    return torch.clamp(y * max_nits, min=1e-3)
