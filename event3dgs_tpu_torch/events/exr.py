"""OpenEXR channel reading for HDR simulator input.

The port's copy of ``event3dgs_tpu/events/exr.py`` (numpy, as there).

Equivalent of the reference's `Event_sensor/src/ExrRead.py:10,42`
(`read_exr_channel`, `calculate_intensity_from_spetral`).  The OpenEXR
bindings are not part of this environment's baked dependencies, so the
reader is import-gated with an informative error.
"""

from __future__ import annotations

import numpy as np


def read_exr_channel(path: str, channel: str = "R") -> np.ndarray:
    """Read one float channel of an EXR file as [H, W] float32."""
    try:
        import Imath
        import OpenEXR
    except ImportError as e:
        raise ImportError(
            "read_exr_channel requires the OpenEXR python bindings, which "
            "are not installed in this environment"
        ) from e
    f = OpenEXR.InputFile(path)
    dw = f.header()["dataWindow"]
    w = dw.max.x - dw.min.x + 1
    h = dw.max.y - dw.min.y + 1
    pt = Imath.PixelType(Imath.PixelType.FLOAT)
    raw = f.channel(channel, pt)
    return np.frombuffer(raw, np.float32).reshape(h, w)


def calculate_intensity_from_spectral(
    path: str, channels: list[str] | None = None, weights=None
) -> np.ndarray:
    """Weighted sum of spectral EXR channels → intensity image."""
    channels = channels or ["R", "G", "B"]
    imgs = [read_exr_channel(path, c) for c in channels]
    if weights is None:
        weights = np.full(len(imgs), 1.0 / len(imgs))
    return np.tensordot(np.asarray(weights), np.stack(imgs), axes=1)
