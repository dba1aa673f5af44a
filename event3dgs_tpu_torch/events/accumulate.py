"""Event-frame accumulation: event streams → images, in torch on a device.

Counterpart of ``event3dgs_tpu/events/accumulate.py`` (jnp scatters there),
and of the reference's frame functions (`event_tools.py:66-160`,
`event_file_io.py:438-573`): per-window polarity frames, ±10/255-per-event
accumulation frames around mid-gray, signed count images, and the R/B color
encoding whose decode is `Normalize_event_frame` (`loss_utils.py:252-268`).

Inputs may be numpy arrays or tensors; results are float32 tensors on
``device`` (``None``: ``cuda``, as the port's entry points).  The JAX
package's semantics are kept exactly:

- the pixel of an event is the flat index ``y*width + x`` in int32, and an
  event is dropped only when that index lies outside ``[0, H·W)`` (an
  ``x ≥ width`` lands in a later row, as ``.at[].add(mode="drop")`` does);
  dropped events go to a spare slot past the image, so no host sync;
- counts are sums of ±1.0 in float32, exact below 2^24 events per pixel,
  so the order of the device's atomic adds does not change them;
- :func:`polarity_frame` keeps each pixel's LAST event, as the scatter-set
  over repeated indices does on XLA's CPU: the largest event index per pixel
  (``scatter_reduce_(..., "amax")``, independent of write order), then its
  polarity.
"""

from __future__ import annotations

import numpy as np
import torch

from event3dgs_tpu_torch.utils.device import resolve_device

ACCUM_STEP = 10.0 / 255.0  # per-event brightness step (`display_events_accumu`)


def _on(a, device, np_dtype) -> torch.Tensor:
    """``a`` as a tensor on ``device``: a tensor is moved, anything else is
    first made a numpy array of ``np_dtype``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np_dtype))
    return a.to(device)


def _pixels(x, y, width: int, height: int, device):
    """Each event's flat pixel index, or ``H·W`` (the spare slot) where the
    int32 index ``y*width + x`` falls outside the image."""
    x = _on(x, device, np.int32).to(torch.int32)
    y = _on(y, device, np.int32).to(torch.int32)
    n_pix = height * width
    flat = y * width + x
    flat = torch.where((flat >= 0) & (flat < n_pix), flat, n_pix)
    return flat.to(torch.int64), n_pix


def _positive(p, device) -> torch.Tensor:
    if not isinstance(p, torch.Tensor):
        return _on(np.asarray(p) > 0, device, bool)
    return p.to(device) > 0


def event_count_image(x, y, p, width: int, height: int,
                      device=None) -> torch.Tensor:
    """Signed per-pixel event counts: [H, W], +1 per positive event."""
    device = resolve_device(device)
    flat, n_pix = _pixels(x, y, width, height, device)
    sign = torch.where(_positive(p, device), 1.0, -1.0)
    counts = torch.zeros(n_pix + 1, dtype=torch.float32, device=device)
    counts.index_add_(0, flat, sign)
    return counts[:n_pix].reshape(height, width)


def accumulation_frame(x, y, p, width: int, height: int,
                       device=None) -> torch.Tensor:
    """Mid-gray frame with ±ACCUM_STEP per event, clipped to [0, 1]."""
    counts = event_count_image(x, y, p, width, height, device)
    return torch.clamp(0.5 + counts * ACCUM_STEP, 0.0, 1.0)


def polarity_frame(x, y, p, width: int, height: int,
                   device=None) -> torch.Tensor:
    """Last-polarity-wins display frame: gray bg, white pos, black neg."""
    device = resolve_device(device)
    flat, n_pix = _pixels(x, y, width, height, device)
    val = torch.where(_positive(p, device), 1.0, 0.0)
    last = torch.full((n_pix + 1,), -1, dtype=torch.int64, device=device)
    last.scatter_reduce_(0, flat, torch.arange(len(flat), device=device),
                         "amax")
    last = last[:n_pix]
    if not len(val):
        return torch.full((height, width), 0.5, device=device)
    frame = torch.where(last >= 0, val[last.clamp(min=0)], 0.5)
    return frame.reshape(height, width)


def color_polarity_frame(x, y, p, width: int, height: int,
                         device=None) -> torch.Tensor:
    """[H, W, 3] with positive counts in R and negative in B (the encoding
    `Normalize_event_frame` decodes as ``(R − B)/(10/255)``)."""
    counts = event_count_image(x, y, p, width, height, device)
    r = torch.clamp(0.5 + torch.clamp(counts, min=0.0) * ACCUM_STEP, 0.0, 1.0)
    b = torch.clamp(0.5 + torch.clamp(-counts, min=0.0) * ACCUM_STEP, 0.0, 1.0)
    g = torch.full_like(r, 0.5)
    return torch.stack([r, g, b], dim=-1)


def decode_event_frame(img, device=None) -> torch.Tensor:
    """Inverse of :func:`color_polarity_frame` (`Normalize_event_frame`)."""
    device = resolve_device(device)
    img = _on(img, device, np.float32).to(torch.float32)
    step = torch.tensor(ACCUM_STEP, dtype=torch.float32, device=device)
    return (img[..., 0] - img[..., 2]) / step
