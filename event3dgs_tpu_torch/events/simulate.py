"""High-level event synthesis: frame sequences → event streams → datasets.

The port's copy of ``event3dgs_tpu/events/simulate.py``: the simulator
input and the stream stay numpy on the host, as there; the frames of
:func:`generate_event_frames` are built with the port's torch
``accumulate`` on the device the caller names.

Equivalent of the reference's `Event_sensor/event_tools.py:33-160`: feed a
rendered image sequence through the DVS simulator, save the stream as
`.dat`, and regenerate per-window event frames for the `images_event/`
training folder.
"""

from __future__ import annotations

import os

import numpy as np

from event3dgs_tpu_torch.events.accumulate import (
    accumulation_frame,
    color_polarity_frame,
)
from event3dgs_tpu_torch.events.buffer import EventBuffer
from event3dgs_tpu_torch.events.dvs_model import DvsParams, DvsSimulator
from event3dgs_tpu_torch.events.io import window_events
from event3dgs_tpu_torch.utils.device import resolve_device
from event3dgs_tpu_torch.utils.image_io import save_image


def rgb_to_luminance(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float [0,1] → L-channel-style luminance in (0, 255].

    The reference converts frames to LUV and feeds the L channel
    (`event_tools.py:44-50`); we use the same CIE-X-weighted combination as
    the training loss (`loss_utils.py:24-28`) scaled to [0, 255].
    """
    lum = (
        0.4124 * img[..., 0] + 0.35758 * img[..., 1] + 0.1804 * img[..., 2]
    ) * 255.0
    return np.maximum(lum, 1e-3)  # log() needs positive input


def simulate_event_camera(
    frames,
    dt: float = 1000.0,
    params: DvsParams | None = None,
    seed: int = 0,
    noise_hist: tuple | None = None,
) -> EventBuffer:
    """Frame sequence → merged event stream (`simulate_event_camera`,
    `event_tools.py:33-59`).

    Args:
        frames: iterable of [H, W, 3] float images in [0, 1].
        dt: inter-frame interval in µs.
        params: sensor parameters (defaults = reference pipeline values).
        noise_hist: optional (hist_pos, hist_neg) CDF arrays enabling the
            measured background-noise model.
    """
    frames = list(frames)
    if not frames:
        return EventBuffer(1)
    h, w = frames[0].shape[:2]
    sim = DvsSimulator(w, h, params=params, seed=seed)
    if noise_hist is not None:
        sim.init_noise(*noise_hist)
    else:
        sim.disable_noise()
    sim.init_image(rgb_to_luminance(np.asarray(frames[0])))
    full = EventBuffer(4096)
    for frame in frames[1:]:
        buf = sim.update(rgb_to_luminance(np.asarray(frame)), dt)
        full.add_array(*buf.arrays())
    full.sort()
    return full


def save_event_result(buf: EventBuffer, out_dir: str, width=0, height=0) -> str:
    """Write `raw.dat` (`save_event_result`, `event_tools.py:61-64`)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "raw.dat")
    buf.write_dat(path, width=width, height=height)
    return path


# Dataset-specific accumulation-frame layouts, mirroring the reference's
# copy-paste `generate_images_accumu_{volt,eds,edslike,T,Tumvie}` family
# (`Event_sensor/event_tools.py:84-160`) as data: each layout pins the
# per-frame accumulation window as a fraction of delta_t, the output
# subdirectory, and the filename pattern (including the reference's index
# offsets and double-extension quirks, preserved for drop-in parity with
# downstream tooling that globs these names).
#   window_frac: frame i accumulates events in [i·dt, (i+window_frac)·dt)
#   subdir: None = write into out_dir itself; "+suffix" appends to its name
ACCUMULATION_LAYOUTS = {
    # generate_images_accumu (IEBCS .dat, `event_tools.py:73-83`)
    "default": dict(window_frac=1.0, subdir=None,
                    name=lambda i: f"{i + 2:05d}.png"),
    # generate_images_accumu_volt (`event_tools.py:84-94`)
    "volt": dict(window_frac=1.0, subdir="+_ac",
                 name=lambda i: f"{i + 3:05d}.png"),
    # generate_images_accumu_edslike (`event_tools.py:95-108`)
    "edslike": dict(window_frac=0.1, subdir="images_simu",
                    name=lambda i: f"frame_{i * 10:010d}.png"),
    # generate_images_accumu_eds (`event_tools.py:109-122`)
    "eds": dict(window_frac=0.1, subdir="images_ac",
                name=lambda i: f"frame_{i * 10:010d}.png"),
    # generate_images_accumu_T (`event_tools.py:134-147`; the reference
    # formats '{:04d}.{}'.format(idx, "png.png") → "0000.png.png")
    "T": dict(window_frac=0.1, subdir="images_ac",
              name=lambda i: f"{i:04d}.png.png"),
    # generate_images_accumu_Tumvie (`event_tools.py:148-160`;
    # '{:05d}.{}'.format(idx, ".png") → "00000..png")
    "tumvie": dict(window_frac=0.1, subdir="images_ac",
                   name=lambda i: f"{i:05d}..png"),
}


def generate_event_frames(
    buf: EventBuffer,
    width: int,
    height: int,
    delta_t: int,
    out_dir: str | None = None,
    style: str = "accumulate",
    layout: str | None = None,
    total_frames: int | None = None,
    device=None,
):
    """Window the stream and build frames (`generate_images*`,
    `event_tools.py:66-160`).

    Args:
        style: "accumulate" (±10/255 around mid-gray) or "color"
            (positive→R / negative→B, decodable by `decode_event_frame`).
        layout: optional key into :data:`ACCUMULATION_LAYOUTS` reproducing
            the reference's dataset-specific accumulation variants
            (window fraction + directory + filename pattern); None keeps
            the generic full-window ``events_%05d.png`` naming.
        total_frames: number of frames to emit (defaults to the number of
            full windows in the stream).
        device: where the frames are accumulated (``None``: ``cuda``; the
            windows are cut on the host, as in the JAX package).

    Returns:
        list of [H, W] or [H, W, 3] numpy frames (also saved as PNGs when
        ``out_dir`` is given).
    """
    ts, xs, ys, ps = buf.arrays()
    spec = ACCUMULATION_LAYOUTS[layout] if layout else None
    frac = spec["window_frac"] if spec else 1.0

    if out_dir and spec:
        sub = spec["subdir"]
        if sub is None:
            dest = out_dir
        elif sub.startswith("+"):
            dest = out_dir.rstrip("/\\") + sub[1:]
        else:
            dest = os.path.join(out_dir, sub)
    else:
        dest = out_dir

    if spec is None:
        # generic path: stream-relative buckets (the reference's
        # `display_events` viewer semantics — first bucket starts at the
        # first event's timestamp)
        data = window_events(ts, xs, ys, ps, delta_t)
        windows = [(w["x"], w["y"], w["p"]) for w in data.events]
        if total_frames is not None:
            windows = windows[:total_frames]
    else:
        # every dataset layout uses ABSOLUTE windows [i·dt, (i+frac)·dt)
        # and emits exactly total_frames frames (empty ones included), as
        # the reference's absolute-indexed fixed-count output does
        if total_frames is not None:
            n = total_frames
        elif len(ts):
            n = max(int(ts[-1] // delta_t), 0)
        else:
            n = 0
        windows = []
        for i in range(n):
            lo, hi = i * delta_t, (i + frac) * delta_t
            m = (ts >= lo) & (ts < hi)
            windows.append((xs[m], ys[m], ps[m]))

    device = resolve_device(device)
    build = color_polarity_frame if style == "color" else accumulation_frame
    frames = []
    for i, (wx, wy, wp) in enumerate(windows):
        img = build(wx, wy, wp, width, height, device=device).cpu().numpy()
        frames.append(img)
        if dest:
            os.makedirs(dest, exist_ok=True)
            name = spec["name"](i) if spec else f"events_{i:05d}.png"
            save_image(os.path.join(dest, name), img)
    return frames
