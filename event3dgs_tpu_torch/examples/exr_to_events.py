"""EXR radiance sequence → simulated DVS event stream (counterpart of
``event3dgs_tpu/examples/exr_to_events.py``).

ONE parameterized script replacing the reference's fifteen copy-paste
recipes (`example_EXR_to_events.py:82-998`: Rotate_360_high/low,
Rotate_60_high, Trans_1mps/06mps high/low, each ×{PBES, ICNS} — identical
pipelines differing only in input path, frame interval and scaling):

1. read each EXR's luminance (one channel, or spectral-weighted via
   ``calculate_intensity_from_spectral`` when ``--spectral``),
2. exposure-scale by ``--gain`` (the recipes' per-scene `C` constant),
3. run the DVS pixel model at ``--dt`` µs/frame (``--cycles`` loops the
   sequence, as the Rotate_360 recipes do for full turns),
4. write `.dat` + accumulation frames (built on the CUDA card unless
   ``--device cpu`` is given).

    python -m event3dgs_tpu_torch.examples.exr_to_events \
        --exr_dir renders_exr/ -o /tmp/rot360 --dt 2857 --gain 100 --cycles 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from event3dgs_tpu_torch.events.buffer import EventBuffer
from event3dgs_tpu_torch.events.dvs_model import DvsSimulator
from event3dgs_tpu_torch.events.exr import (
    calculate_intensity_from_spectral,
    read_exr_channel,
)
from event3dgs_tpu_torch.events.simulate import generate_event_frames
from event3dgs_tpu_torch.examples.images_to_events import (
    add_device_arg,
    add_sensor_args,
    noise_hist_from_args,
    params_from_args,
)
from event3dgs_tpu_torch.utils.device import resolve_device


def _luminance(path: str, channel: str, spectral: bool, gain: float):
    if spectral:
        img = calculate_intensity_from_spectral(path)
    else:
        img = read_exr_channel(path, channel)
    # the reference recipes clamp the exposure-scaled log input implicitly
    # through uint8 conversion; here: scale and floor at a tiny positive
    return np.maximum(np.asarray(img, np.float64) * gain, 1e-6)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--exr_dir", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--dt", type=float, default=2857.0)
    p.add_argument("--gain", type=float, default=100.0,
                   help="exposure constant C of the reference recipes")
    p.add_argument("--cycles", type=int, default=1,
                   help="sequence repeats (Rotate_360 runs multiple turns)")
    p.add_argument("--channel", type=str, default="R")
    p.add_argument("--spectral", action="store_true",
                   help="weight spectral channels into intensity")
    p.add_argument("--delta_t", type=int, default=5000)
    add_sensor_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    names = sorted(
        f for f in os.listdir(args.exr_dir) if f.lower().endswith(".exr")
    )
    if not names:
        raise SystemExit(f"no .exr files in {args.exr_dir}")

    first = _luminance(
        os.path.join(args.exr_dir, names[0]), args.channel, args.spectral,
        args.gain,
    )
    h, w = first.shape
    sim = DvsSimulator(w, h, params=params_from_args(args))
    hist = noise_hist_from_args(args)
    if hist is not None:
        sim.init_noise(*hist)
    else:
        sim.disable_noise()
    sim.init_image(first)

    full = EventBuffer(4096)
    for cycle in range(args.cycles):
        seq = names[1:] if cycle == 0 else names
        for name in seq:
            lum = _luminance(
                os.path.join(args.exr_dir, name), args.channel,
                args.spectral, args.gain,
            )
            buf = sim.update(lum, args.dt)
            full.add_array(*buf.arrays())
    full.sort()

    os.makedirs(args.output, exist_ok=True)
    dat = os.path.join(args.output, "events.dat")
    full.write_dat(dat, width=w, height=h)
    print(f"{len(full)} events -> {dat}")
    frames = generate_event_frames(
        full, w, h, args.delta_t, os.path.join(args.output, "frames"),
        device=device,
    )
    print(f"{len(frames)} accumulation frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
