"""Video file → simulated DVS event stream (+ event display frames)
(counterpart of ``event3dgs_tpu/examples/video_to_events.py``).

Parameterized port of `example_video_to_events.py` (reference
`Event_sensor/src/example_video_to_events.py:1-65`): decodes frames with
OpenCV, converts to luminance, runs the DVS pixel model at the declared
``--dt`` (the video container framerate is NOT trusted, exactly as the
reference warns), writes the stream to `.dat` named with the sensor
parameters, and the event-display frames as PNGs under `frames/`.

    python -m event3dgs_tpu_torch.examples.video_to_events \
        --video input.mkv -o /tmp/ev_out --dt 2857
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from event3dgs_tpu_torch.events.display import EventDisplay
from event3dgs_tpu_torch.events.dvs_model import DvsSimulator
from event3dgs_tpu_torch.events.simulate import rgb_to_luminance
from event3dgs_tpu_torch.events.buffer import EventBuffer
from event3dgs_tpu_torch.examples.images_to_events import (
    add_sensor_args,
    noise_hist_from_args,
    params_from_args,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--dt", type=float, default=2857.0,
                   help="µs between frames (reference default 2857)")
    p.add_argument("--max_time", type=float, default=0.1e9,
                   help="stop after this many µs (reference cap)")
    add_sensor_args(p)
    args = p.parse_args(argv)

    import cv2

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open {args.video}")
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    os.makedirs(args.output, exist_ok=True)

    prm = params_from_args(args)
    sim = DvsSimulator(w, h, params=prm)
    hist = noise_hist_from_args(args)
    if hist is not None:
        sim.init_noise(*hist)
    else:
        sim.disable_noise()

    display = EventDisplay(w, h, frametime=args.dt * 2,
                           out_dir=os.path.join(args.output, "frames"))
    full = EventBuffer(4096)
    is_init = False
    time = 0.0
    while True:
        ok, im = cap.read()
        if not ok or im is None:
            break
        lum = rgb_to_luminance(im[:, :, ::-1].astype(np.float32) / 255.0)
        if not is_init:
            sim.init_image(lum)
            is_init = True
            continue
        buf = sim.update(lum, args.dt)
        t, x, y, pol = buf.arrays()
        display.update(t, x, y, pol)
        full.add_array(t, x, y, pol)
        time += args.dt
        if time > args.max_time:
            break
    cap.release()
    full.sort()

    tag = "{}_{}_{}_{}_{}_{}".format(
        prm.latency, prm.jitter, prm.refractory, prm.tau, prm.th_pos,
        prm.th_noise,
    )
    dat = os.path.join(args.output, f"ev_{tag}.dat")
    full.write_dat(dat, width=w, height=h)
    print(f"{len(full)} events -> {dat}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
