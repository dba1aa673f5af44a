"""Image folder → simulated DVS event stream (counterpart of
``event3dgs_tpu/examples/images_to_events.py``).

Parameterized port of `example_images_to_events.py` (reference
`Event_sensor/src/example_images_to_events.py:1-77`): loads a sorted image
folder, feeds luminance frames through the DVS pixel model at ``--dt`` µs
per frame, and writes the merged stream as `.dat` plus accumulation frames
(accumulated on the CUDA card unless ``--device cpu`` is given).

    python -m event3dgs_tpu_torch.examples.images_to_events \
        --images <renders_dir> -o /tmp/events_out --dt 200
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from event3dgs_tpu_torch.events.dvs_model import DvsParams
from event3dgs_tpu_torch.events.simulate import (
    generate_event_frames,
    save_event_result,
    simulate_event_camera,
)
from event3dgs_tpu_torch.utils.device import resolve_device
from event3dgs_tpu_torch.utils.image_io import load_image_f32


def add_sensor_args(p: argparse.ArgumentParser):
    # reference defaults: example_images_to_events.py:18-24
    p.add_argument("--latency", type=float, default=100.0)
    p.add_argument("--jitter", type=float, default=10.0)
    p.add_argument("--refractory", type=float, default=100.0)
    p.add_argument("--tau", type=float, default=300.0)
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--th_noise", type=float, default=0.01)
    p.add_argument("--noise_hist", type=str, default=None,
                   help=".npy measured-noise CDF histogram (pos=neg, as the "
                        "reference's init_bgn_hist_cpp call)")


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="where the accumulation frames are built: cuda "
                        "(default) or cpu")


def params_from_args(args) -> DvsParams:
    return DvsParams(
        th_pos=args.threshold, th_neg=args.threshold,
        th_noise=args.th_noise, latency=args.latency, jitter=args.jitter,
        refractory=args.refractory, tau=args.tau,
    )


def noise_hist_from_args(args):
    if not args.noise_hist:
        return None
    hist = np.load(args.noise_hist)
    return hist, hist  # reference passes the same file for pos and neg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--dt", type=float, default=200.0,
                   help="µs between frames (reference default 200)")
    p.add_argument("--delta_t", type=int, default=1000,
                   help="accumulation-frame window in µs")
    p.add_argument("--max_images", type=int, default=0)
    add_sensor_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    names = sorted(
        f for f in os.listdir(args.images)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    if args.max_images:
        names = names[: args.max_images]
    if not names:
        raise SystemExit(f"no images in {args.images}")
    frames = [load_image_f32(os.path.join(args.images, n)) for n in names]

    buf = simulate_event_camera(
        frames, dt=args.dt, params=params_from_args(args),
        noise_hist=noise_hist_from_args(args),
    )
    h, w = frames[0].shape[:2]
    dat = save_event_result(buf, args.output, width=w, height=h)
    print(f"{len(buf)} events -> {dat}")
    frames = generate_event_frames(
        buf, w, h, args.delta_t, os.path.join(args.output, "frames"),
        device=device,
    )
    print(f"{len(frames)} accumulation frames -> {args.output}/frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
