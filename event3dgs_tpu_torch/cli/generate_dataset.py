"""Event-frame dataset generation (counterpart of
``event3dgs_tpu/cli/generate_dataset.py``; reference `generate_dataset.py`).

The reference's `generate_dataset.py` is a scratchpad of commented
`generate_images_accumu_*` invocations over recorded event streams
(`generate_dataset.py:1-11`, driving `Event_sensor/event_tools.py:66-160`);
this CLI is the working equivalent:

    # events file (any supported format) → images_event/ accumulation frames
    python -m event3dgs_tpu_torch.cli.generate_dataset \
        --events raw.dat --format dat --delta_t 1000 -o <scene>/images_event

    # image folder → simulated event stream (.dat) + frames
    python -m event3dgs_tpu_torch.cli.generate_dataset \
        --images <renders_dir> --dt 1000 -o <out_dir>

Supported stream formats: Prophesee/IEBCS `.dat`, EDS/TUM-VIE HDF5, V2E and
Volt text, CSV (`event_file_io.py:58-403`).  The streams are read and
simulated on the host; the frames are accumulated on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

from event3dgs_tpu_torch.events.buffer import EventBuffer
from event3dgs_tpu_torch.events.io import WINDOWED_READERS
from event3dgs_tpu_torch.events.simulate import (
    ACCUMULATION_LAYOUTS,
    generate_event_frames,
    simulate_event_camera,
    save_event_result,
)
from event3dgs_tpu_torch.utils.device import resolve_device
from event3dgs_tpu_torch.utils.image_io import load_image_f32


def _frames_from_stream(path, fmt, delta_t, out_dir, style, width, height,
                        layout=None, total_frames=None, device=None):
    data = WINDOWED_READERS[fmt](path, delta_t)
    w = width or data.width
    h = height or data.height
    buf = EventBuffer()
    for window in data.events:
        buf.add_array(window["t"], window["x"], window["y"], window["p"])
    return generate_event_frames(buf, w, h, delta_t, out_dir, style=style,
                                 layout=layout, total_frames=total_frames,
                                 device=device)


def _frames_from_images(images_dir, dt, delta_t, out_dir, style, device=None):
    names = sorted(
        f for f in os.listdir(images_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    if not names:
        raise SystemExit(f"no images found in {images_dir}")
    frames = [load_image_f32(os.path.join(images_dir, n)) for n in names]
    buf = simulate_event_camera(frames, dt=dt)
    dat_path = save_event_result(
        buf, out_dir, width=frames[0].shape[1], height=frames[0].shape[0]
    )
    print(f"wrote {len(buf)} events to {dat_path}")
    return generate_event_frames(
        buf, frames[0].shape[1], frames[0].shape[0], delta_t,
        os.path.join(out_dir, "images_event"), style=style, device=device,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate event-frame datasets")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--events", type=str, help="recorded event-stream file")
    src.add_argument("--images", type=str, help="rendered image folder")
    p.add_argument("--format", choices=sorted(WINDOWED_READERS), default="dat")
    p.add_argument("--delta_t", type=int, default=1000,
                   help="frame window in µs (`event_tools.py:73-83`)")
    p.add_argument("--dt", type=int, default=1000,
                   help="inter-image time in µs for simulation")
    p.add_argument("--style", choices=("accumulate", "color"),
                   default="accumulate")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--output", "-o", type=str, required=True)
    p.add_argument("--layout", choices=sorted(ACCUMULATION_LAYOUTS),
                   default=None,
                   help="dataset-specific accumulation layout "
                        "(absolute windows + the reference's filename "
                        "pattern, `event_tools.py:84-160`); default keeps "
                        "the generic stream-relative events_%%05d.png")
    p.add_argument("--total_frames", type=int, default=None,
                   help="emit exactly this many frames (layouts pad with "
                        "empty windows)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the frames are accumulated: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.events:
        frames = _frames_from_stream(
            args.events, args.format, args.delta_t, args.output,
            args.style, args.width, args.height,
            layout=args.layout, total_frames=args.total_frames,
            device=device,
        )
    else:
        frames = _frames_from_images(
            args.images, args.dt, args.delta_t, args.output, args.style,
            device=device,
        )
    print(f"wrote {len(frames)} event frames to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
