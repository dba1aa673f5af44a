"""Compare two event streams: metrics, sweeps, frames, and the figure
(counterpart of ``event3dgs_tpu/examples/compare_streams.py``).

Headless port of the reference comparison scripts
(`example_EXR_to_events.py:1016-1298` Compare_Real_and_{PBES,V2E},
Compare_Real_and_PBES_{biast,noise}) and the hardcoded plot in
`metric_figure.py` — except the sweep numbers are COMPUTED from the two
streams instead of pasted in:

- chamfer / gaussian / spike-cube RKHS distances on matching windows,
- a time-bias sweep (stream B shifted by T_bias µs per point),
- a noise sweep (uniform random events injected into B),
- side-by-side count frames + 3D event clouds saved to the output dir,
- `metric_figure.png` with both sweeps on log-x axes.

    python -m event3dgs_tpu_torch.examples.compare_streams \
        --real real.dat --sim sim.dat -o /tmp/cmp --delta_t 100000
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

from event3dgs_tpu_torch.events.display import display_events_frame, event_cloud_3d
from event3dgs_tpu_torch.events.io import WINDOWED_READERS
from event3dgs_tpu_torch.events.metrics import (
    chamfer_distance,
    gaussian_distance,
    spike_cube_distance,
)

BIAS_SWEEP = (0, 10, 100, 1_000, 10_000, 100_000)  # µs (metric_figure.py)
NOISE_SWEEP = (0, 10, 100, 1_000, 10_000, 100_000)  # injected events


def _as_tuple(win):
    return (
        np.asarray(win["t"], np.int64), np.asarray(win["x"], np.int64),
        np.asarray(win["y"], np.int64), np.asarray(win["p"], np.int64),
    )


def _shift(ev, bias):
    t, x, y, p = ev
    return (t + int(bias), x, y, p)


def _inject_noise(ev, n, width, height, t_span, rng):
    if n == 0:
        return ev
    t, x, y, p = ev
    t0 = int(t[0]) if len(t) else 0
    tn = rng.integers(t0, t0 + max(t_span, 1), n)
    xn = rng.integers(0, width, n)
    yn = rng.integers(0, height, n)
    pn = rng.integers(0, 2, n)
    order = np.argsort(np.concatenate([t, tn]), kind="stable")
    cat = lambda a, b: np.concatenate([a, b])[order]
    return (cat(t, tn), cat(x, xn), cat(y, yn), cat(p, pn))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real", required=True)
    p.add_argument("--sim", required=True)
    p.add_argument("--real_format", default="dat",
                   choices=sorted(WINDOWED_READERS))
    p.add_argument("--sim_format", default="iebcs",
                   choices=sorted(WINDOWED_READERS))
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--delta_t", type=int, default=100_000)
    p.add_argument("--window", type=int, default=0,
                   help="which delta_t window to score")
    p.add_argument("--max_events", type=int, default=50_000,
                   help="subsample cap per stream (KD-tree cost)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    real = WINDOWED_READERS[args.real_format](args.real, args.delta_t)
    sim = WINDOWED_READERS[args.sim_format](args.sim, args.delta_t)
    width = max(real.width, sim.width)
    height = max(real.height, sim.height)
    wr = real.events[args.window]
    ws = sim.events[args.window]
    rng = np.random.default_rng(args.seed)

    def sub(ev):
        t, x, y, p = ev
        if len(t) > args.max_events:
            sel = np.sort(rng.choice(len(t), args.max_events, replace=False))
            return (t[sel], x[sel], y[sel], p[sel])
        return ev

    ev_r, ev_s = sub(_as_tuple(wr)), sub(_as_tuple(ws))
    t_span = max(
        int(max(ev_r[0][-1], ev_s[0][-1]))
        - int(min(ev_r[0][0], ev_s[0][0])), 1,
    )

    # headline metrics on the chosen window
    result = {
        "chamfer": chamfer_distance(ev_r, ev_s, width, height),
        "gaussian": gaussian_distance(ev_r, ev_s, width, height),
        "spike_cube": spike_cube_distance(ev_r, ev_s, width, height),
        "n_real": len(ev_r[0]),
        "n_sim": len(ev_s[0]),
    }

    # sweeps (computed, not transcribed like metric_figure.py)
    bias_rows, noise_rows = [], []
    for bias in BIAS_SWEEP:
        evb = _shift(ev_s, bias)
        bias_rows.append((
            bias,
            chamfer_distance(ev_r, evb, width, height),
            gaussian_distance(ev_r, evb, width, height),
        ))
    for n in NOISE_SWEEP:
        evn = _inject_noise(ev_s, n, width, height, t_span, rng)
        noise_rows.append((
            n,
            chamfer_distance(ev_r, evn, width, height),
            gaussian_distance(ev_r, evn, width, height),
        ))
    result["bias_sweep"] = bias_rows
    result["noise_sweep"] = noise_rows

    # visual artifacts: count frames + 3D clouds.  The frames are BGR, as
    # the reference builds them for OpenCV; written as RGB with PIL, they
    # are the PNGs cv2.imwrite writes, without needing OpenCV
    t0 = int(ev_r[0][0])
    for name, w in (("real", wr), ("sim", ws)):
        img = display_events_frame(w, t0, t0 + args.delta_t, width, height)
        Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(
            os.path.join(args.output, f"frame_{name}.png"))
        cloud = event_cloud_3d(w, t0, t0 + args.delta_t)
        if isinstance(cloud, tuple):
            np.savez(os.path.join(args.output, f"cloud_{name}.npz"),
                     positions=cloud[0], colors=cloud[1])

    # the metric figure (metric_figure.py, with live numbers)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, rows, xlabel in (
            (axes[0], bias_rows, "T_bias"),
            (axes[1], noise_rows, "Noise"),
        ):
            xs = [max(r[0], 1) for r in rows]
            ax.plot(xs, [r[1] for r in rows], color="red", label="chamfer")
            ax.plot(xs, [r[2] for r in rows], color="blue", label="gaussian")
            ax.set_xscale("log")
            ax.set_xlabel(xlabel)
            ax.set_ylabel("Metric")
            ax.legend()
        fig.savefig(os.path.join(args.output, "metric_figure.png"), dpi=120)
    except ImportError:
        pass

    out_json = os.path.join(args.output, "comparison.json")
    with open(out_json, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: result[k] for k in
                      ("chamfer", "gaussian", "spike_cube")}))
    print(f"full report -> {out_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
