"""Combine / synthesize measured background-noise CDF histograms
(counterpart of ``event3dgs_tpu/examples/noise_calibration.py``).

Port of `noise_calibration.py` (reference
`Event_sensor/src/noise_calibration.py:1-24`): averages two measured
noise-rate CDF histograms (the IEBCS `noise_{pos,neg}_*lux.npy` format the
DVS model's `init_bgn_hist` consumes).  Adds `--synthesize <rate_hz>` for
environments without measured data: builds a degenerate CDF that puts all
mass on the candidate period closest to the requested rate — the 72-period
candidate grid matches the pixel model (`events/dvs_model.py`, reference
`simu.hpp:75-79`), so the synthetic histogram drives the same machinery.

    python -m event3dgs_tpu_torch.examples.noise_calibration \
        --inputs a.npy b.npy -o avg.npy
    python -m event3dgs_tpu_torch.examples.noise_calibration \
        --synthesize 0.1 -o synth_0p1hz.npy
"""

from __future__ import annotations

import argparse

import numpy as np

# candidate noise rates j·10^i Hz, i in [-3, 4], j in [1, 9] (simu.hpp)
CANDIDATE_RATES = np.array(
    [j * 10.0**i for i in range(-3, 5) for j in range(1, 10)]
)


def average_histograms(paths) -> np.ndarray:
    arrays = [np.load(p) for p in paths]
    shapes = {a.shape for a in arrays}
    if len(shapes) != 1:
        raise ValueError(f"histogram shapes differ: {shapes}")
    return np.average(arrays, axis=0)


def synthesize_histogram(rate_hz: float, n_pixels: int = 1) -> np.ndarray:
    """A CDF histogram assigning every pixel the candidate rate closest to
    ``rate_hz`` (step CDF over the 72-rate grid)."""
    idx = int(np.argmin(np.abs(CANDIDATE_RATES - rate_hz)))
    cdf = np.zeros((n_pixels, CANDIDATE_RATES.size))
    cdf[:, idx:] = 1.0
    return cdf


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--inputs", nargs="*", default=[])
    p.add_argument("--synthesize", type=float, default=None,
                   help="target noise rate in Hz")
    p.add_argument("--output", "-o", required=True)
    args = p.parse_args(argv)

    if args.synthesize is not None:
        out = synthesize_histogram(args.synthesize)
    elif len(args.inputs) >= 2:
        out = average_histograms(args.inputs)
    else:
        raise SystemExit("need --synthesize or at least two --inputs")
    np.save(args.output, out)
    print(f"wrote {out.shape} histogram -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
