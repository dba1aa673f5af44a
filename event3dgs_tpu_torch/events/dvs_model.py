"""DVS event-camera pixel model (ICNS-style), vectorized over pixels.

The port's copy of ``event3dgs_tpu/events/dvs_model.py`` (numpy, as there).

Behavioral reimplementation of the reference's `dsi` C++ module / Python
model (`Event_sensor/ICNS_extern/simu.hpp:202-306`,
`Event_sensor/src/dvs_sensor.py:328-427`): each pixel is a log photoreceptor
low-passed with an intensity-dependent time constant, firing an event each
time the filtered voltage moves a (noisy, per-event resampled) contrast
threshold away from the last event level, with refractory period, latency +
jitter, and optional background-noise events drawn from a measured
rate-histogram CDF.

Model summary (per pixel, per frame of duration dt):

    τ_p = τ·log(255)/log(I)
    v(t) = v₀ + (log I − v₀)(1 − e^{−(t−t₀)/τ_p})          (low-pass)
    fire + while v(dt) − v_last > θ⁺ (resp. − for θ⁻):
        amp = (v_last + θ − v₀)/(log I − v₀)
        latency ~ N(lat − τ_p·log(1−amp), √(jit² + (σ_θ τ_p/(log I − v₀))²))
        event at t₀ + latency; refractory until + ref; θ resampled

Unlike the elementwise C++ loop this implementation advances **all pixels
together** one crossing at a time (a bounded masked sweep), which is both
vectorization-friendly and the natural numpy formulation.  With noise
disabled (``DvsParams(th_noise=0, jitter=0, noise=None)``) the model is
fully deterministic and matches the C++ module's event stream — the parity
oracle the tests use (SURVEY §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from event3dgs_tpu_torch.events.buffer import EventBuffer

_U64_MAX = np.iinfo(np.uint64).max


def default_noise_hists(level: str = "low_light"):
    """Shipped default background-noise CDF histograms (pos, neg).

    Synthesized equivalents of the reference's measured IEBCS noise data
    (`data/noise/README.md`); ``level`` is "low_light" or "bright".
    """
    import os

    base = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "noise",
    )
    pos = np.load(os.path.join(base, f"noise_pos_{level}.npy"))
    neg = np.load(os.path.join(base, f"noise_neg_{level}.npy"))
    return pos, neg


@dataclass
class DvsParams:
    """Sensor parameters (defaults = the reference render pipeline's,
    `render.py:196` / `event_tools.py:33-37`)."""

    th_pos: float = 0.3
    th_neg: float = 0.3
    th_noise: float = 0.01
    latency: float = 100.0  # µs
    jitter: float = 10.0  # µs
    refractory: float = 100.0  # µs
    tau: float = 300.0  # µs

    @property
    def deterministic(self) -> bool:
        return self.th_noise == 0.0 and self.jitter == 0.0


class DvsSimulator:
    """Stateful DVS simulator over an (height, width) pixel array."""

    def __init__(
        self,
        width: int,
        height: int,
        params: DvsParams | None = None,
        seed: int = 0,
        max_events_per_pixel: int = 64,
    ):
        self.width = width
        self.height = height
        self.params = params or DvsParams()
        self.rng = np.random.default_rng(seed)
        self.max_events_per_pixel = max_events_per_pixel
        n = width * height
        self.time = 0.0
        self.last_v = np.zeros(n)
        self.cur_v = np.zeros(n)
        self.time_px = np.zeros(n)
        self.cur_ref = np.full(n, np.inf)
        self.tau_p = np.full(n, self.params.tau)
        self._resample_thresholds(np.ones(n, bool))
        # background noise: per-pixel next-event schedule (µs); +inf = off
        self.bgn_pos_next = np.full(n, np.inf)
        self.bgn_neg_next = np.full(n, np.inf)
        self.bgn_hist_pos: Optional[np.ndarray] = None
        self.bgn_hist_neg: Optional[np.ndarray] = None
        # the 72 candidate noise periods of the measured-histogram model
        # (rates j·10^i Hz for i in [-3, 4], j in [1, 9]; `simu.hpp:75-79`)
        rates = np.array(
            [j * 10.0**i for i in range(-3, 5) for j in range(1, 10)]
        )
        self.noise_periods = 1e6 / rates

    # ------------------------------------------------------------------ state

    def _resample_thresholds(self, mask: np.ndarray):
        p = self.params
        n = mask.size
        if p.th_noise == 0.0:
            pos = np.full(n, p.th_pos)
            neg = np.full(n, -p.th_neg)
        else:
            pos = np.maximum(self.rng.normal(p.th_pos, p.th_noise, n), 0.0)
            neg = np.minimum(self.rng.normal(-p.th_neg, p.th_noise, n), 0.0)
        if not hasattr(self, "cur_th_pos"):
            self.cur_th_pos = pos
            self.cur_th_neg = neg
        else:
            self.cur_th_pos = np.where(mask, pos, self.cur_th_pos)
            self.cur_th_neg = np.where(mask, neg, self.cur_th_neg)

    def init_noise(self, hist_pos: np.ndarray, hist_neg: np.ndarray):
        """Enable the measured-histogram background-noise model.

        Args:
            hist_pos/hist_neg: [n_samples, 72] per-sample rate CDFs (the
            reference ships `noise_neg_161lux.npy`); each pixel draws one
            sample row (`simu.hpp:179-193`).
        """
        n = self.width * self.height
        idx = self.rng.integers(0, hist_pos.shape[0], n)
        self.bgn_hist_pos = np.asarray(hist_pos)[idx]
        self.bgn_hist_neg = np.asarray(hist_neg)[idx]
        self.bgn_pos_next = self._draw_noise_wait(self.bgn_hist_pos) * \
            self.rng.uniform(size=n)
        self.bgn_neg_next = self._draw_noise_wait(self.bgn_hist_neg) * \
            self.rng.uniform(size=n)

    def _draw_noise_wait(self, hist: np.ndarray) -> np.ndarray:
        """Sample per-pixel inter-noise-event periods from the CDFs."""
        n = hist.shape[0]
        prob = self.rng.uniform(size=(n, 1))
        pos = np.argmax(hist >= prob, axis=1)
        none = ~(hist >= prob).any(axis=1)
        wait = self.noise_periods[pos]
        wait[none] = np.inf
        return wait

    def disable_noise(self):
        self.bgn_pos_next = np.full(self.width * self.height, np.inf)
        self.bgn_neg_next = np.full(self.width * self.height, np.inf)

    def init_image(self, img: np.ndarray):
        """Initialize pixel states from the first luminance frame
        (values in (0, 255]; `simu.hpp:204-215`)."""
        flat = np.asarray(img, np.float64).reshape(-1)
        lit = flat > 0
        logv = np.log(flat, where=lit, out=np.zeros_like(flat))
        self.time = 0.0
        self.last_v = np.where(lit, logv, self.last_v)
        self.cur_v = np.where(lit, logv, self.cur_v)
        self.time_px = np.zeros_like(self.time_px)
        self.cur_ref = np.full_like(self.cur_ref, np.inf)

    # ----------------------------------------------------------------- update

    def _lowpass_to(self, t, img_l, mask, sync_last=True):
        """Advance masked pixels' filter state to absolute time t.

        ``sync_last`` mirrors the C++ distinction: a refractory release sets
        ``last_v`` to the released voltage (the new event reference level,
        `simu.hpp:258-263`), while the end-of-frame advance moves only
        ``cur_v``/``time_px`` (`simu.hpp:298-299`).
        """
        decay = 1.0 - np.exp(
            -np.clip(t - self.time_px, 0.0, None) / self.tau_p
        )
        v = self.cur_v + (img_l - self.cur_v) * decay
        if sync_last:
            self.last_v = np.where(mask, v, self.last_v)
        self.cur_v = np.where(mask, v, self.cur_v)
        self.time_px = np.where(mask, t, self.time_px)
        if sync_last:
            self.cur_ref = np.where(mask, np.inf, self.cur_ref)

    def _emit_noise(self, dt: float, buf: EventBuffer):
        next_t = self.time + dt
        n = self.width * self.height
        ys, xs = np.divmod(np.arange(n), self.width)
        for sched, pol, hist in (
            (self.bgn_pos_next, 1, self.bgn_hist_pos),
            (self.bgn_neg_next, 0, self.bgn_hist_neg),
        ):
            due = sched < next_t
            if not due.any():
                continue
            idx = np.nonzero(due)[0]
            buf.add_array(
                sched[idx].astype(np.uint64), xs[idx].astype(np.uint16),
                ys[idx].astype(np.uint16),
                np.full(len(idx), pol, np.uint8),
            )
            self.cur_ref[idx] = sched[idx]
            sched[idx] += self._draw_noise_wait(hist[idx])

    def update(self, img: np.ndarray, dt: float) -> EventBuffer:
        """Feed one luminance frame after `dt` µs; returns its events
        (time-sorted), mirroring `dsi.updateImg` (`simu.hpp:248-306`)."""
        p = self.params
        buf = EventBuffer(256)
        flat = np.asarray(img, np.float64).reshape(-1)
        lit = flat > 0
        if self.bgn_hist_pos is not None:
            self._emit_noise(dt, buf)
        img_l = np.log(flat, where=lit, out=np.zeros_like(flat))
        self.tau_p = np.where(
            lit, p.tau * np.log(255.0) / np.where(img_l != 0, img_l, 1.0),
            self.tau_p,
        )
        t_end = self.time + dt

        # release pixels whose refractory ends inside this frame
        release = lit & (self.cur_ref < t_end)
        self._lowpass_to(np.where(release, self.cur_ref, self.time_px), img_l,
                         release)

        target = self.cur_v + (img_l - self.cur_v) * (
            1.0 - np.exp(-np.clip(t_end - self.time_px, 0, None) / self.tau_p)
        )

        n = self.width * self.height
        ys, xs = np.divmod(np.arange(n), self.width)
        for _ in range(self.max_events_per_pixel):
            open_px = lit & np.isinf(self.cur_ref)
            fire_pos = open_px & (target - self.last_v > self.cur_th_pos)
            fire_neg = open_px & (target - self.last_v < self.cur_th_neg)
            if not (fire_pos.any() or fire_neg.any()):
                break
            for fire, th, pol in (
                (fire_pos, self.cur_th_pos, 1),
                (fire_neg, self.cur_th_neg, 0),
            ):
                if not fire.any():
                    continue
                idx = np.nonzero(fire)[0]
                delta = img_l[idx] - self.cur_v[idx]
                amp = (self.last_v[idx] + th[idx] - self.cur_v[idx]) / delta
                lat_mean = p.latency - self.tau_p[idx] * np.log1p(-amp)
                if p.deterministic:
                    lat = lat_mean
                else:
                    sigma = np.sqrt(
                        p.jitter**2 + (p.th_noise * self.tau_p[idx] / delta) ** 2
                    )
                    lat = self.rng.normal(lat_mean, sigma)
                lat = np.clip(lat, 0.0, 1e4)
                # C++ adds u64 time + double latency then truncates to u64
                t_ev = np.floor(self.time_px[idx] + lat)
                buf.add_array(
                    t_ev.astype(np.uint64), xs[idx].astype(np.uint16),
                    ys[idx].astype(np.uint16),
                    np.full(len(idx), pol, np.uint8),
                )
                self.cur_ref[idx] = t_ev + p.refractory
                self._resample_thresholds(fire)
                # refractory release within the frame re-opens the pixel
                rel = np.zeros(n, bool)
                rel[idx] = self.cur_ref[idx] < t_end
                self._lowpass_to(
                    np.where(rel, self.cur_ref, self.time_px), img_l, rel
                )

        self._lowpass_to(np.full(n, t_end), img_l, lit, sync_last=False)
        self.time = t_end
        buf.sort()
        return buf
