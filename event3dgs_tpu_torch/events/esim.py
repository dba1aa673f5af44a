"""ESIM-style event simulator: linear log-intensity crossing counts.

The port's copy of ``event3dgs_tpu/events/esim.py`` (numpy, as there).

Equivalent of the reference's numba implementation
(`Event_sensor/src/Esim.py:35-92`) as vectorized numpy: between two frames the
log intensity is assumed to move linearly; every threshold crossing emits an
event with a linearly interpolated timestamp.  Much simpler than the ICNS
model (no low-pass, latency, or refractory) and fully differentiable-free /
batched — useful for fast synthetic data.
"""

from __future__ import annotations

import numpy as np

from event3dgs_tpu_torch.events.buffer import EventBuffer


class EsimSimulator:
    def __init__(self, width: int, height: int, th_pos=0.3, th_neg=0.3,
                 log_eps: float = 1e-3):
        self.width = width
        self.height = height
        self.th_pos = th_pos
        self.th_neg = th_neg
        self.log_eps = log_eps
        self.ref_log = None
        self.time = 0.0

    def init_image(self, img: np.ndarray):
        self.ref_log = np.log(np.asarray(img, np.float64) + self.log_eps)
        self.time = 0.0

    def update(self, img: np.ndarray, dt: float) -> EventBuffer:
        """Emit all threshold crossings between the previous and new frame."""
        new_log = np.log(np.asarray(img, np.float64) + self.log_eps)
        delta = new_log - self.ref_log
        pos_n = np.floor(np.maximum(delta, 0.0) / self.th_pos).astype(int)
        neg_n = np.floor(np.maximum(-delta, 0.0) / self.th_neg).astype(int)
        buf = EventBuffer(int(pos_n.sum() + neg_n.sum()) + 1)
        h, w = delta.shape
        ys, xs = np.divmod(np.arange(h * w), w)
        for counts, th, pol, sign in ((pos_n, self.th_pos, 1, 1.0),
                                      (neg_n, self.th_neg, 0, -1.0)):
            flat = counts.reshape(-1)
            if flat.max(initial=0) == 0:
                continue
            d = np.abs(delta.reshape(-1))
            for k in range(1, int(flat.max()) + 1):
                m = flat >= k
                # linear interpolation of the k-th crossing time
                frac = np.clip((k * th) / np.where(m, d, 1.0), 0.0, 1.0)
                t_ev = self.time + frac[m] * dt
                idx = np.nonzero(m)[0]
                buf.add_array(
                    t_ev.astype(np.uint64),
                    xs[idx].astype(np.uint16),
                    ys[idx].astype(np.uint16),
                    np.full(len(idx), pol, np.uint8),
                )
        # reference level advances by the emitted whole thresholds only
        self.ref_log = self.ref_log + pos_n * self.th_pos - neg_n * self.th_neg
        self.time += dt
        buf.sort()
        return buf
