"""Event-stream distance metrics.

The port's copy of ``event3dgs_tpu/events/metrics.py`` (numpy, as there).

Equivalents of the reference's `Event_sensor/src/event_loss.py`:

- :func:`chamfer_distance`: symmetric nearest-neighbor distance between two
  streams embedded as normalized (x, y, p, t) 4D point clouds
  (`event_loss.py:32-71`);
- :func:`gaussian_distance`: the gaussian-kernel variant (`:73-115`);
- :func:`spike_cube_distance`: RKHS inner-product distance over
  spatio-temporal cubes with an exponential temporal kernel (`:117-272`,
  reimplementing the vendored "asynchronous spatio-temporal spike metric").
"""

from __future__ import annotations

import numpy as np


def _normalize_stream(x, y, p, t, width, height, t_span):
    pts = np.stack(
        [
            np.asarray(x, np.float64) / max(width, 1),
            np.asarray(y, np.float64) / max(height, 1),
            np.asarray(p, np.float64),
            np.asarray(t, np.float64) / max(t_span, 1),
        ],
        axis=1,
    )
    return pts


def chamfer_distance(
    ev_a: tuple, ev_b: tuple, width: int, height: int
) -> float:
    """Symmetric mean nearest-neighbor distance in normalized 4D."""
    from scipy.spatial import cKDTree

    ta, xa, ya, pa = ev_a
    tb, xb, yb, pb = ev_b
    if len(ta) == 0 or len(tb) == 0:
        return float("inf")
    span = max(int(max(ta[-1], tb[-1])) - int(min(ta[0], tb[0])), 1)
    a = _normalize_stream(xa, ya, pa, ta, width, height, span)
    b = _normalize_stream(xb, yb, pb, tb, width, height, span)
    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return float(da.mean() + db.mean())


def gaussian_distance(
    ev_a: tuple, ev_b: tuple, width: int, height: int, sigma: float = 0.1
) -> float:
    """Gaussian-kernel chamfer variant: 1 − exp(−d²/2σ²) averaged both
    ways (`event_loss.py:73-115`)."""
    from scipy.spatial import cKDTree

    ta, xa, ya, pa = ev_a
    tb, xb, yb, pb = ev_b
    if len(ta) == 0 or len(tb) == 0:
        return float("inf")
    span = max(int(max(ta[-1], tb[-1])) - int(min(ta[0], tb[0])), 1)
    a = _normalize_stream(xa, ya, pa, ta, width, height, span)
    b = _normalize_stream(xb, yb, pb, tb, width, height, span)
    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    ga = 1.0 - np.exp(-(da**2) / (2 * sigma**2))
    gb = 1.0 - np.exp(-(db**2) / (2 * sigma**2))
    return float(ga.mean() + gb.mean())


def spike_cube_distance(
    ev_a: tuple,
    ev_b: tuple,
    width: int,
    height: int,
    cube: int = 16,
    tau: float = 1e4,
) -> float:
    """RKHS spike-train distance over spatial cubes.

    Each ``cube × cube`` spatial block's events form a spike train; with the
    exponential kernel k(t, t') = exp(−|t−t'|/τ) the squared RKHS distance is
    ⟨a,a⟩ + ⟨b,b⟩ − 2⟨a,b⟩ with ⟨u,v⟩ = Σᵢⱼ k(uᵢ, vⱼ).  Summed over cubes
    and polarities (`event_loss.py:117-272`).
    """
    def trains(ev):
        t, x, y, p = ev
        out = {}
        cx = np.asarray(x) // cube
        cy = np.asarray(y) // cube
        for key in zip(cx, cy, np.asarray(p)):
            out.setdefault(key, []).append(0)
        # second pass storing times (keeps per-key order)
        out = {}
        for ti, xi, yi, pi in zip(t, cx, cy, np.asarray(p)):
            out.setdefault((xi, yi, pi), []).append(float(ti))
        return {k: np.asarray(v) for k, v in out.items()}

    def inner(u, v):
        if len(u) == 0 or len(v) == 0:
            return 0.0
        d = np.abs(u[:, None] - v[None, :])
        return float(np.exp(-d / tau).sum())

    ta_, tb_ = trains(ev_a), trains(ev_b)
    keys = set(ta_) | set(tb_)
    total = 0.0
    empty = np.zeros(0)
    for k in keys:
        u = ta_.get(k, empty)
        v = tb_.get(k, empty)
        total += inner(u, u) + inner(v, v) - 2.0 * inner(u, v)
    return float(max(total, 0.0))
