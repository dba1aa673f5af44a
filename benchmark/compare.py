"""The numbers that decide ``correct``: gaps between the program's readings
and the plain reference's, each held against its limit."""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def relative_gap(prog, ref) -> float:
    """Largest |prog − ref| / |ref| over matching sequences of numbers."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def leaf_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf (over ``leaves``): (gap, leaf)."""
    median = statistics.median(ref[k] for k in leaves)
    worst, which = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, which = gap, k
    return worst, which


def moved_leaves(grad_norms: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: those under it move under Adam by round-off alone and
    are left out of the change."""
    median = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= share * median]
