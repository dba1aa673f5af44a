"""Event-readout arbiter models (bandwidth-saturation simulation).

The port's copy of ``event3dgs_tpu/events/arbiter.py`` (numpy, as there).

Equivalents of the reference's `Event_sensor/src/arbiter.py:6-124`: models of
how a real sensor's readout circuitry delays/drops events under load.

- :class:`BottleneckArbiter`: global FIFO with a fixed per-event readout
  time; events queue and their timestamps slip by the backlog.
- :class:`RowArbiter`: row-parallel arbitration — every event of a row is
  released when the row wins arbitration; a row can fire once per cycle.
- :class:`SynchronousArbiter`: frame-scan readout — events are released at
  the next scan crossing of their row.
"""

from __future__ import annotations

import numpy as np

from event3dgs_tpu_torch.events.buffer import EventBuffer


class BottleneckArbiter:
    """Global serializer: one event per ``dt_per_event`` µs."""

    def __init__(self, dt_per_event: float, start_time: float = 0.0):
        self.dt = float(dt_per_event)
        self.next_free = float(start_time)

    def process(self, buf: EventBuffer) -> EventBuffer:
        t, x, y, p = buf.arrays()
        out_t = np.empty_like(t)
        nf = self.next_free
        for i in range(len(t)):
            release = max(float(t[i]), nf)
            out_t[i] = np.uint64(release)
            nf = release + self.dt
        self.next_free = nf
        out = EventBuffer.from_arrays(out_t, x, y, p)
        out.sort()
        return out


class RowArbiter:
    """Row-wise arbitration: each arbitration cycle of ``cycle`` µs releases
    one pending row (lowest row index first), stamping all its pending
    events with the release time."""

    def __init__(self, cycle: float, height: int):
        self.cycle = float(cycle)
        self.height = height

    def process(self, buf: EventBuffer) -> EventBuffer:
        t, x, y, p = (np.asarray(a) for a in buf.arrays())
        if len(t) == 0:
            return EventBuffer(1)
        order = np.argsort(t, kind="stable")
        t, x, y, p = t[order], x[order], y[order], p[order]
        pending: dict[int, list[int]] = {}
        out_t = np.empty_like(t)
        clock = float(t[0])
        i = 0
        released = 0
        while released < len(t):
            while i < len(t) and t[i] <= clock:
                pending.setdefault(int(y[i]), []).append(i)
                i += 1
            if pending:
                row = min(pending)
                for j in pending.pop(row):
                    out_t[j] = np.uint64(clock)
                    released += 1
                clock += self.cycle
            else:
                clock = float(t[i])
        out = EventBuffer.from_arrays(out_t, x, y, p)
        out.sort()
        return out


class SynchronousArbiter:
    """Frame-scan readout: a scan pointer sweeps rows at ``row_time`` µs per
    row; an event is released when the scan next crosses its row."""

    def __init__(self, row_time: float, height: int, start_time: float = 0.0):
        self.row_time = float(row_time)
        self.height = height
        self.frame_time = self.row_time * height
        self.start = float(start_time)

    def process(self, buf: EventBuffer) -> EventBuffer:
        t, x, y, p = (np.asarray(a) for a in buf.arrays())
        if len(t) == 0:
            return EventBuffer(1)
        tf = t.astype(np.float64)
        row_offset = y.astype(np.float64) * self.row_time
        # next scan crossing of row y at/after t
        k = np.ceil((tf - self.start - row_offset) / self.frame_time)
        k = np.maximum(k, 0.0)
        release = self.start + k * self.frame_time + row_offset
        out = EventBuffer.from_arrays(release.astype(np.uint64), x, y, p)
        out.sort()
        return out
