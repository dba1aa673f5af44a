"""Event buffer: SoA storage for DVS event streams.

The port's copy of ``event3dgs_tpu/events/buffer.py`` (numpy, as there).

Equivalent of the reference's `EventBuffer`
(`Event_sensor/src/event_buffer.py:7-252`): timestamps (u64, µs), pixel
coordinates (u16), polarity (u8), with amortized growth, merging of sorted
streams, and writers for `.dat`/`.csv`/`.h5`.
"""

from __future__ import annotations

import numpy as np

EVENT_DTYPE = np.dtype(
    [("t", "<u8"), ("x", "<u2"), ("y", "<u2"), ("p", "u1")]
)


class EventBuffer:
    """Growable struct-of-arrays event container (timestamps in µs)."""

    def __init__(self, capacity: int = 1024):
        capacity = max(int(capacity), 1)
        self.t = np.zeros(capacity, np.uint64)
        self.x = np.zeros(capacity, np.uint16)
        self.y = np.zeros(capacity, np.uint16)
        self.p = np.zeros(capacity, np.uint8)
        self.size = 0

    def __len__(self) -> int:
        return self.size

    @property
    def capacity(self) -> int:
        return len(self.t)

    def _grow_to(self, needed: int):
        cap = self.capacity
        if needed <= cap:
            return
        new_cap = max(needed, cap * 2)
        for name in ("t", "x", "y", "p"):
            arr = getattr(self, name)
            grown = np.zeros(new_cap, arr.dtype)
            grown[: self.size] = arr[: self.size]
            setattr(self, name, grown)

    def add(self, t: int, x: int, y: int, p: int):
        self._grow_to(self.size + 1)
        i = self.size
        self.t[i], self.x[i], self.y[i], self.p[i] = t, x, y, p
        self.size += 1

    def add_array(self, t, x, y, p):
        """Append arrays of events (assumed time-ordered within the batch)."""
        n = len(t)
        if n == 0:
            return
        self._grow_to(self.size + n)
        s = self.size
        self.t[s : s + n] = t
        self.x[s : s + n] = x
        self.y[s : s + n] = y
        self.p[s : s + n] = p
        self.size += n

    def merge(self, other: "EventBuffer"):
        """Merge another buffer, keeping global time order."""
        self.add_array(*other.arrays())
        self.sort()

    def sort(self):
        order = np.argsort(self.t[: self.size], kind="stable")
        for name in ("t", "x", "y", "p"):
            arr = getattr(self, name)
            arr[: self.size] = arr[: self.size][order]

    def arrays(self):
        return (
            self.t[: self.size],
            self.x[: self.size],
            self.y[: self.size],
            self.p[: self.size],
        )

    def to_structured(self) -> np.ndarray:
        out = np.empty(self.size, EVENT_DTYPE)
        out["t"], out["x"], out["y"], out["p"] = self.arrays()
        return out

    @classmethod
    def from_arrays(cls, t, x, y, p) -> "EventBuffer":
        buf = cls(len(t))
        buf.add_array(t, x, y, p)
        return buf

    # ---- writers (reference `event_buffer.py:226-251`, `dat_files.py`) ----

    def write_dat(self, path: str, width: int = 0, height: int = 0):
        from event3dgs_tpu_torch.events.io import write_dat_events

        write_dat_events(path, *self.arrays(), width=width, height=height)

    def write_csv(self, path: str):
        t, x, y, p = self.arrays()
        with open(path, "w") as f:
            for i in range(self.size):
                f.write(f"{t[i]},{x[i]},{y[i]},{p[i]}\n")

    def write_h5(self, path: str):
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("t", data=self.t[: self.size])
            f.create_dataset("x", data=self.x[: self.size])
            f.create_dataset("y", data=self.y[: self.size])
            f.create_dataset("p", data=self.p[: self.size])
