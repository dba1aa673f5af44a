"""Event file codecs: Prophesee `.dat` (v1/v2), CSV, HDF5, windowing.

The port's copy of ``event3dgs_tpu/events/io.py`` (numpy, as there).

Equivalent of the reference's `EventsData` + `dat_files`
(`Event_sensor/src/event_file_io.py`, `src/dat_files.py`):

- `.dat`: '%'-prefixed ASCII header, one event-type byte + event-size byte,
  then little-endian (timestamp u32, packed u32) pairs.  V2 packs
  x in bits 0-10, y in bits 14-27, polarity in bit 28; V1 uses 9/9/1 bits at
  shifts 0/9/17 (`event_file_io.py:113-135`).  The reference writes via the
  Metavision SDK's DatWriter; we emit the same v2 wire format directly.
- HDF5: flat or `events/`-grouped t/x/y/p datasets (`load_h5_event:30-44`).
- windowing: split a stream into `delta_t` buckets of structured arrays,
  the shape `render.py`'s training data prep consumes
  (`read_IEBCS_events:251-294`).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_V2_X_MASK, _V2_Y_SHIFT, _V2_P_SHIFT = 0x7FF, 14, 28
_V1_X_MASK, _V1_Y_SHIFT, _V1_P_SHIFT = 0x1FF, 9, 17
_V1_Y_MASK = 0x1FE00
_V2_Y_MASK = 0x0FFFC000
_V1_P_MASK = 0x00020000
_V2_P_MASK = 0x10000000


def write_dat_events(
    path: str, t, x, y, p, width: int = 0, height: int = 0
) -> None:
    """Write a Prophesee v2 `.dat` event file."""
    x = np.asarray(x, np.uint32)
    y = np.asarray(y, np.uint32)
    p = np.asarray(p, np.uint32)
    t = np.asarray(t, np.uint64)
    if width <= 0:
        width = int(x.max()) + 1 if len(x) else 0
    if height <= 0:
        height = int(y.max()) + 1 if len(y) else 0
    if len(x) and (x.max() > _V2_X_MASK or y.max() >= (1 << 14)):
        raise ValueError("coordinates exceed the .dat v2 field widths")
    header = (
        "% Data file containing CD events.\n"
        "% Version 2\n"
        f"% Width {width}\n"
        f"% Height {height}\n"
    )
    packed = (
        (x & _V2_X_MASK)
        | ((y & 0x3FFF) << _V2_Y_SHIFT)
        | ((p & 1) << _V2_P_SHIFT)
    ).astype(np.uint32)
    inter = np.empty(2 * len(t), np.uint32)
    inter[0::2] = t.astype(np.uint32)
    inter[1::2] = packed
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(struct.pack("<BB", 0, 8))  # event type CD, 8 bytes/event
        f.write(inter.tobytes())


def load_dat_events(path: str, start: int = 0, stop: int = -1):
    """Load a Prophesee/IEBCS `.dat` file (auto-detects v1/v2).

    The same binary format the IEBCS simulator emits — the reference's
    IEBCS loader (`load_dat_event`, `event_file_io.py:57-146`) is this
    decoder with a ``start``/``stop`` timestamp window: events before
    ``start`` µs are skipped and, when ``stop > 0``, events at or after
    ``stop`` µs are dropped (vectorized here; the reference scans the file
    byte-wise).

    Returns (t u64, x u16, y u16, p u8).
    """
    header = b""
    with open(path, "rb") as f:
        line = f.readline()
        while line and line[0] == 0x25:  # '%'
            header += line
            pos = f.tell()
            line = f.readline()
        f.seek(pos)
        _ev_type, ev_size = struct.unpack("<BB", f.read(2))
        if ev_size != 8:
            raise ValueError(f"unsupported .dat event size {ev_size}")
        payload = np.frombuffer(f.read(), dtype="<u4")
    if len(payload) % 2:
        payload = payload[:-1]
    t = payload[0::2].astype(np.uint64)
    data = payload[1::2]
    if start > 0 or stop > 0:
        keep = t >= np.uint64(start)
        if stop > 0:
            keep &= t < np.uint64(stop)
        t, data = t[keep], data[keep]
    text = header.decode("ascii", "replace")
    version = 0
    if "Version" in text:
        try:
            version = int(text.split("Version")[1].split()[0])
        except (ValueError, IndexError):
            version = 0
    if version >= 2:
        x = (data & _V2_X_MASK).astype(np.uint16)
        y = ((data & _V2_Y_MASK) >> _V2_Y_SHIFT).astype(np.uint16)
        p = ((data & _V2_P_MASK) >> _V2_P_SHIFT).astype(np.uint8)
    else:
        x = (data & _V1_X_MASK).astype(np.uint16)
        y = ((data & _V1_Y_MASK) >> _V1_Y_SHIFT).astype(np.uint16)
        p = ((data & _V1_P_MASK) >> _V1_P_SHIFT).astype(np.uint8)
    return t, x, y, p


def load_h5_events(path: str):
    """Load t/x/y/p from a flat or `events/`-grouped HDF5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f["events"] if "events" in f else f
        return (
            np.asarray(g["t"]),
            np.asarray(g["x"]),
            np.asarray(g["y"]),
            np.asarray(g["p"]),
        )


def load_csv_events(path: str):
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    return (
        data[:, 0].astype(np.uint64),
        data[:, 1].astype(np.uint16),
        data[:, 2].astype(np.uint16),
        data[:, 3].astype(np.uint8),
    )


WINDOW_DTYPE = np.dtype(
    {
        "names": ["x", "y", "p", "t"],
        "formats": ["<u2", "<u2", "<i2", "<i8"],
        "offsets": [0, 2, 4, 8],
        "itemsize": 16,
    }
)


class EventsData(NamedTuple):
    """Windowed event stream (reference `EventsData`,
    `event_file_io.py:145-155`)."""

    events: list  # list of structured arrays (WINDOW_DTYPE)
    width: int
    height: int
    delta_t: int
    global_min_t: int
    global_max_t: int


def window_events(t, x, y, p, delta_t: int) -> EventsData:
    """Split a time-ordered stream into `delta_t`-µs buckets
    (`read_IEBCS_events:251-294`)."""
    t = np.asarray(t)
    width = int(np.max(x)) + 1 if len(x) else 0
    height = int(np.max(y)) + 1 if len(y) else 0
    windows = []
    if len(t):
        start, end = int(t[0]), int(t[-1])
        edges = np.arange(start, end + delta_t, delta_t)
        for lo, hi in zip(edges[:-1], edges[1:]):
            a = np.searchsorted(t, lo)
            b = np.searchsorted(t, hi)
            w = np.zeros(b - a, WINDOW_DTYPE)
            w["x"], w["y"], w["p"], w["t"] = x[a:b], y[a:b], p[a:b], t[a:b]
            windows.append(w)
    return EventsData(
        events=windows,
        width=width,
        height=height,
        delta_t=delta_t,
        global_min_t=int(t[0]) if len(t) else 0,
        global_max_t=int(t[-1]) if len(t) else 0,
    )


def read_dat_windowed(path: str, delta_t: int) -> EventsData:
    """`.dat` → windowed EventsData, the render.py data-prep entry point."""
    return window_events(*load_dat_events(path), delta_t)


def load_text_events(
    path: str, time_scale: float = 1.0, max_events: int = 5_000_000
):
    """Load whitespace-separated ``t x y p`` text events.

    Covers the reference's V2E reader (`read_V2E_events`,
    `event_file_io.py:296-349`, timestamps in seconds → ``time_scale=1e6``)
    and the "Volt" reader (`read_Volt_events:350-403`, already µs →
    ``time_scale=1``).  Lines starting with '#' or '(' are comments; streams
    are capped at ``max_events`` like the reference.
    """
    ts, xs, ys, ps = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#") or line.startswith("("):
                continue
            vals = line.split()
            if len(vals) < 4:
                continue
            ts.append(int(float(vals[0]) * time_scale))
            xs.append(int(vals[1]))
            ys.append(int(vals[2]))
            ps.append(int(vals[3]))
            if len(ts) > max_events:
                break
    return (
        np.asarray(ts, np.uint64),
        np.asarray(xs, np.uint16),
        np.asarray(ys, np.uint16),
        np.asarray(ps, np.uint8),
    )


def read_v2e_windowed(path: str, delta_t: int) -> EventsData:
    """V2E text stream (seconds) → windowed EventsData
    (`read_V2E_events`, `event_file_io.py:296-349`)."""
    return window_events(*load_text_events(path, time_scale=1e6), delta_t)


def read_volt_windowed(path: str, delta_t: int) -> EventsData:
    """Volt text stream (µs) → windowed EventsData
    (`read_Volt_events`, `event_file_io.py:350-403`)."""
    return window_events(*load_text_events(path, time_scale=1.0), delta_t)


def read_iebcs_windowed(path: str, delta_t: int) -> EventsData:
    """IEBCS `.dat` → windowed EventsData with the reference's exact
    bucketing (`read_IEBCS_events`, `event_file_io.py:251-294`): buckets
    are anchored at the first event's timestamp, ``duration // delta_t``
    full windows plus one remainder window holding the tail — unlike the
    generic :func:`window_events`, whose last regular bucket absorbs the
    tail.  ``global_min_t`` is normalized to 0."""
    t, x, y, p = load_dat_events(path)
    width = int(np.max(x)) + 1 if len(x) else 0
    height = int(np.max(y)) + 1 if len(y) else 0
    windows = []
    if len(t):
        start, end = int(t[0]), int(t[-1])
        num_buffers = (end - start) // delta_t

        def bucket(a, b):
            w = np.zeros(b - a, WINDOW_DTYPE)
            w["x"], w["y"], w["p"], w["t"] = x[a:b], y[a:b], p[a:b], t[a:b]
            return w

        for i in range(num_buffers):
            a = np.searchsorted(t, start + i * delta_t)
            b = np.searchsorted(t, start + (i + 1) * delta_t, side="right")
            windows.append(bucket(a, b))
        rem = np.searchsorted(t, start + num_buffers * delta_t)
        if rem < len(t):
            windows.append(bucket(rem, len(t)))
    return EventsData(
        events=windows,
        width=width,
        height=height,
        delta_t=delta_t,
        global_min_t=0,
        global_max_t=(int(t[-1]) - int(t[0])) if len(t) else 0,
    )


def read_metavision_live(path: str, delta_t: int) -> EventsData:
    """Metavision RAW/live stream → windowed EventsData.

    The reference's `read_real_events` (`event_file_io.py:156-173`) decodes
    EVT3 `.raw` recordings and live camera streams through the proprietary
    Metavision SDK (`metavision_core.event_io.EventsIterator`); the EVT3
    wire format is compressed and undocumented, so there is no SDK-free
    decode path (the reference itself notes it cannot re-encode EVT3).
    This reader uses the SDK when installed and raises a clear error
    otherwise — record to `.dat`/HDF5 for the SDK-free pipeline.
    """
    try:
        from metavision_core.event_io import EventsIterator  # type: ignore
    except ImportError as e:
        raise ImportError(
            "Metavision RAW/live input requires the proprietary Metavision "
            "SDK (pip package `metavision-core`, Prophesee license). "
            "Convert recordings to .dat or HDF5 for the SDK-free readers "
            "(events/io.py WINDOWED_READERS)."
        ) from e

    it = EventsIterator(input_path=path, delta_t=delta_t)
    height, width = it.get_size()
    windows = []
    gmin = gmax = -1
    for evs in it:
        if evs.size == 0:
            continue
        if gmin == -1:
            gmin = int(evs["t"][0])
        gmax = int(evs["t"][-1])
        w = np.zeros(evs.size, WINDOW_DTYPE)
        for k in ("x", "y", "p", "t"):
            w[k] = evs[k]
        windows.append(w)
    return EventsData(
        events=windows,
        width=width,
        height=height,
        delta_t=delta_t,
        global_min_t=0,
        global_max_t=max(gmax - gmin, 0),
    )


def read_h5_windowed(path: str, delta_t: int) -> EventsData:
    """EDS/TUM-VIE style HDF5 stream → windowed EventsData
    (`read_eds_events` / `read_Tumvie_events`, `event_file_io.py:174-250`)."""
    return window_events(*load_h5_events(path), delta_t)


def read_csv_windowed(path: str, delta_t: int) -> EventsData:
    """CSV ``t,x,y,p`` stream → windowed EventsData."""
    return window_events(*load_csv_events(path), delta_t)


#: Format-keyed reader registry, the dispatch surface `render.py`-style
#: tooling uses (reference `EventsData.read_*` method family).
WINDOWED_READERS = {
    "dat": read_dat_windowed,
    "iebcs": read_iebcs_windowed,
    "h5": read_h5_windowed,
    "eds": read_h5_windowed,
    "tumvie": read_h5_windowed,
    "v2e": read_v2e_windowed,
    "volt": read_volt_windowed,
    "csv": read_csv_windowed,
    "raw": read_metavision_live,
    "metavision": read_metavision_live,
}
