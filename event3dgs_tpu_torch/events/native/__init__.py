"""Native DVS simulator: ``dvs_native.cpp`` built with ``g++`` on first use,
bound with ``ctypes``.

Counterpart of ``event3dgs_tpu/events/native/__init__.py``.  The source is
the port's own copy, with a plain C interface on raw arrays instead of a
CPython module, so the build needs no Python headers and a 1080p frame
crosses the boundary as one float64 buffer instead of a 2M-element list.
The library is cached under ``build/`` (git-ignored) by a digest of the
source and the flags; a build writes a temporary file and renames it into
place, so concurrent first uses in several processes are safe.  Importing
this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from event3dgs_tpu_torch.events.buffer import EventBuffer

SRC = Path(__file__).resolve().parent / "dvs_native.cpp"
BUILD_DIR = SRC.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-std=c++17", "-fPIC")

_P, _I64, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# C function → (argtypes, restype)
SIGNATURES = {
    "dvs_create": ([ctypes.c_int, ctypes.c_int, ctypes.c_uint64], _P),
    "dvs_destroy": ([_P], None),
    "dvs_init_latency": ([_P, _D, _D, _D, _D], ctypes.c_int),
    "dvs_init_contrast": ([_P, _D, _D, _D], ctypes.c_int),
    "dvs_init_noise": ([_P, _P, _P, _I64], ctypes.c_int),
    "dvs_disable_noise": ([_P], ctypes.c_int),
    "dvs_init_img": ([_P, _P], ctypes.c_int),
    "dvs_update": ([_P, _P, _D], _I64),
    "dvs_take_events": ([_P, _P, _P, _P, _P], ctypes.c_int),
    "dvs_get_curv": ([_P, _P], ctypes.c_int),
}

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdvs_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, (argtypes, restype) in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _lib = lib
    return _lib


def _f64(a, n: int) -> np.ndarray:
    """``a`` as a contiguous float64 array of ``n`` values."""
    a = np.ascontiguousarray(a, np.float64).reshape(-1)
    if a.size != n:
        raise ValueError(f"expected {n} values, got {a.size}")
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeDvsSimulator:
    """numpy wrapper over the C++ simulator, API-compatible with
    :class:`event3dgs_tpu_torch.events.dvs_model.DvsSimulator` (and with
    the JAX package's ``NativeDvsSimulator``)."""

    def __init__(self, width: int, height: int, params=None, seed: int = 12345):
        from event3dgs_tpu_torch.events.dvs_model import DvsParams

        self.width = width
        self.height = height
        self.params = params or DvsParams()
        self._lib = load()
        self._h = self._lib.dvs_create(width, height, seed)
        if not self._h:
            raise MemoryError("dvs_create failed")
        p = self.params
        self._call("dvs_init_latency", p.latency, p.jitter, p.refractory, p.tau)
        self._call("dvs_init_contrast", p.th_pos, p.th_neg, p.th_noise)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dvs_destroy(h)

    def _call(self, fn: str, *args):
        err = getattr(self._lib, fn)(self._h, *args)
        if err != 0:
            raise RuntimeError(f"{fn} failed ({err})")

    @property
    def _n(self) -> int:
        return self.width * self.height

    def init_noise(self, hist_pos, hist_neg):
        hp = np.ascontiguousarray(hist_pos, np.float64)
        n_samples = hp.shape[0]
        hp = _f64(hp, n_samples * 72)
        hn = _f64(hist_neg, n_samples * 72)
        self._call("dvs_init_noise", _ptr(hp), _ptr(hn), n_samples)

    def disable_noise(self):
        self._call("dvs_disable_noise")

    def init_image(self, img):
        self._call("dvs_init_img", _ptr(_f64(img, self._n)))

    def update(self, img, dt) -> EventBuffer:
        n = self._lib.dvs_update(self._h, _ptr(_f64(img, self._n)), float(dt))
        t = np.empty(n, np.uint64)
        x = np.empty(n, np.uint16)
        y = np.empty(n, np.uint16)
        p = np.empty(n, np.uint8)
        self._call("dvs_take_events", _ptr(t), _ptr(x), _ptr(y), _ptr(p))
        return EventBuffer.from_arrays(t, x, y, p)

    @property
    def voltages(self) -> np.ndarray:
        out = np.empty(self._n, np.float64)
        self._call("dvs_get_curv", _ptr(out))
        return out.reshape(self.height, self.width)
