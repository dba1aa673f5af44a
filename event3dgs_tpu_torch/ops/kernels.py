"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launch
functions returning the ``cudaError_t`` of the launch) and is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library, then
loaded with ``ctypes``.  All sources are compiled in parallel, one ``nvcc``
process each.  Libraries are cached under ``csrc/build/`` by a digest of
the source, the headers of ``csrc/`` it includes and the flags, so a
changed source or header is rebuilt.  Importing this module never runs
``nvcc``.

``-fmad=false`` is part of the build: the table kernel's rects and cull
data, the expansion kernel's ellipse cull and the compositing kernels'
alpha must round like their plain PyTorch versions, which run one rounding per operation, and the backward kernel
must skip exactly the (pixel, instance) pairs the forward kernel skipped.
A kernel fuses a product into a sum only where it says so (``__fmaf_rn``
in the backward kernel's gradient sums).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

# source name → {C function: argtypes}; every function returns an int
# (a cudaError_t, 0 on success); the launch functions take the stream last,
# the ``*_occupancy`` ones write (registers per thread, resident blocks per
# SM) of their kernel
SIGNATURES = {
    "expand": {
        # mean2d, conic (or null), radius, valid, opacity (or null), depth,
        # n, tiles_x, tiles_y, rect_out, cull_out, key_out, lookback state
        # to clear (or null), stream
        "e3d_gaussian_tables": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                _P, _P, _P],
        # order (int64 argsort), rect, n, segments, lookback state,
        # order_out, offsets_out, seg_rank_out, stream
        "e3d_depth_offsets": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
        # rect, cull, offsets, order, seg_rank, n, cap, tiles_x, num_tiles,
        # tile_out, gauss_out, count rows out (or null), stream
        "e3d_expand_instances": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                 _P, _P],
    },
    "sort_tiles": {
        # ids, n_ids, n_live, n_bins, segment_base scratch, counts_out,
        # stream
        "e3d_tile_histogram": [_P, _I, _P, _I, _P, _P, _P],
        # ids, n_ids, n_live, n_bins, offsets, drop_dest, segment_base
        # scratch, dest_out, stream
        "e3d_stable_tile_rank": [_P, _I, _P, _I, _P, _I, _P, _P, _P],
        # ids, gauss, n_ids, n_live, n_bins, fill, counted (segment_base
        # holds the count rows), segment_base scratch, counts_out,
        # offsets_out, dest_out, inst_out, overflow_out, stream
        "e3d_counting_sort": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P],
    },
    "rasterize_fwd": {
        # inst_gauss, tile_offsets, tile_counts, feat, num_tiles, tiles_x,
        # width, height, rgb_out, logt_out, stop_out, stream
        "e3d_composite_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                  _P],
        "e3d_composite_forward_occupancy": [_IP, _IP],
    },
    "rasterize_bwd": {
        # inst_gauss, tile_offsets, tile_counts, feat, num_tiles, tiles_x,
        # width, height, g_rgb, g_logt, logt_final, stop, rows_out, stream
        "e3d_composite_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P],
        "e3d_composite_backward_occupancy": [_IP, _IP],
    },
    "segsum": {
        # rows, n_rows, width, dest, starts, ends, n_seg, limit, order, out,
        # stream
        "e3d_segment_sums": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/{name}.cu`` and the ``csrc/`` headers it includes, directly
    or through another header, in the order first included."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all started together.  Returns, per source,
    what the compiler reported (``-Xptxas -v``: registers, shared memory,
    spills of each kernel), or the saved report of an earlier build.
    Raises if any compile fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n).with_suffix(".log").read_text() for n in names}


def function(name: str, fn: str):
    """The bound C launch function ``fn`` of source ``name`` (built on first
    use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for f, argtypes in SIGNATURES[name].items():
            getattr(lib, f).argtypes = argtypes
            getattr(lib, f).restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(lib, fn)


def occupancy(name: str, fn: str) -> tuple[int, int]:
    """(registers per thread, resident blocks per SM) of the kernel that
    the C function ``fn`` of source ``name`` reports on."""
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = function(name, fn)(ctypes.byref(regs), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {err}")
    return regs.value, blocks.value


def launch(name: str, fn: str, *args) -> None:
    """Call a launch function on the current stream; raise on its error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = function(name, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError_t {err}")


def check(t: torch.Tensor, dtype: torch.dtype, what: str, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
