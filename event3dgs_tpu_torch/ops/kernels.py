"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launch
functions returning the ``cudaError_t`` of the launch) and is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library, then
loaded with ``ctypes``.  All sources are compiled in parallel, one ``nvcc``
process each.  Libraries are cached under ``csrc/build/`` by a digest of
the source and the flags, so a changed source is rebuilt.  Importing this
module never runs ``nvcc``.

``-fmad=false`` is part of the build: the expansion kernel's ellipse cull
and the compositing kernels' alpha must round like their plain PyTorch
versions, which run one rounding per operation, and the backward kernel
must skip exactly the (pixel, instance) pairs the forward kernel skipped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

# source name → {C function: argtypes}; every function returns an int
# (cudaError_t of its launches, 0 on success) and takes the stream last
SIGNATURES = {
    "expand": {
        # offsets, order, rect, cull, n, cap, tiles_x, num_tiles,
        # tile_out, gauss_out, stream
        "e3d_expand_instances": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    },
    "sort_tiles": {
        # ids, n_ids, n_live, n_bins, counts_out, stream
        "e3d_tile_histogram": [_P, _I, _P, _I, _P, _P],
        # ids, n_ids, n_live, n_bins, offsets, drop_dest, block_base
        # scratch, dest_out, stream
        "e3d_stable_tile_rank": [_P, _I, _P, _I, _P, _I, _P, _P, _P],
    },
    "rasterize_fwd": {
        # inst_gauss, tile_offsets, tile_counts, feat, num_tiles, tiles_x,
        # width, height, rgb_out, logt_out, stop_out, stream
        "e3d_composite_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                  _P],
    },
    "rasterize_bwd": {
        # inst_gauss, tile_offsets, tile_counts, feat, num_tiles, tiles_x,
        # width, height, g_rgb, g_logt, logt_final, stop, rows_out, stream
        "e3d_composite_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P],
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


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


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
