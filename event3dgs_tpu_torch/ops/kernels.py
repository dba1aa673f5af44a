"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launch
functions returning the ``cudaError_t`` of the launch) and is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library, then
loaded with ``ctypes``.  All sources are compiled in parallel, one ``nvcc``
process each.  Libraries are cached under ``csrc/build/`` by a digest of
the source, the headers of ``csrc/`` it includes and the flags, so a
changed source or header is rebuilt.  Importing this module never runs
``nvcc``.

A build may carry ``-D`` macros (``defines``): the timing-only variants
of ``tools/kernel_probes.py`` (K1 and K4 with one cost term ablated) are
the shipping sources built with one or more of them.  The macros enter the
digest and the library's name, so each variant is its own cached library;
with no macros the digest and the name are the shipping library's.
Nothing on the render or training path passes macros.

``-fmad=false`` is part of the build: the preprocess forward kernel's
projection and colours, the table kernel's rects and cull data, the
expansion kernel's ellipse cull, the compositing kernels' alpha, the Adam
update, the event loss's image gradients and event count and the rgb and
gray modes' SSIM maps and gradients must round
like their plain PyTorch versions, which run one rounding per operation,
and the backward kernel must skip exactly the (pixel, instance) pairs the
forward kernel skipped.
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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# source name → {C function: argtypes}; every function returns an int
# (a cudaError_t, 0 on success); the launch functions take the stream last,
# the ``*_occupancy`` ones write (registers per thread, resident blocks per
# SM) of their kernel
SIGNATURES = {
    "preprocess": {
        # means, scales, rotations, opacities (or null), the first view's
        # mean2d tap (or null), features_dc (or null: degree -1,
        # projection only) and its row stride (floats), features_rest and
        # its row stride, K, the [K] mask (or null), SH degree, n,
        # scaling_modifier, views, per view 12 pointers (world_view,
        # full_proj, camera_center, tan_fovx, tan_fovy, mean2d_out,
        # depth_out, conic_out, radius_out, valid_out, colors_out or null,
        # the packed rows' [N, 12] out or null), per view 2 ints (width,
        # height), stream
        "e3d_preprocess_forward": [_P, _P, _P, _P, _P, _P, _L, _P, _L, _I,
                                   _P, _I, _I, _F, _I, _P, _P, _P],
        # means, scales, rotations, features_dc, its row stride,
        # features_rest, its row stride, K, mask, SH degree, n,
        # scaling_modifier, views, per view 9 pointers (world_view,
        # full_proj, camera_center, tan_fovx, tan_fovy, valid, the
        # gradients of mean2d, conic and colors, each or null), per view 5
        # ints (width, height, the gradients' row strides), g_means_out,
        # g_scales_out, g_rotations_out, the [N, K, 3] g_features_out (both
        # leaves' gradients) and its row stride, stream
        "e3d_preprocess_backward": [_P, _P, _P, _P, _L, _P, _L, _I, _P, _I,
                                    _I, _F, _I, _P, _P, _P, _P, _P, _P, _L,
                                    _P],
        # registers, blocks per SM, backward (0 or 1), SH degree, K
        "e3d_preprocess_occupancy": [_IP, _IP, _I, _I, _I],
    },
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
        # registers, blocks per SM, num_tiles (0: no count rows)
        "e3d_expand_occupancy": [_IP, _IP, _I],
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
        # only in the build with E3D_CLOCK (tools/kernel_probes.py):
        # e3d_composite_forward's arguments, then the int64 [num_tiles, 2]
        # block clock (%globaltimer at entry and exit), stream
        "e3d_composite_forward_clock": [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                        _P, _P, _P, _P],
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
        # rows (9 floats each), n_rows, dest, starts, ends, n_seg, limit,
        # order, out, [n_seg, 2] int32 range scratch, stream
        "e3d_segment_sums_by_output": [_P, _I, _P, _P, _P, _I, _I, _P, _P,
                                       _P, _P],
        # only in the build with E3D_K3_BALANCED (tools/kernel_timing.py):
        # rows (9 floats each), n_rows, dest, starts, ends, n_seg, limit,
        # order, out, int32 scratch, its length, stream
        "e3d_segment_sums_balanced": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                                      _I, _P],
    },
    "adam": {
        # per segment 9 pointers (p, g, m, v, p_out, m_out, v_out, lr or
        # null, count), per segment 3 int64 (floats, row width, g's row
        # stride), per segment the float learning rate, segments, b1,
        # 1 - b1, b2, 1 - b2, eps, stream
        "e3d_adam_update": [_P, _P, _P, _I, _F, _F, _F, _F, _F, _P],
    },
    "loss": {
        # operands (a host array of 15 pointers: per render now, next, main
        # its rgb or image [P, 3] and its log T [P] or null, the background
        # [3] or null, per GT operand gt_now, gt_next, gt_main, blurry its
        # image [P, 1 or 3] or stack and its [1] int64 index or null), sizes
        # (12 host int64: per GT operand channels, frames, frame stride), P,
        # the constants (11 host floats: losses/event.loss_constants),
        # contrast, partials scratch, its rows, loss_out, aux_out (4
        # floats), stream
        "e3d_event_loss_forward": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
        # the forward's operands, sizes, P and constants, contrast, the
        # loss's gradient, the forward's coverage, partials scratch, its
        # rows, the gradients (a host array of 6 pointers: per render d rgb
        # or d image, d log T or null), g_contrast, stream
        "e3d_event_loss_backward": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                                    _P, _P],
        # x, y, n: the kernels' logf and expf (for the card tests), stream
        "e3d_event_loss_logf": [_P, _P, _L, _P],
        "e3d_event_loss_expf": [_P, _P, _L, _P],
    },
    "ssim": {
        # operands (a host array of 5 pointers: the render's rgb or image
        # [P, 3], its log T [P] or null, the background [3] or null, the GT
        # image [P, 1 or 3] or stack, its [1] int64 index or null), sizes (3
        # host int64: the GT's channels, frames, frame stride), H, W, gray,
        # the constants (19 host floats: losses/modes.photometric_constants),
        # partials scratch, its rows, loss_out, l1_out, the derivative maps
        # [3, P, C] or null, stream
        "e3d_photometric_loss_forward": [_P, _P, _I, _I, _I, _P, _P, _I, _P,
                                         _P, _P, _P],
        # the forward's operands, sizes, H, W, gray and constants, the
        # loss's gradient, the maps (or null where lambda is 0), d rgb or
        # d image, d log T or null, stream
        "e3d_photometric_loss_backward": [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                          _P, _P],
        # rows (out), H, W, gray: the forward's partials rows at H × W
        "e3d_photometric_partials_rows": [_IP, _I, _I, _I],
        # backward (0 or 1), gray (0 or 1)
        "e3d_photometric_occupancy": [_IP, _IP, _I, _I],
        # bytes (out), backward, gray: a block's static + dynamic shared
        # memory with lambda > 0
        "e3d_photometric_shared_bytes": [_IP, _I, _I],
    },
    "probes": {
        # x, capacity (blocks of 1,024 floats), n (a device int), partials
        # scratch, arrival counter, out, stream
        "e3d_dyngrid_sum": [_P, _I, _P, _P, _P, _P, _P],
    },
}

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)
_MACRO = re.compile(r"[A-Z][A-Z0-9_]*(=[0-9]+)?")


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


def _defines(defines) -> tuple[str, ...]:
    defines = tuple(defines)
    for d in defines:
        if not _MACRO.fullmatch(d):
            raise ValueError(f"not a macro name: {d!r}")
    return defines


def library_path(name: str, defines=()) -> Path:
    """The cached library of source ``name`` built with the ``-D`` macros
    ``defines`` (none: the shipping library)."""
    defines = _defines(defines)
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if not defines:
        return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"
    h.update(b"\0" + " ".join(f"-D{d}" for d in defines).encode())
    return BUILD_DIR / f"lib{name}+{'+'.join(defines)}_{h.hexdigest()[:12]}.so"


def build_key(name: str, defines=()) -> str:
    """How :func:`build` names a build in its report: the source, and its
    macros after a ``+`` each."""
    return "+".join((name,) + _defines(defines))


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    An entry of ``names`` is a source name (the shipping build) or a
    ``(name, macros)`` pair.  One ``nvcc`` per build,
    all started together.  Returns, per build (:func:`build_key`), what
    the compiler reported (``-Xptxas -v``: registers, shared memory,
    spills of each kernel), or the saved report of an earlier build.
    Raises if any compile fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    builds = [(n, ()) if isinstance(n, str) else (n[0], _defines(n[1]))
              for n in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, macros in builds:
        out = library_path(name, macros)
        if out.exists() or out in procs:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[out] = (build_key(name, macros), tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in macros), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for out, (key, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {build_key(n, m): library_path(n, m).with_suffix(".log").read_text()
            for n, m in builds}


def function(name: str, fn: str, defines=()):
    """The bound C launch function ``fn`` of source ``name`` built with the
    macros ``defines`` (built on first use)."""
    defines = _defines(defines)
    lib = _loaded.get((name, defines))
    if lib is None:
        path = library_path(name, defines)
        if not path.exists():
            build([(name, defines)])
        lib = ctypes.CDLL(str(path))
        _loaded[(name, defines)] = lib
    argtypes = SIGNATURES[name].get(fn)
    if argtypes is None:
        raise KeyError(f"{fn}: not a C function of {build_key(name, defines)}")
    f = getattr(lib, fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def occupancy(name: str, fn: str, *args, defines=()) -> tuple[int, int]:
    """(registers per thread, resident blocks per SM) of the kernel that
    the C function ``fn`` of source ``name`` (built with ``defines``)
    reports on; ``args`` follow the two outputs."""
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = function(name, fn, defines)(ctypes.byref(regs), ctypes.byref(blocks),
                                      *args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {err}")
    return regs.value, blocks.value


def launch(name: str, fn: str, *args, defines=()) -> None:
    """Call a launch function (of the build with ``defines``) on the
    current stream; raise on its error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = function(name, fn, defines)(*args, stream)
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
