"""Timing of the port's kernels on a CUDA card: the helpers and the
bound arithmetic that ``chip_smoke.py`` and ``tools/kernel_probes.py``
use, ``bench.py``'s scene and training state, and the tile binning from the
projection's outputs, one source tree against another, in turns:

    python3 event3dgs_tpu_torch/tools/kernel_timing.py --trees OLD . . OLD

Each tree (a checkout of this repository) runs in a fresh process, in the
order given, with the tree first on ``sys.path``: it builds the tree's
kernels, projects ``bench.py``'s scene (100k Gaussians from seed 0,
cameras at ``bench.py``'s poses, 1920×1080) and bins it with the tree's
``binning.bin_gaussians`` at the render view (camera 0, instance cap
800,768) and at the train step's main view (camera 1, cap 428,032): every
device kernel from the projection's outputs to the finished ``Binning``.
Per view it prints one JSON line: the device time per call of each device
kernel and in all (``torch.profiler``, 20 calls), the device kernels per
call, the event time per call (CUDA events over 50 calls, the host's
enqueue included) and a digest of the ``Binning``, which must agree
between trees; before them, what ``-Xptxas -v`` reported for the tree's
K1, K2 and K4 (registers, spill bytes, shared memory).  The last lines are
the card's name and power limit and a table of the runs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np

VIEWS = (("render", 0, 800_768), ("train", 1, 428_032))
N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1920, 1080

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM FP32 outside the tensor cores is 67 TFLOP/s with an FMA counted
# as two operations.  The kernels are built with -fmad=false, so they issue
# no FMA: one FP32 instruction is one operation, at half that rate.
PEAK_FP32_PER_S = 33.5e12
# exp, log and reciprocal run on the special function units: 16 of an SM's
# 128 lanes per clock, so an eighth of the FP32 instruction rate
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 8
# (FP32, SFU) operations per (pixel, instance) pair a compositing kernel
# visits, by what it does with the pair: skipped at power > 0, skipped at
# raw < 1/255, composited.  Counted from the sources' arithmetic
# (rasterize_fwd.cu, rasterize_bwd.cu), an expf, log1pf or division as one
# SFU operation and nothing more, and an explicit FMA as one FP32
# instruction, so the bound stays a lower bound.  The bound charges the
# composited pairs only (the work the function needs).
K1_PAIR_OPS = ((10, 0), (12, 1), (23, 3))
K2_PAIR_OPS = ((10, 0), (12, 1), (38, 4))
COMPOSITED = 2  # index of the composited pairs in the tables and counts
# the kernels whose -Xptxas -v report the tree comparison prints
PTXAS_KERNELS = (("rasterize_fwd", "composite_forward_kernel"),
                 ("rasterize_bwd", "composite_backward_kernel"),
                 ("expand", "expand_kernel"))


def pair_ops(pairs, table, kinds=(COMPOSITED,)):
    """(FP32, SFU) operations of the pairs of ``kinds`` (counts by kind, as
    ``rasterize_tiled._composite_plain`` returns them)."""
    return (sum(pairs[k] * table[k][0] for k in kinds),
            sum(pairs[k] * table[k][1] for k in kinds))


def bound_ms(nbytes, ops):
    """The least time for ``nbytes`` moved and (FP32, SFU) ``ops``, and
    which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    # the FP32 lanes and the SFUs work side by side
    t_ops = max(ops[0] / PEAK_FP32_PER_S, ops[1] / PEAK_SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def composite_bytes(live: int, n: int, num_tiles: int, width: int,
                    height: int, backward: bool = False) -> int:
    """Bytes K1 (or K2) must move: the live instance ids, the packed
    feature rows, the tile offsets and counts; K1 writes rgb, log T and the
    stop index, K2 reads those and the two upstream gradients and writes
    nine floats per live instance."""
    common = live * 4 + n * 48 + num_tiles * 8
    if not backward:
        return common + width * height * 20
    return common + width * height * 24 + live * 9 * 4


def expansion_bytes(offsets, cap: int, num_tiles: int,
                    count_rows: bool = True) -> int:
    """Bytes K4 must move at its depth offsets ``offsets`` [N+1]: per live
    rank (one with slots under the cap) its 48-byte table row, order entry
    and offset; 8 bytes per slot; with ``count_rows`` each live segment's
    row of tile counts."""
    from event3dgs_tpu_torch.ops.sort_tiles import SEGMENT

    off = offsets.long()
    capped = min(int(off[-1]), cap)
    live_ranks = int(((off[:-1] < capped) & (off[1:] > off[:-1])).sum())
    rows = -(-capped // SEGMENT) * num_tiles * 4 if count_rows else 0
    return live_ranks * (48 + 4 + 4) + cap * 8 + rows


def segment_sums_bytes(live: int, slots: int, n: int) -> int:
    """Bytes K3 must move: the live rows, the slots' destinations, the
    offsets and order, the [N, 9] sums."""
    return live * 9 * 4 + slots * 4 + (n + 1) * 4 + n * 4 + n * 9 * 4


def ptxas_report(log: str, kernel: str) -> dict:
    """What ``-Xptxas -v`` reported for ``kernel`` in a build's log:
    registers, spill stores and loads (bytes), shared memory (bytes)."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and re.search(
                rf"\d{kernel}E", line):
            text = " ".join(lines[k + 1:k + 4])
            num = lambda pat: int(m.group(1)) if (
                m := re.search(pat, text)) else 0
            return {"registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "smem": num(r"(\d+) bytes smem")}
    raise ValueError(f"no -Xptxas -v report of {kernel}")


def bench_scene(rng, n: int = N_GAUSSIANS):
    """bench.py's scene (`_scene`) from ``rng``: means, scales, rotations,
    opacities, colors."""
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)]
    scales = (np.exp(rng.uniform(np.log(0.005), np.log(0.03), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    return means, scales, rots, opac, colors


def bench_camera(i: int, width: int, height: int, device):
    """bench.py's camera i: identity rotation, translation (0.01·i, 0,
    0.02·i), fov 1.2 × 0.75."""
    from event3dgs_tpu_torch.core import make_camera

    return make_camera(np.eye(3), np.asarray([0.01 * i, 0.0, 0.02 * i]), 1.2,
                       0.75, width, height, device=device)


def bench_state(device, n: int = N_GAUSSIANS, width: int = WIDTH,
                height: int = HEIGHT):
    """bench.py's `bench_train_step` set-up: (state, data, measured
    instance cap): ``n`` Gaussians of its scene from seed 0 at its scales,
    rotations and opacities, 4 cameras, random images from seed 1, event
    mode's data, ``spatial_lr_scale`` 3.0."""
    import torch

    from event3dgs_tpu_torch.core.camera import stack_cameras
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.models.gaussians import GaussianParams
    from event3dgs_tpu_torch.train import SceneData, init_train_state
    from event3dgs_tpu_torch.train.loop import measure_instance_cap

    means, scales, rots, opac, colors = bench_scene(np.random.default_rng(0), n)
    cameras = stack_cameras([bench_camera(i, width, height, device)
                             for i in range(4)])
    images = torch.tensor(np.random.default_rng(1).uniform(
        0, 1, (4, height, width, 3)), dtype=torch.float32, device=device)
    params = init_from_point_cloud(means, colors, capacity=n, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    params = GaussianParams(
        xyz=params.xyz, features_dc=params.features_dc,
        features_rest=params.features_rest, scaling=f32(np.log(scales)),
        rotation=f32(rots), opacity=f32(np.log(opac / (1 - opac))[:, None]),
        alive=params.alive)
    state = init_train_state(params, spatial_lr_scale=3.0)
    data = SceneData(cameras=cameras, images=images, event_cameras=cameras,
                     event_images=images)
    return state, data, measure_instance_cap(state.params, cameras)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn`` between CUDA events around ``iters``
    calls (the host's enqueue included when it is the longer)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean time per call of ``fn`` captured ``launches`` times in one CUDA
    graph and replayed: the device's time without the host's enqueue (a
    call may allocate, from the graph's own pool, but not synchronise)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays, warmup=1) / launches


def kernel_name(key: str) -> str:
    """A device kernel's function name from the profiler's key (namespaces,
    template arguments and parameters stripped); other keys as they are."""
    key = key.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?([\w:]+?)(?:<.*>)?\(", key)
    return m.group(1).split("::")[-1] if m else key


def device_profile(fn, calls: int = 20) -> dict[str, tuple[float, float]]:
    """{device kernel name: (self device ms per call, launches per call)}
    over ``calls`` calls of ``fn`` after one warm-up call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, tuple[float, float]] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(kernel_name(e.key), (0.0, 0.0))
            out[kernel_name(e.key)] = (ms + us / 1e3 / calls, n + e.count / calls)
    return out


def per_launch_ms(prof, functions) -> float:
    """Device ms of one call that launches each of ``functions`` once, from
    :func:`device_profile`'s ``prof``: each function's time over the
    launches the profiler saw of it.  Late in a long process the profiler
    records only some of the launches, and its ms per call then falls
    short of the kernel's time (chip_smoke's phases 8 and 12, NVIDIA H100
    80GB HBM3, 700 W)."""
    return sum(prof[f][0] / prof[f][1] for f in functions)


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_timing: needs a CUDA card")
    from event3dgs_tpu_torch.ops import binning, kernels
    from event3dgs_tpu_torch.ops.projection import project_gaussians

    logs = kernels.build()
    print(json.dumps({"tree": tree, "ptxas": {
        f"{name}:{kernel}": ptxas_report(logs[name], kernel)
        for name, kernel in PTXAS_KERNELS}}), flush=True)
    dev = torch.device("cuda")
    n = N_GAUSSIANS
    means, scales, rots, opac, _ = bench_scene(np.random.default_rng(0), n)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    opacities = f(opac)
    fields = ("inst_gauss", "tile_offsets", "tile_counts", "dest", "overflow",
              "offsets", "order")
    for view, i, cap in VIEWS:
        cam = bench_camera(i, WIDTH, HEIGHT, dev)
        proj = project_gaussians(f(means), f(scales), f(rots), cam,
                                 opacities=opacities)
        call = lambda: binning.bin_gaussians(
            proj.mean2d, proj.depth, proj.radius, proj.valid, WIDTH, HEIGHT,
            cap, opacities=opacities, conic=proj.conic)
        out = call()
        digest = 0
        for field in fields:
            digest = zlib.crc32(getattr(out, field).cpu().numpy().tobytes(),
                                digest)
        prof = device_profile(call)
        print(json.dumps({
            "tree": tree, "view": view, "cap": cap,
            "live": int(out.offsets[n]), "digest": digest,
            "device_us": {k: round(v[0] * 1e3, 3) for k, v in sorted(prof.items())},
            "device_us_total": sum(v[0] for v in prof.values()) * 1e3,
            "device_ops": sum(v[1] for v in prof.values()),
            "event_ms": cuda_ms(call, 50),
        }), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", required=True)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    rows = []
    for tree in args.trees:
        tree = str(Path(tree).resolve())
        out = subprocess.run([sys.executable, __file__, "--trees", tree,
                              "--worker", tree], capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"kernel_timing: {tree} failed", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line)
            if line.startswith("{") and "view" in json.loads(line):
                rows.append(json.loads(line))
    for view, _, _ in VIEWS:
        digests = {r["digest"] for r in rows if r["view"] == view}
        if len(digests) != 1:
            print(f"kernel_timing: the trees' outputs differ at the {view} view",
                  file=sys.stderr)
            return 1
    print(card())
    print("view    run tree                              device us  ops  event ms")
    for k, r in enumerate(rows):
        print(f"{r['view']:7s} {k // len(VIEWS) + 1:3d} {r['tree'][-32:]:32s} "
              f"{r['device_us_total']:10.3f} {r['device_ops']:4.0f} "
              f"{r['event_ms']:9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
