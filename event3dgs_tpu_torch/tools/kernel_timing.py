"""Timing of the port's kernels on a CUDA card: the helpers
``chip_smoke.py`` uses, and the tile binning from the projection's outputs,
one source tree against another, in turns:

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
between trees.  The last lines are the card's name and power limit and a
table of the runs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import zlib
from pathlib import Path

VIEWS = (("render", 0, 800_768), ("train", 1, 428_032))
N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1920, 1080


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


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_timing: needs a CUDA card")
    from event3dgs_tpu_torch.core import make_camera
    from event3dgs_tpu_torch.ops import binning, kernels
    from event3dgs_tpu_torch.ops.projection import project_gaussians

    kernels.build()
    dev = torch.device("cuda")
    # bench.py's scene (`_scene`)
    rng = np.random.default_rng(0)
    n = N_GAUSSIANS
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)]
    scales = (np.exp(rng.uniform(np.log(0.005), np.log(0.03), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    opacities = f(opac)
    fields = ("inst_gauss", "tile_offsets", "tile_counts", "dest", "overflow",
              "offsets", "order")
    for view, i, cap in VIEWS:
        cam = make_camera(np.eye(3), np.asarray([0.01 * i, 0.0, 0.02 * i]),
                          1.2, 0.75, WIDTH, HEIGHT, device=dev)
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
            if line.startswith("{"):
                rows.append(json.loads(line))
    for view, _, _ in VIEWS:
        digests = {r["digest"] for r in rows if r["view"] == view}
        if len(digests) != 1:
            print(f"kernel_timing: the trees' outputs differ at the {view} view",
                  file=sys.stderr)
            return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print("view    run tree                              device us  ops  event ms")
    for k, r in enumerate(rows):
        print(f"{r['view']:7s} {k // len(VIEWS) + 1:3d} {r['tree'][-32:]:32s} "
              f"{r['device_us_total']:10.3f} {r['device_ops']:4.0f} "
              f"{r['event_ms']:9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
