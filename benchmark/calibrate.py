"""Readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out <file>]

With ``--scene-stats SEED`` it prints instead, for each of the
configuration's views, the (tile, Gaussian) instances that the reference's
binning lists, and their share per splat, at that seed.

For each of ``--seeds`` the program's numbers (set-up, which drives the
compared steps, then the check), the lower readings; for each of
``--control-seeds`` the control's (the reference in bfloat16 in the
program's place) and the fault's that a run can plant in the reference put
in its place (the loss over half the pixels), the upper readings.  One JSON
line each, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import torch

from benchmark import run


@torch.no_grad()
def scene_stats(cfg, seed: int, dev) -> int:
    from benchmark.reference import splats
    from benchmark.scenes import recipes

    raw = recipes.cloud(cfg, seed, dev)
    views = recipes.views(cfg, dev)
    means, _, opac, scales, rots = splats.activated(raw)
    n = means.shape[0]
    counts = []
    for i in range(len(views)):
        cam = splats.camera(views, i)
        p = splats.project(means, scales, rots, opac, cam)
        counts.append(int(splats.tile_lists(p, opac, cam.width, cam.height).count.sum()))
    print(json.dumps({"config": cfg["name"], "seed": seed, "slots": n,
                      "instances": counts,
                      "per_splat": [c / n for c in counts]}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--scene-stats", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    bench = run.manifest()
    _, wl, cfg = run.cell(bench, args.workload)
    dev = torch.device("cuda", 0)
    if args.scene_stats is not None:
        return scene_stats(cfg, args.scene_stats, dev)
    mod = importlib.import_module(f"benchmark.traffic.{wl['traffic']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    runs = [(s, "program") for s in seeds] + [
        (s, k) for s in controls for k in ("control", "fault")]
    for seed, kind in runs:
        h = run.Harness(cfg, wl, seed, dev, run.Tracer(False))
        d = mod.Driver(h)
        if kind == "program":
            d.setup()
            d.release()
            checks = d.check()
        elif kind == "control":
            checks = d.control()
        else:
            checks = d.control(dtype=torch.float32, half=True)
        line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                           **{c.name: c.value for c in checks}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del d, h
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
