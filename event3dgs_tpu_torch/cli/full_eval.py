"""Full evaluation: train → render → evaluate → metrics across scenes
(counterpart of ``event3dgs_tpu/cli/full_eval.py``; reference
`full_eval.py:15-75`).  Calls the other entry points in one process.

    python -m event3dgs_tpu_torch.cli.full_eval --scenes <dir1> <dir2> \\
        --output_path ./eval [--gray --event] [--skip_training] ...
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from event3dgs_tpu_torch.cli import evaluate, metrics, render, train
from event3dgs_tpu_torch.utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="Train+render+metrics over scenes")
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--output_path", default="./eval")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--gray", action="store_true")
    p.add_argument("--event", action="store_true")
    p.add_argument("--deblur", action="store_true")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, passed on to each step")
    args = p.parse_args(argv)
    resolve_device(args.device)
    dev = ["--device", args.device]

    model_paths = []
    for scene in args.scenes:
        name = os.path.basename(os.path.normpath(scene))
        model_path = os.path.join(args.output_path, name)
        model_paths.append(model_path)
        if not args.skip_training:
            argv_train = [
                "-s", scene, "-m", model_path,
                "--iterations", str(args.iterations), "--quiet", *dev,
            ]
            for flag in ("gray", "event", "deblur"):
                if getattr(args, flag):
                    argv_train.append(f"--{flag}")
            print(f"=== training {name}")
            train.main(argv_train)
        if not args.skip_rendering:
            print(f"=== rendering {name}")
            render.main(["-m", model_path, *dev])
        if not args.skip_metrics:
            print(f"=== evaluating {name}")
            evaluate.main(["-m", model_path, *dev])
    if not args.skip_metrics:
        metrics.main(["-m", *model_paths, *dev])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
