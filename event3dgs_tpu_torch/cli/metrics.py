"""Offline metrics over render folders (counterpart of
``event3dgs_tpu/cli/metrics.py``; reference `metrics.py:104-143`).

    python -m event3dgs_tpu_torch.cli.metrics -m <model_path> [<model_path> ...]
        [--lpips_weights x.npz] [--device cuda|cpu]

Scores every ``<model>/test/<method>/renders`` against its ``gt`` folder
and writes ``results.json`` and ``per_view.json`` into the model folder.
"""

from __future__ import annotations

import argparse
import os

from event3dgs_tpu_torch.tools.evaluation import metrics_over_dirs
from event3dgs_tpu_torch.utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute SSIM/PSNR/LPIPS")
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    for model_path in args.model_paths:
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print(f"{model_path}: no test/ directory, skipping")
            continue
        for method in sorted(os.listdir(test_dir)):
            base = os.path.join(test_dir, method)
            renders, gt = os.path.join(base, "renders"), os.path.join(base, "gt")
            if not (os.path.isdir(renders) and os.path.isdir(gt)):
                continue
            results = metrics_over_dirs(
                renders, gt, out_dir=model_path,
                lpips_weights=args.lpips_weights, device=device,
            )
            print(f"{model_path}/{method}:")
            for k, v in results.items():
                print(f"  {k}: {v:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
