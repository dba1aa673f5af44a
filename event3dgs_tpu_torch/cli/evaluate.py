"""Evaluation entry point (counterpart of ``event3dgs_tpu/cli/evaluate.py``;
reference `eval.py:217-250`).

    python -m event3dgs_tpu_torch.cli.evaluate -m <model> [--iteration N]
        [--lpips_weights x.npz] [--save_images] [--e2vid <folder>]
        [--rasterizer tiled|reference] [--device cuda|cpu]

Evaluates on the manual holdout views {5, 25, 45, 65, 85} against the
`renders/` ground-truth folder, gray-converted, printing SSIM/PSNR (and
LPIPS when weights are configured) like `eval.py:152`.  Runs on the CUDA
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from event3dgs_tpu_torch.cli.common import claim_accelerator, load_trained_model
from event3dgs_tpu_torch.data.scene import (
    build_camera_batch,
    load_images_array,
    read_colmap_scene,
)
from event3dgs_tpu_torch.losses.basic import psnr, ssim
from event3dgs_tpu_torch.tools.evaluation import evaluate_holdout, gray3
from event3dgs_tpu_torch.train.loop import TEST_VIEW_INDICES
from event3dgs_tpu_torch.utils.device import resolve_device
from event3dgs_tpu_torch.utils.image_io import load_image_f32


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate a trained model")
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--save_images", action="store_true")
    p.add_argument(
        "--e2vid", type=str, default=None,
        help="score an external intensity-reconstruction folder instead of "
             "rendering (reference eval.py --e2vid mode)",
    )
    p.add_argument(
        "--rasterizer", type=str, default="tiled",
        choices=["tiled", "reference"],
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def score_external(folder: str, gt: np.ndarray, device) -> tuple[float, float]:
    """Mean SSIM/PSNR of an external reconstruction (e.g. E2VID output) at
    the holdout indices, its files taken in sorted order (`eval.py:123-152`)."""
    names = sorted(os.listdir(folder))
    ssims, psnrs = [], []
    for idx in TEST_VIEW_INDICES:
        if idx >= len(names) or idx >= gt.shape[0]:
            continue
        rec = torch.as_tensor(load_image_f32(os.path.join(folder, names[idx])),
                              device=device)
        g = gray3(torch.as_tensor(gt[idx], device=device))
        r = gray3(rec)
        ssims.append(float(ssim(r, g)))
        psnrs.append(float(psnr(r, g)))
    return float(np.mean(ssims)), float(np.mean(psnrs))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    claim_accelerator(device)
    cfg, _, params = load_trained_model(args.model_path, args.iteration, device)
    m = cfg.model

    info = read_colmap_scene(m.source_path, images_dir=m.images, gray=m.gray,
                             deblur=m.deblur, event=m.event)
    if not info.test_cameras:
        print("no renders/ ground-truth folder found — nothing to evaluate")
        return 1
    gt = load_images_array(info.test_cameras, m.resolution, m.white_background)

    if args.e2vid:
        s, p = score_external(args.e2vid, gt, device)
        print(f"[SSIM {s:.4f} PSNR {p:.2f}] (e2vid)")
        return 0

    cams = build_camera_batch(info.test_cameras, m.resolution, device=device)
    bg = (torch.ones if m.white_background else torch.zeros)(3, device=device)
    out = evaluate_holdout(
        params, cams, gt, sh_degree=m.sh_degree, background=bg,
        save_dir=os.path.join(args.model_path, "images")
        if args.save_images else None,
        lpips_weights=args.lpips_weights,
        rasterizer=args.rasterizer,
    )
    lp = f" LPiPS {out['LPIPS']:.4f}" if "LPIPS" in out else ""
    print(f"[SSIM {out['SSIM']:.4f} PSNR {out['PSNR']:.2f}{lp}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
