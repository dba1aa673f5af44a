"""Evaluation protocol + offline metrics (counterpart of
``event3dgs_tpu/tools/evaluation.py``; reference eval.py / metrics.py).

- :func:`evaluate_holdout`: the Event-3DGS protocol — render the manual
  test views {5, 25, 45, 65, 85}, grayscale both render and GT, report
  SSIM/PSNR/LPIPS means (`eval.py:118-152`).
- :func:`metrics_over_dirs`: the 3DGS `metrics.py` equivalent — score
  renders/ vs gt/ image folders into `results.json` / `per_view.json`
  (`metrics.py:36-103`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from event3dgs_tpu_torch.losses.basic import psnr, rgb_to_grayscale, ssim
from event3dgs_tpu_torch.losses.lpips import lpips_fn
from event3dgs_tpu_torch.models import activated
from event3dgs_tpu_torch.ops.render import render
from event3dgs_tpu_torch.train.loop import TEST_VIEW_INDICES
from event3dgs_tpu_torch.utils.image_io import load_image_f32, save_image


def gray3(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] → its grayscale repeated to 3 channels, as `eval.py:132-137`
    stacks the gray channel."""
    return rgb_to_grayscale(img).repeat(1, 1, 3)


@torch.no_grad()
def evaluate_holdout(
    params,
    cameras,
    gt_images,
    sh_degree: int = 3,
    background=None,
    indices=TEST_VIEW_INDICES,
    save_dir: str | None = None,
    lpips_weights: str | None = None,
    rasterizer: str = "reference",
) -> dict:
    """Reference eval protocol on the manual holdout views.

    Renders each index on the device of ``params``, converts render and GT
    to grayscale (3-channel), computes SSIM/PSNR (and LPIPS when weights
    are available), optionally saves sim_/real_ pairs.  ``gt_images`` is a
    [V, H, W, 3] array or tensor.
    """
    dev = params.device
    act = activated(params)
    bg = torch.zeros(3, device=dev) if background is None else background
    lp = lpips_fn(lpips_weights, device=dev)

    ssims, psnrs, lpips_vals = [], [], []
    n_views = gt_images.shape[0]
    kept = [i for i in indices if i < n_views]
    for idx in kept:
        img = render(
            act.means3d, act.features, act.opacities, act.scales,
            act.rotations, cameras[idx], bg, sh_degree=sh_degree,
            rasterizer=rasterizer,
        ).image
        img = torch.clamp(img, 0.0, 1.0)
        gt = torch.clamp(torch.as_tensor(gt_images[idx], device=dev), 0.0, 1.0)
        img_g, gt_g = gray3(img), gray3(gt)
        ssims.append(float(ssim(img_g, gt_g)))
        psnrs.append(float(psnr(img_g, gt_g)))
        if lp is not None:
            lpips_vals.append(float(lp(img_g, gt_g)))
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            save_image(os.path.join(save_dir, f"sim_{idx:05d}.png"),
                       img_g.cpu().numpy())
            save_image(os.path.join(save_dir, f"real_{idx:05d}.png"),
                       gt_g.cpu().numpy())

    out = {
        "SSIM": float(np.mean(ssims)) if ssims else float("nan"),
        "PSNR": float(np.mean(psnrs)) if psnrs else float("nan"),
        "per_view_ssim": ssims,
        "per_view_psnr": psnrs,
        "indices": kept,
    }
    if lpips_vals:
        out["LPIPS"] = float(np.mean(lpips_vals))
    return out


@torch.no_grad()
def metrics_over_dirs(
    renders_dir: str,
    gt_dir: str,
    out_dir: str | None = None,
    lpips_weights: str | None = None,
    device=None,
) -> dict:
    """Score a renders/ vs gt/ folder pair (reference `metrics.py:36-103`)
    on ``device``."""
    names = sorted(os.listdir(renders_dir))
    lp = lpips_fn(lpips_weights, device=device)
    per_view = {"SSIM": {}, "PSNR": {}, "LPIPS": {}}
    for name in names:
        r = torch.as_tensor(load_image_f32(os.path.join(renders_dir, name)),
                            device=device)
        g = torch.as_tensor(load_image_f32(os.path.join(gt_dir, name)),
                            device=device)
        per_view["SSIM"][name] = float(ssim(r, g))
        per_view["PSNR"][name] = float(psnr(r, g))
        if lp is not None:
            per_view["LPIPS"][name] = float(lp(r, g))
    results = {
        k: float(np.mean(list(v.values()))) for k, v in per_view.items() if v
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(out_dir, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
    return results
