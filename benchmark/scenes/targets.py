"""Training targets consistent with the scene: the plain reference's render
of the configuration's world at each pose, quantized to 8 bits as a
capture is (gray configurations: the luma, in three equal channels).

A scene trained against targets it cannot match moves fast and changes the
work of every step as it goes; one past its densify window has converged
on its captures, and its residuals are noise.  So the training cells train
a world of their own, fixed by the cell's ``world_seed``, on its own
renders: the seed of a run picks the views and Adam's state.  The renders
take the reference about half a second a pose at the cells' sizes, so the
first run of a checkout renders them once and keeps them, 8 bits a value,
under ``.bench_cache/targets/`` in the checkout (a fixed path; the name
carries the configuration's digest); later runs read them.  Program and
reference read the same file.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

from benchmark.reference import splats
from benchmark.scenes import recipes

LUMA = (0.299, 0.587, 0.114)


def cache_path(root: Path, cfg: dict, world_seed: int) -> Path:
    digest = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:12]
    return root / ".bench_cache" / "targets" / f"{cfg['name']}-w{world_seed}-{digest}.pt"


@torch.no_grad()
def render_targets(cfg: dict, world_seed: int, device) -> torch.Tensor:
    """[V, H, W, C] uint8 renders of the world at every pose (C = 1 in
    gray configurations, else 3), over a black background."""
    raw = recipes.cloud(cfg, world_seed, device)
    views = recipes.views(cfg, device)
    bg = torch.zeros(3, device=device)
    gray = bool(cfg["frames"]["gray"])
    out = []
    for i in range(len(views)):
        img = splats.render(raw, splats.camera(views, i), bg)
        if gray:
            img = (img * img.new_tensor(LUMA)).sum(-1, keepdim=True)
        out.append(torch.round(img.clamp(0, 1) * 255).to(torch.uint8).cpu())
    return torch.stack(out)


def targets(root: Path, cfg: dict, world_seed: int, device) -> torch.Tensor:
    """[V, H, W, 3] float32 targets on ``device``, rendered once per
    checkout and read from the cache after that."""
    path = cache_path(Path(root), cfg, world_seed)
    if path.exists():
        u8 = torch.load(path, weights_only=True)
    else:
        u8 = render_targets(cfg, world_seed, device)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(u8, tmp)
        os.replace(tmp, path)
        if torch.device(device).type == "cuda":
            # the reference's renders are no part of the program's peak: what
            # they leave allocated (cuBLAS keeps its workspaces) is freed, so
            # the peak reads as in a run that finds the cache
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    img = u8.to(device).to(torch.float32) / 255.0
    return img.expand(-1, -1, -1, 3).contiguous() if img.shape[-1] == 1 else img
