"""The system under test's side of the harness: the port's objects made
from the benchmark's scene tensors, and the port's kernels built.

This is the one module of the harness, with the traffic drivers, that
imports ``event3dgs_tpu_torch``; the reference, the counts and the scenes
import none of it.
"""

from __future__ import annotations

import torch

from benchmark.scenes.recipes import Views


def build_kernels(sources, device) -> None:
    """Build the port's kernel libraries ``sources`` (``csrc/<name>.cu``)
    that are not built yet, in parallel, into the port's fixed
    ``csrc/build/`` inside the checkout (on a card; the CPU runs the
    kernels' plain versions)."""
    from event3dgs_tpu_torch.ops import kernels

    if torch.device(device).type == "cuda":
        kernels.build(list(sources))


def cameras(v: Views):
    """The port's batched ``Camera`` of the benchmark's views."""
    from event3dgs_tpu_torch.core.camera import Camera

    return Camera(world_view=v.world_view, full_proj=v.full_proj,
                  camera_center=v.center, tan_fovx=v.tan_fovx,
                  tan_fovy=v.tan_fovy, width=v.width, height=v.height)


def gaussians(raw: dict):
    """The port's ``GaussianParams`` of the raw parameters (every slot
    alive); the tensors are the port's own from here on."""
    from event3dgs_tpu_torch.models.gaussians import GaussianParams

    n = raw["xyz"].shape[0]
    return GaussianParams(alive=torch.ones(n, dtype=torch.bool,
                                           device=raw["xyz"].device), **raw)
