"""Gaussian splatting ops, differentiable.

- ``projection``: frustum cull + EWA 3D→2D covariance projection
- ``preprocess``: the projection and the SH colours of up to three views,
  and the tiled rasterizer's packed rows, as one forward and one backward
  CUDA kernel, and the autograd Function around them
- ``binning``: per-tile depth-ordered instance lists (kernels K4, K5, K6
  in ``expand`` and ``sort_tiles``)
- ``rasterize_tiled``: forward compositing (kernel K1), backward
  compositing (K2) and the autograd Function around them
- ``segscan``: per-Gaussian gradient sums (kernel K3)
- ``rasterize_reference``: slow compositing oracle
- ``render``: camera + model → image
- ``kernels``: build and bind the CUDA sources of ``csrc/``
"""

from event3dgs_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from event3dgs_tpu_torch.ops.rasterize_reference import rasterize_reference
from event3dgs_tpu_torch.ops.render import (
    RenderOutput,
    RenderPartials,
    render,
    render_depth,
    render_partials,
)

__all__ = [
    "ProjectedGaussians",
    "project_gaussians",
    "rasterize_reference",
    "render",
    "render_depth",
    "render_partials",
    "RenderOutput",
    "RenderPartials",
]
