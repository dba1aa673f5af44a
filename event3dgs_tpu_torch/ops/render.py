"""High-level render entry points: model + camera → image.

Counterpart of ``event3dgs_tpu/ops/render.py``, mirroring the reference
renderer (`gaussian_renderer/__init__.py:20-104`): SH→RGB is evaluated
outside the rasterizer, colors are ``clamp_min(eval_sh + 0.5, 0)``, and
images are [H, W, 3] channel-last like the JAX package's.  Everything is
differentiable in the Gaussian parameters; a zero ``mean2d_tap`` with
``requires_grad`` added to the projected means collects the screen-space
mean gradient that densification reads (the reference's
``screenspace_points.grad``).  The projection, the tap's add, the SH
colours and the tiled rasterizer's packed rows run as one forward and one
backward kernel on the card
(:func:`~event3dgs_tpu_torch.ops.preprocess.preprocess`);
:func:`gaussian_colors` is their plain version's colour half.  A view
already projected (the train step projects its views in one call,
:func:`~event3dgs_tpu_torch.ops.preprocess.preprocess_views`) is
rasterized by :func:`rasterize_projected` and composed over its background
by :func:`composed`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.core.sh import sh_basis
from event3dgs_tpu_torch.ops.preprocess import preprocess
from event3dgs_tpu_torch.ops.projection import row_norm
from event3dgs_tpu_torch.ops.rasterize_reference import (
    rasterize_reference_partials,
)
from event3dgs_tpu_torch.ops.rasterize_tiled import rasterize_tiled_partials


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [H, W, 3]
    radii: torch.Tensor  # [N] pixel radii (0 for culled)
    visibility: torch.Tensor  # [N] bool, radius > 0


class RenderPartials(NamedTuple):
    """Pre-background compositing partials."""

    rgb: torch.Tensor  # [H, W, 3] accumulated color (no background)
    logt: torch.Tensor  # [H, W] log final transmittance
    radii: torch.Tensor  # [N]
    visibility: torch.Tensor  # [N] bool
    depth: torch.Tensor  # [N] view-space z (+inf for culled)


def gaussian_colors(sh_degree: int, features, means3d, camera_center):
    """View-dependent RGB from [N, K, 3] coefficient-major SH features:
    ``max(eval_sh + 0.5, 0)`` (reference `__init__.py:76-81`).  The
    direction's norm and the sum over the coefficients are taken in index
    order, as the forward kernel of ``ops/preprocess.py`` takes them."""
    dirs = means3d - camera_center[None, :]
    dirs = dirs / row_norm(dirs)
    basis = sh_basis(sh_degree, dirs)
    rgb = features[:, 0, :] * basis[:, 0, None]
    for k in range(1, basis.shape[-1]):
        rgb = rgb + features[:, k, :] * basis[:, k, None]
    return torch.clamp(rgb + 0.5, min=0.0)


def rasterize_projected(proj, colors, opacities, camera, rasterizer,
                        instance_cap=None, plain=False, feat=None):
    """Pre-background (rgb [H, W, 3], log T [H, W]) of one view whose
    Gaussians are projected (``proj``) and coloured (``colors`` [N, 3]);
    ``feat``, their packed rows from the preprocess (or None), goes to the
    tiled rasterizer, which packs its own without them."""
    if rasterizer == "tiled":
        return rasterize_tiled_partials(
            proj, colors, opacities, camera.width, camera.height,
            instance_cap=instance_cap, plain=plain, feat=feat,
        )
    if rasterizer == "reference":
        return rasterize_reference_partials(
            proj, colors, opacities, camera.width, camera.height
        )
    raise ValueError(f"unknown rasterizer {rasterizer!r}")


def composed(rgb, logt, background):
    """The image [H, W, 3] of pre-background partials over ``background``
    [3]."""
    return rgb + torch.exp(logt)[:, :, None] * background[None, None, :]


def _partials(means3d, features, opacities, scales, rotations, camera,
              sh_degree, scaling_modifier, mean2d_tap, override_colors,
              rasterizer, instance_cap, plain=False):
    # override colours: no features, so no packed rows either
    proj, colors, feat = preprocess(
        means3d, scales, rotations, camera, scaling_modifier=scaling_modifier,
        opacities=opacities,
        features=features if override_colors is None else None,
        sh_degree=sh_degree, plain=plain, mean2d_tap=mean2d_tap,
        packed=True)
    if override_colors is not None:
        colors = override_colors
    rgb, logt = rasterize_projected(proj, colors, opacities, camera,
                                    rasterizer, instance_cap, plain, feat)
    return rgb, logt, proj


def render(
    means3d: torch.Tensor,
    features: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    camera: Camera,
    background: torch.Tensor,
    sh_degree: int = 0,
    scaling_modifier: float = 1.0,
    mean2d_tap: torch.Tensor | None = None,
    override_colors: torch.Tensor | None = None,
    rasterizer: str = "reference",
    instance_cap: int | None = None,
    plain: bool = False,
) -> RenderOutput:
    """Render one view.

    Args:
        means3d: [N, 3]; features: [N, K, 3] SH coefficients; opacities: [N]
            activated; scales: [N, 3] activated; rotations: [N, 4].
        camera: a single camera; background: [3].
        mean2d_tap: optional [N, 2] zeros; its gradient is the screen-space
            mean gradient densification reads.
        rasterizer: "reference" (slow oracle) or "tiled" (the kernels).
        instance_cap: tiled rasterizer's instance budget (None: default).
        plain: run the plain versions of the preprocess and tiled
            rasterizer kernels on CUDA tensors too (for holding the kernels
            against them).
    """
    rgb, logt, proj = _partials(
        means3d, features, opacities, scales, rotations, camera, sh_degree,
        scaling_modifier, mean2d_tap, override_colors, rasterizer,
        instance_cap, plain,
    )
    return RenderOutput(image=composed(rgb, logt, background),
                        radii=proj.radius, visibility=proj.valid)


def render_partials(
    means3d, features, opacities, scales, rotations, camera: Camera,
    sh_degree: int = 0, scaling_modifier: float = 1.0, mean2d_tap=None,
    override_colors=None, rasterizer: str = "tiled",
    instance_cap: int | None = None,
) -> RenderPartials:
    """Render one view into pre-background (rgb, log T) partials."""
    rgb, logt, proj = _partials(
        means3d, features, opacities, scales, rotations, camera, sh_degree,
        scaling_modifier, mean2d_tap, override_colors, rasterizer,
        instance_cap,
    )
    return RenderPartials(rgb=rgb, logt=logt, radii=proj.radius,
                          visibility=proj.valid, depth=proj.depth)


def render_depth(means3d, opacities, scales, rotations, camera: Camera,
                 background, rasterizer: str = "reference") -> RenderOutput:
    """Alpha-composited camera-distance map (reference `render_depth`):
    colors are ``‖xyz − campos‖ + 0.5`` on all three channels."""
    dist = torch.linalg.norm(means3d - camera.camera_center[None, :], dim=-1,
                             keepdim=True)
    colors = torch.clamp(dist + 0.5, min=0.0).expand(-1, 3)
    dummy = means3d.new_zeros(means3d.shape[0], 1, 3)
    return render(means3d, dummy, opacities, scales, rotations, camera,
                  background, sh_degree=0, override_colors=colors,
                  rasterizer=rasterizer)
