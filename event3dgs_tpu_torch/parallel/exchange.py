"""Exact Gaussian-sharded rendering via per-view projected-splat exchange.

Counterpart of ``event3dgs_tpu/parallel/exchange.py``.  The reference
composites every Gaussian of a view in one global per-view depth order;
merging image partials of statically partitioned shards can only
approximate that on orbit rigs (``parallel.compose``).  This is the exact
path.  Storage stays sharded (parameters, Adam moments and densify stats
keep C/K rows per rank and are never gathered), and the view-space splats
are exchanged per view:

1. Each rank projects its Gaussians for every view of its ``gauss`` group
   (K small projections, the preprocess kernels of ``ops/preprocess.py``
   on the card) and packs the per-splat raster inputs (mean2d,
   depth, conic, radius, valid, color) into one [K, C/K, 11] tensor.
2. One all_to_all over the group turns "my Gaussians, all views" into "all
   Gaussians, my view": the received chunks stack by source rank, i.e. in
   ascending slot blocks, the unsharded slot order.
3. Each rank rasterizes the full splat set for its own view with the
   tiled rasterizer (the binning kernels, K1; in backward K2 and K3): the
   global per-view (tile, depth) sort, the same splat sequence as an
   unsharded render, hence the same image on any geometry.

Communication per render and rank: 11·C/K·4 bytes each way of all_to_all
plus one C-sized opacity all-gather, independent of the resolution.
Gradients flow back through the collectives (``parallel.collectives``):
each rank receives the summed sensitivities of all its group's views to
its own Gaussians.  Depth, radius and visibility are packed without
gradient (the rasterizer takes none through them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from event3dgs_tpu_torch.ops.preprocess import preprocess
from event3dgs_tpu_torch.ops.projection import ProjectedGaussians
from event3dgs_tpu_torch.ops.rasterize_reference import rasterize_reference_partials
from event3dgs_tpu_torch.ops.rasterize_tiled import rasterize_tiled_partials
from event3dgs_tpu_torch.parallel.collectives import all_gather, all_to_all


class ExchangeRender(NamedTuple):
    """One rank's exact full-scene render of its own view."""

    rgb: torch.Tensor  # [H, W, 3] pre-background accumulated color
    logt: torch.Tensor  # [H, W] log final transmittance
    radii_own: torch.Tensor  # [K, C/K] own-slot pixel radii per group view
    vis_own: torch.Tensor  # [K, C/K] own-slot visibility per group view


def render_view_exchange(
    means3d: torch.Tensor,  # [C/K, 3] this shard's Gaussian centers
    features: torch.Tensor,  # [C/K, F, 3] SH coefficients (degree-masked)
    opacities: torch.Tensor,  # [C/K] activated opacities
    scales: torch.Tensor,  # [C/K, 3] activated scales
    rotations: torch.Tensor,  # [C/K, 4] quaternions
    cameras,  # batched Camera (the same on every rank)
    view_ids,  # [K] the group's views in rank order (ints)
    group,
    sh_degree: int,
    taps: torch.Tensor | None = None,  # [K, C/K, 2] screen-grad taps
    rasterizer: str = "tiled",
    instance_cap: int | None = None,
) -> ExchangeRender:
    """Render this rank's view, ``view_ids[rank]``, from the full (sharded)
    Gaussian set.

    Every rank of ``group`` calls it together with the same ``view_ids``.
    JAX gathers them with an all_gather under ``shard_map``; here the host
    of every rank holds the whole view batch, so no collective (and no
    device-to-host read of view ids) is needed.  When ``taps`` is given,
    the gradient of ``taps[j]`` is this shard's screen-space mean gradient
    under group view j (densification stats).
    """
    packs, radii_l, vis_l = [], [], []
    for j, view in enumerate(view_ids):
        cam_j = cameras[int(view)]
        proj, colors = preprocess(means3d, scales, rotations, cam_j,
                                  opacities=opacities, features=features,
                                  sh_degree=sh_degree)
        mean2d = proj.mean2d if taps is None else proj.mean2d + taps[j]
        packs.append(torch.cat([
            mean2d,  # 0:2
            proj.depth.detach()[:, None],  # 2
            proj.conic,  # 3:6
            proj.radius.detach()[:, None],  # 6
            proj.valid.to(torch.float32)[:, None],  # 7
            colors,  # 8:11
        ], dim=-1))
        radii_l.append(proj.radius)
        vis_l.append(proj.valid)

    # chunk j (view j) goes to rank j; the received chunks stack source-
    # major, i.e. in ascending slot blocks: the unsharded order
    full = all_to_all(torch.stack(packs), group).reshape(-1, 11)
    # the kernels take contiguous columns
    mean2d, depth, conic, radius, valid, colors_full = (
        t.contiguous() for t in full.split([2, 1, 3, 1, 1, 3], dim=-1))
    proj_full = ProjectedGaussians(mean2d=mean2d, depth=depth[:, 0],
                                   conic=conic, radius=radius[:, 0],
                                   valid=valid[:, 0] > 0.5)
    opac_full = all_gather(opacities, group).reshape(-1)

    cam_mine = cameras[int(view_ids[dist.get_rank(group)])]
    if rasterizer == "tiled":
        rgb, logt = rasterize_tiled_partials(
            proj_full, colors_full, opac_full, cam_mine.width,
            cam_mine.height, instance_cap=instance_cap)
    else:
        rgb, logt = rasterize_reference_partials(
            proj_full, colors_full, opac_full, cam_mine.width,
            cam_mine.height)
    return ExchangeRender(rgb=rgb, logt=logt, radii_own=torch.stack(radii_l),
                          vis_own=torch.stack(vis_l))
