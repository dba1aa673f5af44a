"""Cross-shard depth-ordered compositing of (rgb, log T) render partials.

Counterpart of ``event3dgs_tpu/parallel/compose.py``.  Under the partials
strategy each ``gauss`` rank composites only its own Gaussians into
pre-background partials (``ops.render.render_partials``).  The
rasterizer's carry is (accumulated rgb, log transmittance), so the
over-operator is associative across depth-ordered segments:

    rgb   = Σ_k exp(Σ_{j≺k} logT_j) · rgb_k
    logT  = Σ_k logT_k
    image = rgb + exp(logT) · background

where ``≺`` is the shard compositing order.  The merge is exact only when
the shards are depth-separable for the view (forward-facing or layered
rigs after ``parallel.partition.repartition_by_depth``); on full orbits it
is approximate whatever the order (~1e-2 max pixel error measured by the
JAX package on a 48-Gaussian orbit).  The exact strategy is
``parallel.exchange``.

The order is per view: :func:`view_depth_ranks` ranks shards by the mean
depth of their visible Gaussians in the current view.  Communication: one
all-gather of the [H, W] log-transmittance maps (for the exclusive prefix)
and one group sum of the weighted [H, W, 3] partials.  Gradients reach
every shard's partials, through the other shards' transmittance prefixes
too (``parallel.collectives``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from event3dgs_tpu_torch.parallel.collectives import (
    all_gather,
    gather,
    sum_replicated,
)


@torch.no_grad()
def view_depth_ranks(
    depth: torch.Tensor,  # [N_local] per-Gaussian view depth (+inf culled)
    valid: torch.Tensor,  # [N_local] bool visibility
    group,
    group_size: int,
) -> torch.Tensor:
    """Per-view front-to-back rank of every shard ([K] int64, the same on
    every rank): shards by the mean depth of their visible Gaussians,
    empty shards last; one K-scalar all-gather."""
    nvis = valid.sum()
    mean_d = torch.where(valid, depth, 0.0).sum() / torch.clamp(nvis, min=1)
    mean_d = torch.where(nvis > 0, mean_d, torch.inf)
    ds = gather(mean_d.reshape(1), group)[:, 0]  # [K]
    order = torch.argsort(ds, stable=True)  # front-to-back shard indices
    ranks = torch.empty(group_size, dtype=torch.int64, device=depth.device)
    ranks[order] = torch.arange(group_size, device=depth.device)
    return ranks


def merge_depth_partials(
    rgb: torch.Tensor,  # [H, W, 3] this shard's accumulated color
    logt: torch.Tensor,  # [H, W] this shard's log transmittance
    background: torch.Tensor,  # [3]
    group,
    group_size: int,
    ranks: torch.Tensor | None = None,  # [K] per-view front-to-back ranks
) -> torch.Tensor:
    """Merge every group rank's partials into the full image (the same on
    every rank).  ``ranks`` gives each shard's compositing rank (front =
    0, :func:`view_depth_ranks`); ``None`` falls back to shard-index order,
    right only for a depth-partitioned forward-facing rig."""
    ag = all_gather(logt, group)  # [K, H, W] every shard's logT
    k = dist.get_rank(group)
    order = torch.arange(group_size, device=logt.device)
    if ranks is None:
        in_front = (order < k).to(ag.dtype)
    else:
        in_front = (ranks < ranks[k]).to(ag.dtype)
    prefix = torch.sum(ag * in_front[:, None, None], dim=0)  # [H, W]
    weighted = torch.exp(prefix)[:, :, None] * rgb
    total_rgb = sum_replicated(weighted, group)
    total_logt = sum_replicated(logt, group)
    return total_rgb + torch.exp(total_logt)[:, :, None] * background[None, None, :]
