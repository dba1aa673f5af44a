"""Tile binning: depth-ordered (tile, gaussian) instance lists per tile.

Counterpart of ``event3dgs_tpu/ops/binning.py`` (forward part), with the
port's own layout: per-tile contiguous ranges (``tile_offsets``,
``tile_counts``) into ``inst_gauss``, which is sorted by (tile, depth).

1. Each Gaussian's tile rect is its 3σ radius rect (the reference's
   ``getRect``) intersected with its α ≥ 1/255 bounding box — semantics,
   kept exactly (the oracle mirrors the radius rect).
2. Gaussians are depth-sorted once (stable ``argsort``; Gaussians with an
   empty rect sort last) and their rect sizes give running instance
   offsets.
3. Expansion (kernel K4) gives every instance slot its (tile, gaussian),
   with the exact per-tile ellipse cull; at most ``instance_cap`` instances
   are kept, the first in depth order, and the rest are counted in
   ``overflow``.
4. A stable counting sort by tile — histogram (K5) and stable rank (K6),
   fused into one pass that also writes the offsets and the per-tile
   lists — keeps each tile's instances in depth order.

Tiles are 32×32 pixels.  Binning produces index data only; no gradient
flows through it.  Besides the per-tile lists, :class:`Binning` keeps what
the backward reduction (kernel K3, ``ops/segscan.py``) needs to map
per-slot gradient rows back to Gaussians: each expansion instance's slot
(``dest``), the depth-rank instance ranges (``offsets``) and the Gaussian
of each rank (``order``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from event3dgs_tpu_torch.ops.expand import expand_instances, expand_instances_plain
from event3dgs_tpu_torch.ops.sort_tiles import counting_sort, counting_sort_plain

TILE_H = 32
TILE_W = 32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return cdiv(width, TILE_W), cdiv(height, TILE_H)


@dataclasses.dataclass
class Binning:
    inst_gauss: torch.Tensor  # [cap] int32 gaussian per slot, (tile, depth) order; N pads
    tile_offsets: torch.Tensor  # [T] int32 start of each tile's range
    tile_counts: torch.Tensor  # [T] int32 instances per tile
    overflow: torch.Tensor  # [] instances dropped past the cap
    num_tiles_x: int
    num_tiles_y: int
    # [cap] int32 slot of each expansion instance (K6's output); cap for
    # instances the ellipse cull dropped or that lie past the live count
    dest: torch.Tensor
    offsets: torch.Tensor  # [N+1] int32 instance-range starts per depth rank
    order: torch.Tensor  # [N] int32 gaussian id per depth rank


class DepthTables(NamedTuple):
    """Per-Gaussian expansion inputs in depth order (the K4 inputs)."""

    offsets: torch.Tensor  # [N+1] int32 instance-range starts
    order: torch.Tensor  # [N] int32 gaussian id per rank
    rect: torch.Tensor  # [N, 3] int32 x0, y0, rect width (tiles)
    cull: torch.Tensor  # [N, 8] float32 mx, my, ca, cb, cc, nba, nbc, qthr


def _alpha_bbox_half_extents(conic, radius, opacities):
    """Per-axis half extents of the α ≥ 1/255 region, in pixels (+1 px
    absorbs f32 rounding); the isotropic ``radius`` where the conic is
    degenerate."""
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    det = ca * cc - cb * cb
    ok = det > 1e-12
    safe_det = torch.where(ok, det, torch.ones_like(det))
    if opacities is not None:
        t2 = 2.0 * torch.clamp(
            torch.log(255.0 * torch.clamp(opacities, min=1e-12)), min=0.0
        )
    else:
        t2 = torch.full_like(ca, 2.0 * np.log(255.0))
    wx = torch.sqrt(torch.clamp(t2 * cc / safe_det, min=0.0)) + 1.0
    wy = torch.sqrt(torch.clamp(t2 * ca / safe_det, min=0.0)) + 1.0
    return torch.where(ok, wx, radius), torch.where(ok, wy, radius)


def _tile_rect(mx, my, rx, ry, tiles_x, tiles_y):
    """CUDA getRect tile bounds for per-axis half extents (rx, ry)."""

    def bound(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n).to(torch.int32)

    return (
        bound(mx - rx, TILE_W, tiles_x),
        bound(my - ry, TILE_H, tiles_y),
        bound(mx + rx + TILE_W - 1, TILE_W, tiles_x),
        bound(my + ry + TILE_H - 1, TILE_H, tiles_y),
    )


def _binning_rect(mean2d, radius, conic, opacities, tiles_x, tiles_y):
    """The radius rect intersected with the α ≥ 1/255 bounding box."""
    mx, my = mean2d[:, 0], mean2d[:, 1]
    x0, y0, x1, y1 = _tile_rect(mx, my, radius, radius, tiles_x, tiles_y)
    if conic is not None:
        wx, wy = _alpha_bbox_half_extents(conic, radius, opacities)
        ex0, ey0, ex1, ey1 = _tile_rect(mx, my, wx, wy, tiles_x, tiles_y)
        x0, y0 = torch.maximum(x0, ex0), torch.maximum(y0, ey0)
        x1, y1 = torch.minimum(x1, ex1), torch.minimum(y1, ey1)
    return mx, my, x0, y0, x1, y1


def count_instances(mean2d, radius, valid, width: int, height: int,
                    conic=None, opacities=None) -> torch.Tensor:
    """Total (tile, gaussian) instances of the rects (an upper bound on the
    live instances: the per-tile ellipse cull only removes more)."""
    tiles_x, tiles_y = tile_grid(width, height)
    _, _, x0, y0, x1, y1 = _binning_rect(
        mean2d, radius, conic, opacities, tiles_x, tiles_y
    )
    counts = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    return torch.where(valid, counts, 0).sum()


def suggest_instance_cap(total: int, margin: float = 1.3) -> int:
    """Round an observed instance count up by ``margin`` to a 1024 multiple."""
    return max(-(-int(int(total) * margin) // 1024) * 1024, 1024)


def depth_tables(mean2d, depth, radius, valid, width: int, height: int,
                 opacities=None, conic=None) -> DepthTables:
    """Tile rects, ellipse-cull data and instance offsets in depth order."""
    n = mean2d.shape[0]
    tiles_x, tiles_y = tile_grid(width, height)
    mx, my, x0, y0, x1, y1 = _binning_rect(
        mean2d, radius, conic, opacities, tiles_x, tiles_y
    )
    rw = torch.clamp(x1 - x0, min=0)
    rh = torch.clamp(y1 - y0, min=0)
    counts = torch.where(valid, rw * rh, 0)

    # exact per-tile cull: a rect tile is dropped iff the min over its
    # (1 px-expanded) pixel box of Q(d) = dᵀ·conic·d exceeds
    # qthr = 2·ln(255·o) — every pixel there has α < 1/255
    o = opacities if opacities is not None else torch.ones_like(radius)
    qthr = 2.0 * torch.clamp(torch.log(255.0 * torch.clamp(o, min=1e-12)),
                             min=0.0)
    if conic is not None:
        ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
        pd = (ca > 1e-12) & (cc > 1e-12) & (ca * cc - cb * cb > 1e-12)
        one, zero = torch.ones_like(ca), torch.zeros_like(ca)
        nba = torch.where(pd, -cb / torch.where(pd, ca, one), zero)
        nbc = torch.where(pd, -cb / torch.where(pd, cc, one), zero)
        ca = torch.where(pd, ca, zero)
        cb = torch.where(pd, cb, zero)
        cc = torch.where(pd, cc, zero)
        # degenerate conics never cull (Q ≡ 0 ≤ qthr)
    else:
        ca = cb = cc = nba = nbc = torch.zeros_like(radius)

    # zero-count Gaussians sort last; ties keep index order (stable)
    depth_eff = torch.where(counts > 0, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(depth_eff, stable=True)
    rect = torch.stack([x0, y0, rw], dim=1)[order]
    cull = torch.stack([mx, my, ca, cb, cc, nba, nbc, qthr], dim=1)[order]
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=mean2d.device)
    offsets[1:] = torch.cumsum(counts[order], 0)
    return DepthTables(
        offsets=offsets,
        order=order.to(torch.int32),
        rect=rect.contiguous(),
        cull=cull.to(torch.float32).contiguous(),
    )


def bin_gaussians(
    mean2d: torch.Tensor,  # [N, 2]
    depth: torch.Tensor,  # [N] (+inf for culled)
    radius: torch.Tensor,  # [N] (0 for culled)
    valid: torch.Tensor,  # [N] bool
    width: int,
    height: int,
    instance_cap: int,
    opacities: torch.Tensor | None = None,
    conic: torch.Tensor | None = None,
    plain: bool = False,
) -> Binning:
    """Per-tile depth-ordered instance lists.

    CPU tensors always take the plain versions of K4-K6; CUDA tensors
    launch the kernels unless ``plain`` asks for the plain versions (for
    holding the kernels against them).
    """
    n = mean2d.shape[0]
    tiles_x, tiles_y = tile_grid(width, height)
    num_tiles = tiles_x * tiles_y
    expand, sort = (
        (expand_instances_plain, counting_sort_plain) if plain
        else (expand_instances, counting_sort)
    )
    with torch.no_grad():
        tables = depth_tables(mean2d, depth, radius, valid, width, height,
                              opacities=opacities, conic=conic)
        tile, gauss = expand(*tables, instance_cap, tiles_x, num_tiles)
        n_live = tables.offsets[n:]  # [1] total instances, uncapped
        lists = sort(tile, gauss, n_live, num_tiles, n)
    return Binning(
        inst_gauss=lists.inst,
        tile_offsets=lists.offsets,
        tile_counts=lists.counts,
        overflow=lists.overflow,
        num_tiles_x=tiles_x,
        num_tiles_y=tiles_y,
        dest=lists.dest,
        offsets=tables.offsets,
        order=tables.order,
    )
