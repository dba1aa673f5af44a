"""Instance expansion for tile binning: kernel K4 and its plain version.

Counterpart of ``event3dgs_tpu/ops/expand.py``.  Given the per-Gaussian
tile rects and ellipse-cull data in Gaussian order (``rect`` and ``cull``
of ``binning.GaussianTables``), the depth order and the running instance
offsets in that order (``binning.DepthOrder``, which also gives the rank
of each segment's first slot, the kernel's starting point; the plain
version searches the offsets per slot instead and does not read it),
every instance slot ``i < instance_cap`` gets its source Gaussian (the
Gaussian of the depth rank whose offset range holds ``i``), its tile
inside that Gaussian's rect (row-major) and the exact per-tile ellipse
cull of :func:`rect_min_q`.  Dead slots (past the live total, or culled)
get the sentinels ``(num_tiles, n)``.

With ``count_rows`` it also returns the tile counts of each segment of
``SEGMENT`` slots (:func:`segment_counts`: per segment, K5's plain
histogram), the rows the counting sort's scan reads
(``ops/sort_tiles.py``), so that the sort needs no count pass of its own.
The kernel writes the rows of the live segments only (those that start
before ``min(offsets[n], instance_cap)``); the plain version's other rows
are 0.

The kernel is ``csrc/expand.cu``; :func:`expand_instances` launches it for
CUDA tensors and runs :func:`expand_instances_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops.sort_tiles import (
    SEGMENT,
    SHARED_LIMIT,
    _effective_ids,
    segments,
)

TILE_W = 32
TILE_H = 32
RECT_COLS = 4  # x0, y0, rw, count (see binning.GaussianTables)
CULL_COLS = 8  # mx, my, ca, cb, cc, nba, nbc, qthr
# shared memory of an expansion block (csrc/expand.cu): its static storage
# (at most), a 48-byte row and a 4-byte mark per slot, 4 bytes per tile
EXPAND_STATIC_LIMIT = 1024
SEGMENT_SHARED = SEGMENT * (48 + 4)


class ExpandPlan(NamedTuple):
    """How ``csrc/expand.cu``'s expansion kernel is launched."""

    segments: int  # rows of the count output (the counting sort's segments)
    counts: bool  # whether a block's tile counts fit its shared memory


def expand_plan(instance_cap: int, num_tiles: int) -> ExpandPlan:
    fits = EXPAND_STATIC_LIMIT + SEGMENT_SHARED + 4 * num_tiles <= SHARED_LIMIT
    return ExpandPlan(segments=segments(instance_cap), counts=fits)


class Expansion(NamedTuple):
    tile: torch.Tensor  # [cap] int32 tile per slot; num_tiles for dead slots
    gauss: torch.Tensor  # [cap] int32 Gaussian per slot; n for dead slots
    rows: torch.Tensor | None  # [segments, num_tiles] int32 tile counts


def rect_min_q(lx, hx, ly, hy, ca, cb, cc, nba, nbc):
    """Min of the positive-semidefinite quadratic ca·dx² + 2·cb·dx·dy + cc·dy²
    over the box [lx, hx] × [ly, hy] (bounds relative to the mean).

    Convexity ⇒ the min is 0 if the box holds the origin, else it lies on
    one of the four edges, at the clamped 1-D stationary point.  The
    operation order is the JAX package's (``ops/binning.py``), which the
    kernel repeats.
    """
    inside = (lx <= 0.0) & (0.0 <= hx) & (ly <= 0.0) & (0.0 <= hy)

    def edge_x(e):
        dy = torch.clamp(nbc * e, ly, hy)
        return ca * e * e + 2.0 * cb * e * dy + cc * dy * dy

    def edge_y(e):
        dx = torch.clamp(nba * e, lx, hx)
        return ca * dx * dx + 2.0 * cb * dx * e + cc * e * e

    q = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)),
    )
    return torch.where(inside, torch.zeros_like(q), q)


def segment_counts(tile, n_live, num_tiles: int):
    """[segments, num_tiles] int32: the tile counts of each ``SEGMENT``-slot
    segment of ``tile`` (slots at ``n_live`` and past it count as the
    sentinel), the counting sort's segments."""
    m = tile.shape[0]
    n_seg = segments(m)
    eff = _effective_ids(tile, n_live, num_tiles)
    seg = torch.arange(m, device=tile.device) // SEGMENT
    counts = torch.zeros(n_seg * (num_tiles + 1), dtype=torch.int64,
                         device=tile.device)
    counts.index_add_(0, seg * (num_tiles + 1) + eff, torch.ones_like(eff))
    return counts.view(n_seg, num_tiles + 1)[:, :num_tiles].to(torch.int32)


def expand_instances_plain(rect, cull, offsets, order, seg_rank,
                           instance_cap: int, tiles_x: int, num_tiles: int,
                           count_rows: bool = False) -> Expansion:
    """Plain PyTorch version of K4 (same arguments and results; it searches
    the offsets per slot and does not read ``seg_rank``)."""
    n = order.shape[0]
    dev = offsets.device
    tile = torch.full((instance_cap,), num_tiles, dtype=torch.int32, device=dev)
    gauss = torch.full((instance_cap,), n, dtype=torch.int32, device=dev)
    if n > 0 and instance_cap > 0:
        inst = torch.arange(instance_cap, dtype=torch.int32, device=dev)
        grank = torch.clamp(
            torch.searchsorted(offsets, inst, right=True) - 1, 0, n - 1
        )
        g = order.long()[grank]
        j = inst - offsets[grank]
        rw = torch.clamp(rect[g, 2], min=1)
        tx = rect[g, 0] + j % rw
        ty = rect[g, 1] + j // rw
        mx, my, ca, cb, cc, nba, nbc, qthr = cull[g].unbind(1)
        px0 = (tx * TILE_W).to(torch.float32)
        py0 = (ty * TILE_H).to(torch.float32)
        qmin = rect_min_q(
            px0 - 1.0 - mx, px0 + float(TILE_W) - mx,
            py0 - 1.0 - my, py0 + float(TILE_H) - my,
            ca, cb, cc, nba, nbc,
        )
        live = (inst < torch.clamp(offsets[n], max=instance_cap)) & (qmin <= qthr)
        tile = torch.where(live, ty * tiles_x + tx, tile)
        gauss = torch.where(live, g.to(torch.int32), gauss)
    rows = segment_counts(tile, offsets[n:], num_tiles) if count_rows else None
    return Expansion(tile, gauss, rows)


def launch_expand_instances(rect, cull, offsets, order, seg_rank,
                            instance_cap: int, tiles_x: int, num_tiles: int,
                            count_rows: bool = False,
                            defines=()) -> Expansion:
    """Check K4's arguments and launch the build of ``csrc/expand.cu`` with
    the macros ``defines`` (none: the shipping K4) on CUDA tensors.  The
    timing-only builds are launched through here by
    ``tools/kernel_probes.py``."""
    n = order.shape[0]
    kernels.check(rect, torch.int32, "rect", (n, RECT_COLS))
    kernels.check(cull, torch.float32, "cull", (n, CULL_COLS))
    kernels.check(offsets, torch.int32, "offsets", (n + 1,))
    kernels.check(order, torch.int32, "order", (n,))
    kernels.check(seg_rank, torch.int32, "seg_rank", (segments(instance_cap),))
    for t, what in ((rect, "rect"), (cull, "cull")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: expected a 16-byte aligned tensor")
    if instance_cap % 4:
        raise ValueError(f"instance_cap {instance_cap}: expected a multiple of 4")
    plan = expand_plan(instance_cap, num_tiles)
    if count_rows and not plan.counts:
        raise ValueError(f"expansion: the counts of {num_tiles} tiles do not "
                         f"fit a block's shared memory")
    empty = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                       device=offsets.device)
    out = Expansion(empty(instance_cap), empty(instance_cap),
                    empty(plan.segments, num_tiles) if count_rows else None)
    kernels.launch(
        "expand", "e3d_expand_instances",
        rect.data_ptr(), cull.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        seg_rank.data_ptr(), n, instance_cap, tiles_x, num_tiles,
        out.tile.data_ptr(), out.gauss.data_ptr(),
        out.rows.data_ptr() if count_rows else None, defines=defines,
    )
    return out


def expand_instances_kernel(rect, cull, offsets, order, seg_rank,
                            instance_cap: int, tiles_x: int, num_tiles: int,
                            count_rows: bool = False) -> Expansion:
    """Launch K4 (``csrc/expand.cu``) on CUDA tensors."""
    out = launch_expand_instances(rect, cull, offsets, order, seg_rank,
                                  instance_cap, tiles_x, num_tiles, count_rows)
    expand_instances_kernel.launches += 1
    return out


expand_instances_kernel.launches = 0


def expand_instances(
    rect: torch.Tensor,  # [N, 4] int32 tile rect (x0, y0, width, count) per Gaussian
    cull: torch.Tensor,  # [N, 8] float32 ellipse-cull data per Gaussian
    offsets: torch.Tensor,  # [N+1] int32 instance-range starts, depth order
    order: torch.Tensor,  # [N] int32 gaussian id per depth rank
    seg_rank: torch.Tensor,  # [segments] int32 rank of each segment's first slot
    instance_cap: int,
    tiles_x: int,
    num_tiles: int,
    count_rows: bool = False,
) -> Expansion:
    """Expand per-Gaussian tile rects into per-instance (tile, gaussian).

    Returns the tile per slot ([instance_cap] int32 with the ``num_tiles``
    sentinel), the Gaussian per slot (with the ``N`` sentinel) and, with
    ``count_rows``, each segment's tile counts.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    fn = expand_instances_plain if offsets.device.type == "cpu" else \
        expand_instances_kernel
    return fn(rect, cull, offsets, order, seg_rank, instance_cap, tiles_x,
              num_tiles, count_rows)
