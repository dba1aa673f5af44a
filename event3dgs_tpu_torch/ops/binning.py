"""Tile binning: depth-ordered (tile, gaussian) instance lists per tile.

Counterpart of ``event3dgs_tpu/ops/binning.py`` (forward part), with the
port's own layout: per-tile contiguous ranges (``tile_offsets``,
``tile_counts``) into ``inst_gauss``, which is sorted by (tile, depth).

1. Per Gaussian (the table kernel, ``csrc/expand.cu``): its tile rect, the
   3σ radius rect (the reference's ``getRect``) intersected with its
   α ≥ 1/255 bounding box — semantics, kept exactly (the oracle mirrors
   the radius rect) — its instance count, its ellipse-cull data and its
   depth sort key.
2. Gaussians are depth-sorted once (stable ``argsort``; Gaussians with an
   empty rect sort last) and their counts in that order give running
   instance offsets.
3. Expansion (kernel K4) gives every instance slot its (tile, gaussian),
   with the exact per-tile ellipse cull; at most ``instance_cap`` instances
   are kept, the first in depth order, and the rest are counted in
   ``overflow``.  It also counts each segment's tiles for step 4.
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

from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops.expand import (
    expand_instances,
    expand_instances_plain,
    expand_plan,
)
from event3dgs_tpu_torch.ops.sort_tiles import (
    SEGMENT,
    counting_sort,
    counting_sort_plain,
    segments,
)

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


class GaussianTables(NamedTuple):
    """Per-Gaussian expansion inputs, in Gaussian order (the table kernel's
    output)."""

    rect: torch.Tensor  # [N, 4] int32 x0, y0, rect width (tiles), instance count
    cull: torch.Tensor  # [N, 8] float32 mx, my, ca, cb, cc, nba, nbc, qthr
    key: torch.Tensor  # [N] float32 depth sort key: +inf where the count is 0
    # [lookback_words(N)] int64 state of the depth offsets kernel, cleared
    # by the table kernel (and again by the offsets kernel as it ends);
    # None from the plain version
    lookback: torch.Tensor | None = None


class DepthOrder(NamedTuple):
    """The depth order and the running instance offsets in it."""

    offsets: torch.Tensor  # [N+1] int32 instance-range starts
    order: torch.Tensor  # [N] int32 gaussian id per rank
    # [segments(instance_cap)] int32 rank holding each SEGMENT-slot
    # segment's first slot (K4's starting points; live segments only)
    seg_rank: torch.Tensor


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


OFFSETS_TILE = 2048  # ranks per block of the depth offsets kernel (csrc/expand.cu)


def lookback_words(n: int) -> int:
    """Words of the depth offsets kernel's state: one per block and the
    count of finished blocks."""
    return max(-(-n // OFFSETS_TILE), 1) + 1


def gaussian_tables_plain(mean2d, depth, radius, valid, width: int,
                          height: int, opacities=None,
                          conic=None) -> GaussianTables:
    """Plain PyTorch version of the table kernel: tile rects, instance
    counts, ellipse-cull data and depth sort keys, in Gaussian order."""
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

    # zero-count Gaussians sort last
    key = torch.where(counts > 0, depth, torch.full_like(depth, float("inf")))
    return GaussianTables(
        rect=torch.stack([x0, y0, rw, counts], dim=1).to(torch.int32),
        cull=torch.stack([mx, my, ca, cb, cc, nba, nbc, qthr], dim=1).to(
            torch.float32).contiguous(),
        key=key,
    )


def gaussian_tables_kernel(mean2d, depth, radius, valid, width: int,
                           height: int, opacities=None,
                           conic=None) -> GaussianTables:
    """Launch the table kernel (``csrc/expand.cu``) on CUDA tensors."""
    n = mean2d.shape[0]
    kernels.check(mean2d, torch.float32, "mean2d", (n, 2))
    kernels.check(depth, torch.float32, "depth", (n,))
    kernels.check(radius, torch.float32, "radius", (n,))
    kernels.check(valid, torch.bool, "valid", (n,))
    if opacities is not None:
        kernels.check(opacities, torch.float32, "opacities", (n,))
    if conic is not None:
        kernels.check(conic, torch.float32, "conic", (n, 3))
    tiles_x, tiles_y = tile_grid(width, height)
    dev = mean2d.device
    # the kernel clears the state; without Gaussians it does not run
    state = torch.zeros if n == 0 else torch.empty
    out = GaussianTables(
        rect=torch.empty(n, 4, dtype=torch.int32, device=dev),
        cull=torch.empty(n, 8, dtype=torch.float32, device=dev),
        key=torch.empty(n, dtype=torch.float32, device=dev),
        lookback=state(lookback_words(n), dtype=torch.int64, device=dev),
    )
    ptr = lambda t: None if t is None else t.data_ptr()
    kernels.launch(
        "expand", "e3d_gaussian_tables",
        mean2d.data_ptr(), ptr(conic), radius.data_ptr(), valid.data_ptr(),
        ptr(opacities), depth.data_ptr(), n, tiles_x, tiles_y,
        *(t.data_ptr() for t in out),
    )
    gaussian_tables_kernel.launches += 1
    return out


gaussian_tables_kernel.launches = 0


def gaussian_tables(mean2d: torch.Tensor, depth: torch.Tensor,
                    radius: torch.Tensor, valid: torch.Tensor, width: int,
                    height: int, opacities: torch.Tensor | None = None,
                    conic: torch.Tensor | None = None) -> GaussianTables:
    """Per-Gaussian tile rects, instance counts, ellipse-cull data and depth
    sort keys (the table kernel; plain version on the CPU)."""
    fn = gaussian_tables_plain if mean2d.device.type == "cpu" else \
        gaussian_tables_kernel
    return fn(mean2d, depth, radius, valid, width, height,
              opacities=opacities, conic=conic)


def depth_order_plain(tables: GaussianTables, instance_cap: int) -> DepthOrder:
    """Plain PyTorch version of the depth order: the stable depth order
    (zero-count Gaussians last, ties in index order), the exclusive prefix
    of the instance counts in it, and the rank holding each segment's
    first slot of ``[0, instance_cap)`` (for segments past the live total:
    the last rank)."""
    order = torch.argsort(tables.key, stable=True)
    n = order.shape[0]
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=order.device)
    torch.cumsum(tables.rect[:, 3][order], 0, dtype=torch.int32,
                 out=offsets[1:])
    starts = torch.arange(segments(instance_cap), dtype=torch.int32,
                          device=order.device) * SEGMENT
    seg_rank = torch.clamp(torch.searchsorted(offsets, starts, right=True) - 1,
                           0, max(n - 1, 0))
    return DepthOrder(offsets=offsets, order=order.to(torch.int32),
                      seg_rank=seg_rank.to(torch.int32))


def depth_order_kernel(tables: GaussianTables,
                       instance_cap: int) -> DepthOrder:
    """The depth order on CUDA tensors: ``torch.argsort`` (as the JAX
    package sorts outside its kernels), then the depth offsets kernel
    (``csrc/expand.cu``) for the order's cast, the counts' gather, their
    prefix and each segment's first rank, in one launch (that rank is
    written for the live segments only)."""
    n = tables.key.shape[0]
    kernels.check(tables.key, torch.float32, "key", (n,))
    kernels.check(tables.rect, torch.int32, "rect", (n, 4))
    if tables.lookback is None:
        raise ValueError("tables: expected the table kernel's look-back state")
    kernels.check(tables.lookback, torch.int64, "lookback", (lookback_words(n),))
    order = torch.argsort(tables.key, stable=True)
    if order.data_ptr() % 16:  # the kernel reads it with 16-byte loads
        raise ValueError("order: expected a 16-byte aligned tensor")
    n_seg = segments(instance_cap)
    empty = lambda size: torch.empty(size, dtype=torch.int32,
                                     device=order.device)
    out = DepthOrder(offsets=empty(n + 1), order=empty(n),
                     seg_rank=empty(n_seg))
    kernels.launch(
        "expand", "e3d_depth_offsets",
        order.data_ptr(), tables.rect.data_ptr(), n, n_seg,
        tables.lookback.data_ptr(), out.order.data_ptr(),
        out.offsets.data_ptr(), out.seg_rank.data_ptr(),
    )
    depth_order_kernel.launches += 1
    return out


depth_order_kernel.launches = 0


def depth_order(tables: GaussianTables, instance_cap: int) -> DepthOrder:
    """The depth order and the instance offsets in it (the depth offsets
    kernel after ``argsort``; plain version on the CPU).  On the card the
    tables must come from the table kernel, which clears the offsets
    kernel's look-back state (the kernel leaves it cleared again)."""
    fn = depth_order_plain if tables.key.device.type == "cpu" else \
        depth_order_kernel
    return fn(tables, instance_cap)


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

    CPU tensors always take the plain versions of the table kernel and
    K4-K6; CUDA tensors launch the kernels unless ``plain`` asks for the
    plain versions (for holding the kernels against them).
    """
    n = mean2d.shape[0]
    tiles_x, tiles_y = tile_grid(width, height)
    num_tiles = tiles_x * tiles_y
    tables_fn, order_fn, expand, sort = (
        (gaussian_tables_plain, depth_order_plain, expand_instances_plain,
         counting_sort_plain)
        if plain else
        (gaussian_tables, depth_order, expand_instances, counting_sort)
    )
    # K4 counts each segment's tiles for the sort where they fit its block
    count_rows = not plain and expand_plan(instance_cap, num_tiles).counts
    with torch.no_grad():
        tables = tables_fn(mean2d, depth, radius, valid, width, height,
                           opacities=opacities, conic=conic)
        ranks = order_fn(tables, instance_cap)
        inst = expand(tables.rect, tables.cull, *ranks, instance_cap, tiles_x,
                      num_tiles, count_rows)
        n_live = ranks.offsets[n:]  # [1] total instances, uncapped
        lists = sort(inst.tile, inst.gauss, n_live, num_tiles, n,
                     base=inst.rows)
    return Binning(
        inst_gauss=lists.inst,
        tile_offsets=lists.offsets,
        tile_counts=lists.counts,
        overflow=lists.overflow,
        num_tiles_x=tiles_x,
        num_tiles_y=tiles_y,
        dest=lists.dest,
        offsets=ranks.offsets,
        order=ranks.order,
    )
