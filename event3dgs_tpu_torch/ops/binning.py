"""Tile binning: depth-ordered (tile, gaussian) instance lists per tile.

Counterpart of ``event3dgs_tpu/ops/binning.py`` (forward part), with the
port's own layout: per-tile contiguous ranges (``tile_offsets``,
``tile_counts``) into ``inst_gauss``, which is sorted by (tile, depth).

1. Per Gaussian (the table kernel, ``csrc/expand.cu``): its tile rect, the
   3σ radius rect (the reference's ``getRect``) intersected with its
   α ≥ 1/255 bounding box — semantics, kept exactly (the oracle mirrors
   the radius rect) — its instance count, its ellipse-cull data and its
   depth sort key.
2. Gaussians are depth-sorted once (a stable radix sort, ``csrc/
   depth_sort.cu``; Gaussians with an empty rect sort last) and their
   counts in that order give running instance offsets.
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
    # [lookback_words(N)] int32 state of the depth order's kernels, cleared
    # by the table kernel (and left cleared by every depth order); None from
    # the plain version
    lookback: torch.Tensor | None = None
    # [N] int32 the instance counts again, contiguous (the depth order reads
    # them through its order); None from the plain version
    counts: torch.Tensor | None = None


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


# the depth order's kernels (csrc/depth_sort.cu)
RADIX_BITS = 8  # bits of a digit of the radix sort
RADIX = 1 << RADIX_BITS
PASSES = 4  # digits of a 32-bit key
SORT_TILE = 4096  # keys per block of a radix pass from SORT_LARGE keys on
SORT_TILE_SMALL = 2048  # and below
SORT_LARGE = 1 << 20
OFFSETS_TILE = 2048  # ranks per block of the depth offsets kernel
PASS_LOOKBACK = 5124  # state words before the passes' look-back words
MAX_SORTED = (1 << 28) - 1  # keys a look-back word can count


def lookback_words(n: int) -> int:
    """Int32 words of the depth order's state: the histogram's four copies
    of the digit counts, the digit starts, the plan, a word per tile and
    digit of the radix passes, and a 64-bit word per block of the offsets
    kernel."""
    return (PASS_LOOKBACK + RADIX * cdiv(n, SORT_TILE_SMALL)
            + 2 * max(cdiv(n, OFFSETS_TILE), 1))


def depth_state(n: int, device) -> torch.Tensor:
    """The depth order's state for ``n`` Gaussians, cleared (the table
    kernel allocates and clears its own)."""
    return torch.zeros(lookback_words(n), dtype=torch.int32, device=device)


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
        lookback=state(lookback_words(n), dtype=torch.int32, device=dev),
        counts=torch.empty(n, dtype=torch.int32, device=dev),
    )
    ptr = lambda t: None if t is None else t.data_ptr()
    kernels.launch(
        "expand", "e3d_gaussian_tables",
        mean2d.data_ptr(), ptr(conic), radius.data_ptr(), valid.data_ptr(),
        ptr(opacities), depth.data_ptr(), n, tiles_x, tiles_y,
        *(t.data_ptr() for t in out), out.lookback.shape[0],
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


def offsets_plain(counts: torch.Tensor, instance_cap: int):
    """The exclusive prefix of the instance counts in depth order, and the
    rank holding each segment's first slot of ``[0, instance_cap)`` (for
    segments past the live total: the last rank)."""
    n = counts.shape[0]
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    starts = torch.arange(segments(instance_cap), dtype=torch.int32,
                          device=counts.device) * SEGMENT
    seg_rank = torch.clamp(torch.searchsorted(offsets, starts, right=True) - 1,
                           0, max(n - 1, 0))
    return offsets, seg_rank.to(torch.int32)


def depth_order_plain(tables: GaussianTables, instance_cap: int) -> DepthOrder:
    """Plain PyTorch version of the depth order: the stable depth order
    (zero-count Gaussians last, ties in index order), the exclusive prefix
    of the instance counts in it, and the rank holding each segment's
    first slot of ``[0, instance_cap)`` (for segments past the live total:
    the last rank)."""
    order = torch.argsort(tables.key, stable=True)
    offsets, seg_rank = offsets_plain(tables.rect[:, 3][order], instance_cap)
    return DepthOrder(offsets=offsets, order=order.to(torch.int32),
                      seg_rank=seg_rank)


def ordered_keys(key: torch.Tensor) -> torch.Tensor:
    """The sort keys as the radix sort's unsigned words (int64 holding
    uint32), ordered as ``torch.argsort`` orders the floats on the CPU:
    a positive float's bits with the sign bit set, a negative float's bits
    flipped, -0.0 as +0.0, and every NaN, of either sign, as the largest
    word (after +inf), ties in index order.  The card's ``torch.argsort``
    agrees on every key but NaN: at 100,000 keys (CUB's radix sort) it
    puts a NaN with the sign bit set before -inf (an H100 under PyTorch
    2.11, ``tests/test_torch_kernels.py``).  The table kernel never writes
    a NaN key (``tests/test_torch_binning.py``)."""
    u = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(key), 0xFFFFFFFF, u)


def radix_plan(words: torch.Tensor) -> list[int]:
    """The radix passes that run on the keys' words: a pass whose 8-bit
    digit is the same for every key leaves a stable order as it is and is
    skipped; if every pass would be, the last runs alone."""
    n = words.shape[0]
    run = [p for p in range(PASSES) if n > 0 and int(torch.bincount(
        (words >> (RADIX_BITS * p)) & (RADIX - 1), minlength=RADIX).max()) < n]
    return run or [PASSES - 1]


def radix_order_plain(tables: GaussianTables,
                      instance_cap: int) -> DepthOrder:
    """Plain PyTorch version of the depth order's kernels (its card tests'
    and CPU tests' mirror of ``csrc/depth_sort.cu``): the keys' words
    (:func:`ordered_keys`), one stable counting pass by each 8-bit digit of
    :func:`radix_plan`, least significant first, the last of which writes
    the order and the counts in it, then their offsets.  Equal to
    :func:`depth_order_plain` wherever the keys hold no NaN, and with NaNs
    where ``torch.argsort`` orders them as :func:`ordered_keys` does."""
    words = ordered_keys(tables.key)
    n = words.shape[0]
    order = torch.arange(n, device=words.device)
    index = torch.arange(n, device=words.device)
    for p in radix_plan(words):
        digit = (words[order] >> (RADIX_BITS * p)) & (RADIX - 1)
        # a stable counting pass: by digit, then by position (unique keys,
        # so any sort gives this permutation)
        order = order[torch.sort(digit * max(n, 1) + index).indices]
    counts = tables.rect[:, 3][order]
    offsets, seg_rank = offsets_plain(counts, instance_cap)
    return DepthOrder(offsets=offsets, order=order.to(torch.int32),
                      seg_rank=seg_rank)


def _check_depth_state(tables: GaussianTables) -> int:
    n = tables.key.shape[0]
    kernels.check(tables.key, torch.float32, "key", (n,))
    if tables.lookback is None or tables.counts is None:
        raise ValueError("tables: expected the table kernel's look-back state "
                         "and count column")
    kernels.check(tables.lookback, torch.int32, "lookback", (lookback_words(n),))
    kernels.check(tables.counts, torch.int32, "counts", (n,))
    if n > MAX_SORTED:
        raise ValueError(f"{n} Gaussians: the depth sort takes at most "
                         f"{MAX_SORTED}")
    return n


def depth_sort_kernel(tables: GaussianTables, defines=()):
    """Launch the radix sort of ``csrc/depth_sort.cu`` (its histogram
    kernel, then a pass per 8-bit digit; the passes whose digit is the same
    for every key return at once) on CUDA tensors: (the Gaussians in depth
    order, their instance counts in that order), both [N] int32.  The
    state must be as the table kernel or a depth order left it.
    ``defines``: a timing-only build's macros (``tools/kernel_probes.py``)."""
    n = _check_depth_state(tables)
    dev = tables.key.device
    order = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(4, n, dtype=torch.int32, device=dev)
    kernels.launch(
        "depth_sort", "e3d_depth_sort",
        tables.key.data_ptr(), tables.counts.data_ptr(), n,
        tables.lookback.data_ptr(), scratch[:2].data_ptr(),
        scratch[2:].data_ptr(), order.data_ptr(), counts.data_ptr(),
        defines=defines,
    )
    depth_sort_kernel.launches += 1
    return order, counts


depth_sort_kernel.launches = 0


def depth_offsets_kernel(tables: GaussianTables, counts: torch.Tensor,
                         instance_cap: int, defines=()):
    """Launch the depth offsets kernel of ``csrc/depth_sort.cu`` on CUDA
    tensors after :func:`depth_sort_kernel`: (the offsets [N+1], the rank
    holding each live segment's first slot [segments(instance_cap)]), both
    int32, from ``counts``, the instance counts in depth order.  It clears
    the state the sort used and its own."""
    n = _check_depth_state(tables)
    kernels.check(counts, torch.int32, "counts", (n,))
    if counts.data_ptr() % 32:  # the kernel reads it with 16-byte loads
        raise ValueError("counts: expected a 32-byte aligned tensor")
    dev = counts.device
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    seg_rank = torch.empty(segments(instance_cap), dtype=torch.int32,
                           device=dev)
    kernels.launch(
        "depth_sort", "e3d_depth_offsets",
        counts.data_ptr(), n, seg_rank.shape[0], tables.lookback.data_ptr(),
        offsets.data_ptr(), seg_rank.data_ptr(), defines=defines,
    )
    depth_offsets_kernel.launches += 1
    return offsets, seg_rank


depth_offsets_kernel.launches = 0


def depth_order_kernel(tables: GaussianTables, instance_cap: int,
                       defines=()) -> DepthOrder:
    """The depth order on CUDA tensors: the radix sort and the depth
    offsets kernel (``csrc/depth_sort.cu``), hand-written kernels only (no
    library sort); the segments' first ranks are written for the live
    segments only."""
    order, counts = depth_sort_kernel(tables, defines)
    offsets, seg_rank = depth_offsets_kernel(tables, counts, instance_cap,
                                             defines)
    depth_order_kernel.launches += 1
    return DepthOrder(offsets=offsets, order=order, seg_rank=seg_rank)


depth_order_kernel.launches = 0


def depth_order(tables: GaussianTables, instance_cap: int) -> DepthOrder:
    """The depth order and the instance offsets in it (the radix sort and
    the depth offsets kernel; plain version on the CPU).  On the card the
    tables must come from the table kernel, which clears the kernels'
    state (every call leaves it cleared again)."""
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
