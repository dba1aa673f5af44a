"""Counting sort of instances by tile: kernels K5 (histogram) and K6
(stable in-tile rank), fused into one count → scan → rank pass that also
writes the tile lists, with their plain versions.

Counterpart of ``event3dgs_tpu/ops/sort_tiles.py``.  Ids are tile ids in
``[0, n_bins]`` where ``n_bins`` is the drop sentinel, and every id at an
index ``>= n_live`` counts as the sentinel.  ``n_live`` is a one-element
int32 tensor on the ids' device, so the host never waits for it.

- :func:`tile_histogram`: instances per tile, sentinels dropped.
- :func:`stable_tile_rank`: ``dest[i] = offsets[id] + #{j < i: ids[j] == id}``
  for real ids and ``drop_dest`` for sentinels — the destinations of a
  stable counting sort, which keeps the depth order inside each tile.
- :func:`counting_sort`: both at once, with the offsets the exclusive
  prefix of the counts, and the sorted lists themselves (what
  ``ops/binning.py`` needs).  Given ``base``, the per-segment tile counts
  that the expansion kernel writes (``ops/expand.py``), it skips its own
  count.

The kernels are ``csrc/sort_tiles.cu``; CPU tensors take the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from event3dgs_tpu_torch.ops import kernels

SEGMENT = 2048  # ids per block of the count and rank kernels (csrc/segment.cuh)
RANK_STATIC_LIMIT = 48 * 1024  # static shared bytes of a rank block, at most
SHARED_LIMIT = 232_448  # bytes of shared memory one block may use (227 KB, H100)


class SortPlan(NamedTuple):
    """How the kernels of ``csrc/sort_tiles.cu`` are launched."""

    segments: int  # blocks of the count and rank kernels, SEGMENT ids each
    count_shared: int  # shared bytes of a count block: one int per tile
    rank_shared: int  # shared bytes of a rank block, at most: its static
    # storage and one int per tile


def segments(n_ids: int) -> int:
    """The SEGMENT-id segments of ``n_ids`` ids (at least one)."""
    return max(-(-n_ids // SEGMENT), 1)


def sort_plan(n_ids: int, n_bins: int) -> SortPlan:
    """The launch plan; raises where a block's per-tile shared memory would
    not fit."""
    rank_shared = RANK_STATIC_LIMIT + 4 * n_bins
    if n_bins < 1 or rank_shared > SHARED_LIMIT:
        raise ValueError(f"counting sort: {n_bins} tiles do not fit the "
                         f"{SHARED_LIMIT} bytes of shared memory of a block")
    return SortPlan(segments=segments(n_ids), count_shared=4 * n_bins,
                    rank_shared=rank_shared)


class TileSort(NamedTuple):
    """The result of :func:`counting_sort`."""

    counts: torch.Tensor  # [n_bins] int32 real ids per tile
    offsets: torch.Tensor  # [n_bins] int32 exclusive prefix of counts
    dest: torch.Tensor  # [m] int32 slot of each id; m for sentinels
    inst: torch.Tensor  # [m] int32 gauss in (tile, index) order; fill pads
    overflow: torch.Tensor  # [] int32 max(n_live - m, 0)


def _effective_ids(ids, n_live, n_bins):
    """Ids with the tail past ``n_live`` (and anything out of range) mapped
    to the sentinel, as int64 for indexing."""
    idx = torch.arange(ids.shape[0], device=ids.device)
    keep = (idx < n_live) & (ids >= 0) & (ids < n_bins)
    return torch.where(keep, ids, n_bins).long()


def tile_histogram_plain(ids, n_bins: int, n_live):
    """Plain PyTorch version of K5."""
    eff = _effective_ids(ids, n_live, n_bins)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, eff, torch.ones_like(eff))
    return counts[:n_bins].to(torch.int32)


def stable_tile_rank_plain(ids, n_live, n_bins: int, offsets, drop_dest: int):
    """Plain PyTorch version of K6: the inverse of a stable argsort."""
    m = ids.shape[0]
    eff = _effective_ids(ids, n_live, n_bins)
    perm = torch.argsort(eff, stable=True)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, eff, torch.ones_like(eff))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=ids.device)
    rank = torch.empty_like(pos)
    rank[perm] = pos - starts[eff[perm]]
    base = torch.cat([offsets.long(), offsets.new_zeros(1).long()])
    dest = torch.where(eff < n_bins, base[eff] + rank, drop_dest)
    return dest.to(torch.int32)


def counting_sort_plain(ids, gauss, n_live, n_bins: int, fill: int,
                        base=None) -> TileSort:
    """Plain PyTorch version of the fused counting sort, from K5's and K6's
    plain versions (``base`` only spares the kernel a count: it is not
    read here)."""
    m = ids.shape[0]
    counts = tile_histogram_plain(ids, n_bins, n_live)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    dest = stable_tile_rank_plain(ids, n_live, n_bins, offsets, m)
    inst = torch.full((m + 1,), fill, dtype=torch.int32, device=ids.device)
    inst.scatter_(0, dest.long(), gauss)  # sentinels land in the last slot
    overflow = torch.clamp(n_live[0] - m, min=0)
    return TileSort(counts, offsets, dest, inst[:m], overflow)


def _check(ids, n_live):
    kernels.check(ids, torch.int32, "ids")
    kernels.check(n_live, torch.int32, "n_live", (1,))


def tile_histogram_kernel(ids, n_bins: int, n_live):
    """Launch K5 (``csrc/sort_tiles.cu``: count and scan) on CUDA tensors."""
    _check(ids, n_live)
    plan = sort_plan(ids.shape[0], n_bins)
    base = torch.empty(plan.segments * n_bins, dtype=torch.int32,
                       device=ids.device)
    counts = torch.empty(n_bins, dtype=torch.int32, device=ids.device)
    kernels.launch(
        "sort_tiles", "e3d_tile_histogram",
        ids.data_ptr(), ids.shape[0], n_live.data_ptr(), n_bins,
        base.data_ptr(), counts.data_ptr(),
    )
    tile_histogram_kernel.launches += 1
    return counts


tile_histogram_kernel.launches = 0


def stable_tile_rank_kernel(ids, n_live, n_bins: int, offsets, drop_dest: int):
    """Launch K6 (``csrc/sort_tiles.cu``: count, scan and rank) on CUDA
    tensors."""
    m = ids.shape[0]
    _check(ids, n_live)
    kernels.check(offsets, torch.int32, "offsets", (n_bins,))
    plan = sort_plan(m, n_bins)
    base = torch.empty(plan.segments * n_bins, dtype=torch.int32,
                       device=ids.device)
    dest = torch.empty(m, dtype=torch.int32, device=ids.device)
    kernels.launch(
        "sort_tiles", "e3d_stable_tile_rank",
        ids.data_ptr(), m, n_live.data_ptr(), n_bins, offsets.data_ptr(),
        drop_dest, base.data_ptr(), dest.data_ptr(),
    )
    stable_tile_rank_kernel.launches += 1
    return dest


stable_tile_rank_kernel.launches = 0


def counting_sort_kernel(ids, gauss, n_live, n_bins: int, fill: int,
                         base=None) -> TileSort:
    """Launch K5 and K6 fused (``csrc/sort_tiles.cu``: count, scan, rank;
    scan and rank only where ``base``, [segments, n_bins] int32, holds the
    live segments' count rows, which the scan overwrites) on CUDA tensors;
    counts as one launch of each."""
    m = ids.shape[0]
    _check(ids, n_live)
    kernels.check(gauss, torch.int32, "gauss", (m,))
    plan = sort_plan(m, n_bins)
    empty = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                       device=ids.device)
    counted = base is not None
    if counted:
        kernels.check(base, torch.int32, "base", (plan.segments, n_bins))
    else:
        base = empty(plan.segments * n_bins)
    out = TileSort(counts=empty(n_bins), offsets=empty(n_bins), dest=empty(m),
                   inst=empty(m), overflow=empty())
    kernels.launch(
        "sort_tiles", "e3d_counting_sort",
        ids.data_ptr(), gauss.data_ptr(), m, n_live.data_ptr(), n_bins, fill,
        int(counted), base.data_ptr(), *(t.data_ptr() for t in out),
    )
    tile_histogram_kernel.launches += 1
    stable_tile_rank_kernel.launches += 1
    return out


def tile_histogram(ids: torch.Tensor, n_bins: int, n_live: torch.Tensor):
    """[n_bins] int32 instances per tile (K5; plain version on the CPU)."""
    fn = tile_histogram_plain if ids.device.type == "cpu" else \
        tile_histogram_kernel
    return fn(ids, n_bins, n_live)


def stable_tile_rank(ids: torch.Tensor, n_live: torch.Tensor, n_bins: int,
                     offsets: torch.Tensor, drop_dest: int):
    """[len(ids)] int32 stable destinations (K6; plain version on the CPU)."""
    fn = stable_tile_rank_plain if ids.device.type == "cpu" else \
        stable_tile_rank_kernel
    return fn(ids, n_live, n_bins, offsets, drop_dest)


def counting_sort(ids: torch.Tensor, gauss: torch.Tensor, n_live: torch.Tensor,
                  n_bins: int, fill: int, base: torch.Tensor | None = None
                  ) -> TileSort:
    """Counts, offsets, destinations and the sorted ``gauss`` of a stable
    counting sort by tile (K5 and K6 fused; plain version on the CPU).
    ``base``: the live segments' tile counts, where the caller has them."""
    fn = counting_sort_plain if ids.device.type == "cpu" else \
        counting_sort_kernel
    return fn(ids, gauss, n_live, n_bins, fill, base)
