"""The port's fused counting sort by tile (kernels K5 and K6 with the tile
lists; the plain version on the CPU) against the JAX package's
``counting_sort_buckets`` in interpret mode followed by the JAX binning's
scatter, and the launch plan of ``csrc/sort_tiles.cu``.

The CUDA kernels are held against the plain versions in
tests/test_torch_kernels.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.ops.sort_tiles import counting_sort_buckets
from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops import sort_tiles as tst

torch.set_num_threads(1)

FILL = 7777  # the pad value of the tile lists (the binning's N)


# (m, n_bins, n_live): n_live 0, past m, inside a block, all ids sentinels
CASES = [(4096, 40, 3000), (3000, 300, 3000), (2048, 17, 0), (2048, 17, 5000),
         (5000, 60, 1025), (1024, 9, -1)]


@pytest.mark.parametrize("m,n_bins,n_live", CASES)
def test_plain_counting_sort_matches_jax_sort_and_scatter(m, n_bins, n_live):
    rng = np.random.default_rng(m + n_bins)
    ids = rng.integers(0, n_bins + 1, m).astype(np.int32)  # incl. sentinels
    if n_live < 0:  # every id the sentinel
        ids[:], n_live = n_bins, m
    ids[n_live:] = n_bins
    gauss = rng.permutation(m).astype(np.int32)
    ref_counts, dest_fn = counting_sort_buckets(
        jnp.asarray(ids), n_bins, interpret=True, n_live=n_live)
    ref_offsets = jnp.cumsum(ref_counts) - ref_counts
    ref_dest = np.asarray(dest_fn(ref_offsets, m))
    ref_inst = np.asarray(jnp.full((m,), FILL, jnp.int32).at[ref_dest].set(
        jnp.asarray(gauss), mode="drop"))

    out = tst.counting_sort(torch.tensor(ids), torch.tensor(gauss),
                            torch.tensor([n_live], dtype=torch.int32), n_bins,
                            FILL)
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(out.offsets.numpy(), np.asarray(ref_offsets))
    np.testing.assert_array_equal(out.inst.numpy(), ref_inst)
    live = ids < n_bins
    np.testing.assert_array_equal(out.dest.numpy()[live], ref_dest[live])
    # sentinels: the port writes the drop slot itself, the JAX kernel the
    # drop slot plus a rank (both dropped by the scatter)
    assert (out.dest.numpy()[~live] == m).all() and (ref_dest[~live] >= m).all()
    assert int(out.overflow) == max(n_live - m, 0)
    assert out.overflow.shape == () and out.overflow.dtype == torch.int32


def test_cpu_counting_sort_takes_the_plain_version():
    ids = torch.tensor([2, 0, 2, 3, 1, 2], dtype=torch.int32)
    gauss = torch.arange(6, dtype=torch.int32)
    before = (tst.tile_histogram_kernel.launches,
              tst.stable_tile_rank_kernel.launches)
    out = tst.counting_sort(ids, gauss, torch.tensor([5], dtype=torch.int32),
                            3, -1)
    assert (tst.tile_histogram_kernel.launches,
            tst.stable_tile_rank_kernel.launches) == before
    assert out.counts.tolist() == [1, 1, 2]
    assert out.offsets.tolist() == [0, 1, 2]
    assert out.dest.tolist() == [2, 0, 3, 6, 1, 6]
    assert out.inst.tolist() == [1, 4, 0, 2, -1, -1]


def test_launch_plan_fits_a_block_for_every_tile_grid():
    """``sort_plan`` mirrors ``csrc/sort_tiles.cu``: segments of SEGMENT ids
    (``csrc/segment.cuh``), one shared int per tile in a count block and,
    beside at most RANK_STATIC_LIMIT static bytes, in a rank block (within
    a block's 227 KB for every grid of 1 to 20,000 tiles, and refused past
    it)."""
    src = "\n".join((kernels.CSRC / f).read_text()
                    for f in ("segment.cuh", "sort_tiles.cu"))
    const = lambda name: int(eval(re.search(
        rf"constexpr int {name} = ([\d *]+);", src).group(1)))
    assert const("SEGMENT") == tst.SEGMENT
    assert const("RANK_STATIC_LIMIT") == tst.RANK_STATIC_LIMIT
    for n_bins in range(1, 20_001):
        plan = tst.sort_plan(428_032, n_bins)
        assert plan.count_shared == 4 * n_bins
        assert plan.count_shared < plan.rank_shared <= tst.SHARED_LIMIT
    s = tst.SEGMENT
    assert [tst.sort_plan(m, 40).segments for m in (0, 1, s, s + 1, 800_768)] \
        == [1, 1, 1, 2, -(-800_768 // s)]
    largest = (tst.SHARED_LIMIT - tst.RANK_STATIC_LIMIT) // 4
    assert tst.sort_plan(1, largest).rank_shared == tst.SHARED_LIMIT
    for n_bins in (0, largest + 1):
        with pytest.raises(ValueError, match="do not fit"):
            tst.sort_plan(1, n_bins)
