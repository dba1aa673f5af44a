"""The port's segmented row sums (kernel K3's plain version on the CPU)
against the JAX package's prefix-scan reduction (``_scan_kernel`` in
interpret mode, then the boundary gathers), and the port's own contract:
rows read through ``dest``, ranges clipped, segments written through
``order``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.ops.segscan import segment_sums_from_ranges as jsegsum
from event3dgs_tpu_torch.ops import segscan

torch.set_num_threads(1)


def random_segments(seed, n_seg, min_len, max_len):
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, n_seg)
    ends = np.cumsum(lens).astype(np.int32)
    starts = (ends - lens).astype(np.int32)
    rows = (rng.normal(size=(int(ends[-1]), 9)) * 100).astype(np.float32)
    abs_sums = np.stack([np.abs(rows[a:b].astype(np.float64)).sum(0)
                         for a, b in zip(starts, ends)])
    exact = np.stack([rows[a:b].astype(np.float64).sum(0)
                      for a, b in zip(starts, ends)])
    return rows, starts, ends, abs_sums, exact


def port_segment_sums(rows, starts, ends):
    """Contiguous ranges of ``rows``: ``dest`` and ``order`` the identity."""
    rows = torch.tensor(rows)
    dest = torch.arange(rows.shape[0], dtype=torch.int32)
    order = torch.arange(len(starts), dtype=torch.int32)
    return segscan.segment_sums(rows, torch.tensor(starts), torch.tensor(ends),
                                rows.shape[0], dest, order).numpy()


@pytest.mark.parametrize("seed,n_seg,min_len,max_len",
                         [(0, 100, 32, 64), (1, 40, 100, 400), (2, 200, 32, 48),
                          (3, 60, 8, 16)])
def test_segment_sums_match_jax(seed, n_seg, min_len, max_len):
    """Against the JAX prefix scan (interpret mode) at rtol 1e-5 of each
    segment's absolute sum.  The scan's own error grows with the prefix
    (eps·|prefix|, its docstring's bound), so the segments here are long
    enough (8+ rows) and the buffers short enough (< 10k rows) for the
    JAX result to stay inside that tolerance; the port is held to the
    exact sums at 1e-6."""
    rows, starts, ends, abs_sums, exact = random_segments(seed, n_seg,
                                                          min_len, max_len)
    ref = np.asarray(jsegsum(jnp.asarray(rows), jnp.asarray(starts),
                             jnp.asarray(ends), interpret=True))
    got = port_segment_sums(rows, starts, ends)
    assert (np.abs(got - ref) <= 1e-5 * abs_sums).all()
    assert (np.abs(got - exact) <= 1e-6 * abs_sums).all()


def test_segment_sums_error_is_per_segment():
    """Short segments after a long prefix: each port sum is exact to
    eps·|segment| (f32 adds in order), where the scan's error grows with
    the prefix."""
    rows, starts, ends, abs_sums, exact = random_segments(3, 4000, 1, 3)
    got = port_segment_sums(rows, starts, ends)
    assert (np.abs(got - exact) <= 4 * np.finfo(np.float32).eps * abs_sums).all()


def test_segment_sums_follow_dest_and_order():
    """Row e is read through dest[e] (out of range → a zero row), ranges
    are clipped to the limit, segment s lands in output row order[s]."""
    rows = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    dest = torch.tensor([9, 0, 10, 3, 3, 2], dtype=torch.int32)
    starts = torch.tensor([0, 2, 5], dtype=torch.int32)
    ends = torch.tensor([2, 5, 7], dtype=torch.int32)
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = segscan.segment_sums(rows, starts, ends, 6, dest, order)
    np.testing.assert_array_equal(out.numpy(), [[12, 14], [4, 5], [18, 20]])
