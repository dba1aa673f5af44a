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


def sequential_sums(rows, starts, ends, limit, dest, order):
    """An independent reference of the contract: float32 sums in
    expansion order from 0, one segment at a time."""
    rows = np.asarray(rows, np.float32)
    out = np.zeros((len(starts), rows.shape[1]), np.float32)
    for s, (a, b) in enumerate(zip(starts, ends)):
        a = min(max(int(a), 0), limit)
        b = max(min(max(int(b), 0), limit), a)
        acc = np.zeros(rows.shape[1], np.float32)
        for e in range(a, b):
            r = int(dest[e])
            if 0 <= r < rows.shape[0]:
                acc = acc + rows[r]
        out[order[s]] = acc
    return out


def scan_tolerance(rows):
    """The JAX scan's bound, eps·|prefix|, with the prefix taken over the
    whole buffer: its carry runs across every row, in 128-row blocks (a
    factor 4 for the two boundary values it subtracts and their rounding)."""
    return 4 * np.finfo(np.float32).eps * np.abs(
        rows.astype(np.float64)).sum(0)


def _lengths_case(rng, lens, n_rows=None, drop=0.0):
    """Contiguous ranges of ``lens``; ``dest`` a permutation of the rows
    (a share ``drop`` of it past ``n_rows``), ``order`` a permutation."""
    ends = np.cumsum(lens).astype(np.int32)
    starts = (ends - lens).astype(np.int32)
    total = int(ends[-1]) if len(ends) else 0
    n_rows = total if n_rows is None else n_rows
    rows = (rng.normal(size=(n_rows, 9)) * 10).astype(np.float32)
    dest = rng.permutation(max(total, n_rows))[:total].astype(np.int32)
    dropped = rng.random(total) < drop
    dest[dropped] = n_rows + rng.integers(0, 5, int(dropped.sum()))
    order = rng.permutation(len(lens)).astype(np.int32)
    return rows, starts, ends, dest, order


def _check_contract(rows, starts, ends, limit, dest, order):
    t = lambda a: torch.tensor(np.asarray(a))
    got = segscan.segment_sums(t(rows), t(starts), t(ends), limit, t(dest),
                               t(order)).numpy()
    want = sequential_sums(rows, starts, ends, limit, dest, order)
    np.testing.assert_array_equal(got, want)
    return got


def test_segment_sums_tail_of_empty_segments_match_jax():
    """Segments of 0-3 rows, then a tail of empty ones (culled Gaussians
    sort last): exact sequential sums, zero rows for the tail, and the
    JAX prefix scan within its eps·|prefix| bound on the same ranges."""
    rng = np.random.default_rng(11)
    lens = np.r_[rng.integers(0, 4, 700), np.zeros(300, np.int64)]
    rows, starts, ends, _, _ = _lengths_case(rng, lens)
    ident = np.arange(rows.shape[0], dtype=np.int32)
    order = np.arange(len(lens), dtype=np.int32)
    got = _check_contract(rows, starts, ends, rows.shape[0], ident, order)
    assert not got[700:].any()
    ref = np.asarray(jsegsum(jnp.asarray(rows), jnp.asarray(starts),
                             jnp.asarray(ends), interpret=True))
    assert (np.abs(got - ref) <= scan_tolerance(rows)).all()


def test_segment_sums_one_long_segment_among_short_ones():
    """One segment of 5,000 rows among segments of 0-3, read through a
    permuted ``dest`` and written through a permuted ``order``: each sum
    is the sequential one bit for bit; the JAX scan agrees on the same
    rows in expansion order within its eps·|prefix| bound."""
    rng = np.random.default_rng(12)
    lens = rng.integers(0, 4, 600)
    lens[217] = 5000
    rows, starts, ends, dest, order = _lengths_case(rng, lens)
    got = _check_contract(rows, starts, ends, int(ends[-1]), dest, order)
    ordered = rows[dest]
    ref = np.asarray(jsegsum(jnp.asarray(ordered), jnp.asarray(starts),
                             jnp.asarray(ends), interpret=True))
    assert (np.abs(got[order] - ref) <= scan_tolerance(ordered)).all()


def test_segment_sums_dest_past_the_rows_count_as_zero():
    """A third of ``dest`` points past ``n_rows`` (the counting sort's
    ``drop_dest`` and beyond): those rows add nothing."""
    rng = np.random.default_rng(13)
    lens = rng.integers(0, 5, 400)
    rows, starts, ends, dest, order = _lengths_case(rng, lens, drop=0.33)
    assert (dest >= rows.shape[0]).sum() > 100
    _check_contract(rows, starts, ends, int(ends[-1]), dest, order)
    kept = np.where(dest < rows.shape[0], dest, -1)
    _check_contract(rows, starts, ends, int(ends[-1]), kept, order)


@pytest.mark.parametrize("where", [0.0, 0.3, 0.7, 0.99])
def test_segment_sums_limit_cuts_a_segment(where):
    """``limit`` one row into a segment of 2+ rows (the first such segment
    from ``where`` of the way along): its rows from ``limit`` on and every
    later segment's count as empty."""
    rng = np.random.default_rng(14)
    lens = rng.integers(0, 6, 300)
    rows, starts, ends, dest, order = _lengths_case(rng, lens)
    k = int(where * len(lens))
    k += int(np.argmax(lens[k:] >= 2))
    cut = int(starts[k]) + 1
    assert starts[k] < cut < ends[k]
    got = _check_contract(rows, starts, ends, cut, dest, order)
    assert not got[order[k + 1:]].any()
    assert got[order[k]].any()


def test_k3_takes_output_order_only_past_its_share_of_the_l2():
    """K3 sums rows of 9 floats in output order once its [N, 9] sums
    outgrow ``BY_OUTPUT_L2`` of the card's L2, in rank order below that,
    and rows of other widths always in rank order."""
    l2 = 50 * 2**20  # the H100's
    edge = int(segscan.BY_OUTPUT_L2 * l2) // 36
    assert not segscan.by_output_order(9, 100_000, l2)
    assert not segscan.by_output_order(9, edge, l2)
    assert segscan.by_output_order(9, edge + 1, l2)
    assert segscan.by_output_order(9, 2_097_152, l2)
    assert not segscan.by_output_order(3, 10**8, l2)
    assert not segscan.by_output_order(16, 10**8, l2)
