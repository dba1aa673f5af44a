"""The port's per-Gaussian tables, depth order and instance expansion (the
table kernel's and K4's plain versions, on the CPU) against the JAX
package: its per-Gaussian prep in ``event3dgs_tpu/ops/binning.py``
(rects, counts, cull data, sort key, ``argsort`` and offsets) and its
Pallas expansion kernel in interpret mode on edge cases of the instance
segments; and the expansion's launch plan.

The CUDA kernels are held against the plain versions in
tests/test_torch_kernels.py, which also makes the edge cases used here.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.ops import binning as jb
from event3dgs_tpu_torch.ops import binning as tb
from event3dgs_tpu_torch.ops import expand as tex
from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops import sort_tiles as tst
from test_torch_binning import (
    assert_rows_are_segment_histograms,
    jax_expand,
    port_inputs,
    scene,
)
from test_torch_kernels import EXPAND_CARD_ONLY, EXPAND_CASES

torch.set_num_threads(1)


def jax_prep(proj, opac, cull, width, height):
    """The JAX binning's per-Gaussian prep (``bin_gaussians``, lines
    272-305 of event3dgs_tpu/ops/binning.py) as (rect, cull, key) arrays in
    the port's layout."""
    tiles_x, tiles_y = jb.tile_grid(width, height)
    conic = proj.conic if cull else None
    opacities = opac if cull else None
    mx, my, x0, y0, x1, y1 = jb._binning_rect(
        proj.mean2d, proj.radius, conic, opacities, tiles_x, tiles_y)
    rw = jnp.maximum(x1 - x0, 0)
    rh = jnp.maximum(y1 - y0, 0)
    counts = jnp.where(proj.valid, rw * rh, 0)
    o = opacities if opacities is not None else jnp.ones_like(proj.radius)
    qthr = 2.0 * jnp.maximum(jnp.log(255.0 * jnp.maximum(o, 1e-12)), 0.0)
    if conic is not None:
        ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
        pd = (ca > 1e-12) & (cc > 1e-12) & (ca * cc - cb * cb > 1e-12)
        nba = jnp.where(pd, -cb / jnp.where(pd, ca, 1.0), 0.0)
        nbc = jnp.where(pd, -cb / jnp.where(pd, cc, 1.0), 0.0)
        ca, cb, cc = (jnp.where(pd, v, 0.0) for v in (ca, cb, cc))
    else:
        ca = cb = cc = nba = nbc = jnp.zeros_like(proj.radius)
    key = jnp.where(counts > 0, proj.depth, jnp.inf)
    rect = np.stack([np.asarray(v) for v in (x0, y0, rw, counts)], axis=1)
    cull_rows = np.stack([np.asarray(v, np.float32) for v in
                          (mx, my, ca, cb, cc, nba, nbc, qthr)], axis=1)
    return rect, cull_rows, np.asarray(key, np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_plain_tables_match_jax_prep(scene):
    """Rects, counts and keys of every Gaussian, and the cull rows of every
    Gaussian with instances, bit for bit; ``qthr`` within one ulp, since
    the CPU ``log`` of PyTorch and of XLA differ by one ulp on some inputs
    (4 of the 400 Gaussians of the aniso scene).  On the card the table
    kernel equals the plain version bit for bit (test_torch_kernels.py)."""
    _, cam, proj, opac, _, cull = scene
    out = tb.gaussian_tables(width=cam.width, height=cam.height,
                             **port_inputs(proj, opac, cull))
    rect, cull_rows, key = jax_prep(proj, opac, cull, cam.width, cam.height)
    np.testing.assert_array_equal(out.rect.numpy(), rect)
    np.testing.assert_array_equal(bits(out.key.numpy()), bits(key))
    live = rect[:, 3] > 0
    assert live.sum() > 0
    port, ref = bits(out.cull.numpy()[live]), bits(cull_rows[live])
    np.testing.assert_array_equal(port[:, :7], ref[:, :7])
    assert np.abs(port[:, 7].astype(np.int64) - ref[:, 7]).max() <= 1


def test_depth_order_matches_jax(scene):
    """The stable depth order and the instance offsets in it: the JAX
    binning's ``argsort`` and scan of the counts."""
    _, cam, proj, opac, cap, cull = scene
    tables = tb.gaussian_tables(width=cam.width, height=cam.height,
                                **port_inputs(proj, opac, cull))
    ranks = tb.depth_order(tables, cap)
    rect, _, key = jax_prep(proj, opac, cull, cam.width, cam.height)
    order = np.asarray(jnp.argsort(jnp.asarray(key)))
    offsets = np.r_[0, np.cumsum(rect[order, 3])]
    np.testing.assert_array_equal(ranks.order.numpy(), order)
    np.testing.assert_array_equal(ranks.offsets.numpy(), offsets)
    assert ranks.order.dtype == ranks.offsets.dtype == torch.int32
    # each live segment's first slot lies in its rank's range
    first = np.arange(tst.segments(cap)) * tst.SEGMENT
    live = first < min(offsets[-1], cap)
    r = ranks.seg_rank.numpy()[live]
    assert (offsets[r] <= first[live]).all() and (first[live] < offsets[r + 1]).all()


@pytest.mark.parametrize("case", sorted(set(EXPAND_CASES) - EXPAND_CARD_ONLY))
def test_plain_expand_edge_cases_match_jax_kernel(case):
    """K4's plain version against the JAX kernel where a rank's range
    crosses a segment boundary, a segment holds 2,048 one-instance ranks,
    the cap ends inside a segment, the instances overflow the cap, there
    are none, and there is one Gaussian; its count rows against K5."""
    c = EXPAND_CASES[case]()
    args = c.args()
    ref_tile, ref_g = jax_expand(*args)
    out = tex.expand_instances(*args, count_rows=True)
    np.testing.assert_array_equal(out.tile.numpy(), ref_tile)
    np.testing.assert_array_equal(out.gauss.numpy(), ref_g)
    assert_rows_are_segment_histograms(out, c.offsets, c.num_tiles)
    live = (out.tile < c.num_tiles).sum()
    total = int(c.offsets[-1])
    assert live <= min(total, c.cap)
    if case != "no_instances":
        assert live > 0
    if case == "overflow":
        assert total > c.cap


def test_edge_cases_are_what_they_say():
    """The edge cases' instance totals, caps and rank spans."""
    total = lambda c: int(c.offsets[-1])
    s = tst.SEGMENT
    c = EXPAND_CASES["cross_segment"]()
    cross = ((c.offsets[:-1] < s) & (c.offsets[1:] > s)).nonzero()
    assert len(cross) == 1 and int(c.offsets[int(cross[0]) + 1]
                                   - c.offsets[int(cross[0])]) == 96
    c = EXPAND_CASES["one_instance_ranks"]()
    assert torch.equal(c.offsets[:s + 1], torch.arange(s + 1, dtype=torch.int32))
    c = EXPAND_CASES["half_segment"]()
    assert c.cap == 3072 and s < total(c) < c.cap
    c = EXPAND_CASES["overflow"]()
    assert total(c) > c.cap
    assert total(EXPAND_CASES["no_instances"]()) == 0
    assert EXPAND_CASES["one_gaussian"]().order.shape == (1,)
    c = EXPAND_CASES["zero_ranks_between"]()
    assert int(torch.searchsorted(c.offsets, s - 1, right=True)) - 1 == 3 * (s - 1)


def test_expand_plan_mirrors_the_source():
    """``expand_plan`` mirrors ``csrc/expand.cu``: segments of SEGMENT slots
    (``csrc/segment.cuh``, shared with the counting sort), a 48-byte row
    and a 4-byte mark per slot beside at most EXPAND_STATIC_LIMIT static
    bytes, and one int per tile where the block counts tiles; so do the
    depth order's tiles, blocks and state (``csrc/depth_sort.cu``)."""
    src = "\n".join((kernels.CSRC / f).read_text()
                    for f in ("segment.cuh", "expand.cu", "depth_sort.cu"))

    def const(name):  # a constant's value, the constants it names resolved
        expr = re.search(rf"constexpr int {name} = ([\w *]+);", src).group(1)
        return int(eval(re.sub(r"[A-Z_]+", lambda m: str(const(m.group(0))),
                               expr)))

    assert const("SEGMENT") == tst.SEGMENT == tex.SEGMENT
    assert const("EXPAND_STATIC_LIMIT") == tex.EXPAND_STATIC_LIMIT
    assert const("OFFSETS_TILE") == tb.OFFSETS_TILE
    assert const("SORT_TILE") == tb.SORT_TILE
    assert const("SORT_TILE_SMALL") == tb.SORT_TILE_SMALL
    assert const("SORT_LARGE") == tb.SORT_LARGE
    assert const("RADIX") == tb.RADIX == 1 << const("RADIX_BITS")
    assert const("PASSES") == tb.PASSES
    assert const("PASS_LOOKBACK") == tb.PASS_LOOKBACK
    # the control words, then a word per tile and digit, then a 64-bit
    # word per offsets block
    assert [tb.lookback_words(n) for n in (0, 1, 2048, 2049, 100_000)] == [
        5124 + 2, 5124 + 256 + 2, 5124 + 256 + 2, 5124 + 2 * 256 + 4,
        5124 + 49 * 256 + 49 * 2]
    assert tex.SEGMENT_SHARED == const("SEGMENT") * (const("ROW_BYTES")
                                                    + const("MARK_BYTES"))
    assert "#include \"segment.cuh\"" in (kernels.CSRC / "sort_tiles.cu").read_text()
    largest = (tst.SHARED_LIMIT - tex.EXPAND_STATIC_LIMIT
               - tex.SEGMENT_SHARED) // 4
    for tiles, fits in ((1, True), (2040, True), (8160, True), (largest, True),
                        (largest + 1, False)):
        assert tex.expand_plan(800_768, tiles).counts == fits
    for cap in (1024, 2048, 3072, 428_032, 800_768):
        assert tex.expand_plan(cap, 2040).segments == -(-cap // tst.SEGMENT)


def test_cpu_dispatch_takes_the_plain_tables_and_expansion():
    c = EXPAND_CASES["cross_segment"]()
    args = c.args()
    before = (tb.gaussian_tables_kernel.launches,
              tex.expand_instances_kernel.launches)
    out = tex.expand_instances(*args, count_rows=True)
    ref = tex.expand_instances_plain(*args, count_rows=True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tex.expand_instances(*args).rows is None
    mean2d = torch.tensor([[40.0, 20.0], [100.0, 30.0]])
    tables = tb.gaussian_tables(mean2d, torch.tensor([2.0, 1.0]),
                                torch.tensor([9.0, 40.0]),
                                torch.tensor([True, True]), 128, 64)
    assert tables.rect.tolist() == [[0, 0, 2, 2], [1, 0, 3, 6]]
    assert tables.key.tolist() == [2.0, 1.0]
    assert tb.depth_order(tables, 1024).order.tolist() == [1, 0]
    assert (tb.gaussian_tables_kernel.launches,
            tex.expand_instances_kernel.launches) == before
