"""The port's tile binning (the table kernel, the depth order, K4, K5, K6
and their plain versions) against the JAX package's Pallas binning,
exactly.

On the CPU the port runs the plain versions; the JAX kernels run in
interpret mode, as the JAX suite runs them.  The CUDA kernels are held
against the plain versions in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.core import make_camera
from event3dgs_tpu.ops.binning import bin_gaussians as jbin
from event3dgs_tpu.ops.binning import count_instances as jcount
from event3dgs_tpu.ops.expand import expand_instances as jexpand
from event3dgs_tpu.ops.projection import project_gaussians
from event3dgs_tpu.ops.sort_tiles import counting_sort_buckets
from event3dgs_tpu_torch.ops import binning as tb
from event3dgs_tpu_torch.ops import expand as tex
from event3dgs_tpu_torch.ops import sort_tiles as tst
from event3dgs_tpu_torch.core import make_camera as port_camera
from event3dgs_tpu_torch.ops.projection import \
    project_gaussians as port_project

torch.set_num_threads(1)


def make_proj(n=300, seed=0, w=256, h=64):
    """tests/test_binning.py's scene."""
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, w, h)
    rng = np.random.default_rng(seed)
    means = jnp.asarray(
        np.c_[rng.uniform(-1.5, 1.5, n), rng.uniform(-0.6, 0.6, n),
              rng.uniform(2, 8, n)], jnp.float32)
    scales = jnp.asarray(
        np.exp(rng.uniform(np.log(0.02), np.log(0.3), (n, 1)))
        * rng.uniform(0.7, 1.4, (n, 3)), jnp.float32)
    rots = jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.2, 0.95, n), jnp.float32)
    return cam, project_gaussians(means, scales, rots, cam, opacities=opac), opac


def make_aniso_proj(n=200, seed=5, w=256, h=96, ratio=8.0):
    """tests/test_binning.py's anisotropic scene."""
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, w, h)
    rng = np.random.default_rng(seed)
    means = jnp.asarray(
        np.c_[rng.uniform(-1.2, 1.2, n), rng.uniform(-0.5, 0.5, n),
              rng.uniform(2, 6, n)], jnp.float32)
    base = np.exp(rng.uniform(np.log(0.05), np.log(0.25), (n, 1)))
    aniso = np.stack([np.full(n, 1.0), np.full(n, 1.0 / ratio),
                      np.full(n, 1.0)], axis=1)
    scales = jnp.asarray(base * aniso, jnp.float32)
    rots = jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.3, 0.95, n), jnp.float32)
    return cam, project_gaussians(means, scales, rots, cam, opacities=opac), opac


# (scene builder, kwargs, instance_cap, with the alpha-bbox/ellipse cull)
SCENES = {
    "seed0": (make_proj, dict(seed=0), 4096, False),
    "seed1": (make_proj, dict(seed=1), 4096, False),
    "overflow": (make_proj, dict(n=500, seed=2), 1024, False),
    "aniso": (make_aniso_proj, dict(), 8192, True),
}


def t(a):
    return torch.tensor(np.asarray(a))


def port_inputs(proj, opac, cull):
    return dict(
        mean2d=t(proj.mean2d), depth=t(proj.depth), radius=t(proj.radius),
        valid=t(proj.valid), opacities=t(opac) if cull else None,
        conic=t(proj.conic) if cull else None,
    )


def tile_lists(offsets, counts, inst):
    return [inst[o:o + c].tolist() for o, c in zip(offsets, counts)]


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    build, kw, cap, cull = SCENES[request.param]
    cam, proj, opac = build(**kw)
    return request.param, cam, proj, opac, cap, cull


def test_bin_gaussians_matches_jax_exactly(scene):
    name, cam, proj, opac, cap, cull = scene
    extra = dict(opacities=opac, conic=proj.conic) if cull else {}
    ref = jbin(proj.mean2d, proj.depth, proj.radius, proj.valid, cam.width,
               cam.height, cap, 128, use_counting_sort=True, **extra)
    out = tb.bin_gaussians(width=cam.width, height=cam.height,
                           instance_cap=cap, **port_inputs(proj, opac, cull))
    counts = out.tile_counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref.tile_counts))
    assert tile_lists(out.tile_offsets.numpy(), counts, out.inst_gauss.numpy()) \
        == tile_lists(np.asarray(ref.tile_offsets), np.asarray(ref.tile_counts),
                      np.asarray(ref.inst_gauss))
    assert int(out.overflow) == int(ref.overflow)
    if name == "overflow":
        assert int(out.overflow) > 0
    assert counts.sum() > 0
    # the port's ranges are contiguous from 0; the tail is the sentinel N
    n = proj.mean2d.shape[0]
    np.testing.assert_array_equal(out.tile_offsets.numpy(),
                                  np.cumsum(counts) - counts)
    assert (out.inst_gauss.numpy()[counts.sum():] == n).all()


def test_bin_gaussians_on_the_radix_passes_matches_jax_exactly(scene,
                                                              monkeypatch):
    """The whole ``Binning`` with the depth order taken by the radix
    sort's passes (``radix_order_plain``, the card kernels' mirror) in
    place of ``argsort``: equal to the JAX binning's tile lists, and its
    order and rank offsets to the JAX binning's (``jnp.argsort`` and
    ``associative_scan``, ``event3dgs_tpu/ops/binning.py:305-328``)."""
    name, cam, proj, opac, cap, cull = scene
    extra = dict(opacities=opac, conic=proj.conic) if cull else {}
    ref = jbin(proj.mean2d, proj.depth, proj.radius, proj.valid, cam.width,
               cam.height, cap, 128, use_counting_sort=True, **extra)
    monkeypatch.setattr(tb, "depth_order_plain", tb.radix_order_plain)
    out = tb.bin_gaussians(width=cam.width, height=cam.height,
                           instance_cap=cap, **port_inputs(proj, opac, cull))
    np.testing.assert_array_equal(out.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(out.offsets.numpy(),
                                  np.asarray(ref.rank_offsets))
    counts = out.tile_counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref.tile_counts))
    assert tile_lists(out.tile_offsets.numpy(), counts, out.inst_gauss.numpy()) \
        == tile_lists(np.asarray(ref.tile_offsets), np.asarray(ref.tile_counts),
                      np.asarray(ref.inst_gauss))


# the depth order's key sets: ties, all equal, every count 0 (all +inf),
# every count live, digits constant in some radix passes (words varying in
# their low 8 bits), ±0.0, denormals, infinities, negatives, NaNs of both
# signs and several payloads
KEY_SETS = ("ties", "all_equal", "all_dead", "all_live", "skip",
            "signed_zeros", "denormals", "infinities", "negatives", "nans")


def key_set(name, n, seed):
    """(keys, counts) of a key set, from numpy's seeded generator: counts
    0-11 (0 where the key is +inf and the set is of the table kernel's
    kind) or 1-11 where every Gaussian is live, 0 where every one is
    dead."""
    rng = np.random.default_rng(seed)
    pick = lambda pool: np.asarray(pool, np.float32)[rng.integers(0, len(pool), n)]
    counts = rng.integers(0, 12, n).astype(np.int32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    if name == "ties":
        key = pick([0.5, 1.0, 1.0, 2.0, 7.25])
    elif name == "all_equal":
        key = np.full(n, 3.5, np.float32)
    elif name == "all_dead":
        key, counts = np.full(n, np.inf, np.float32), np.zeros(n, np.int32)
    elif name == "all_live":
        key = rng.uniform(0.2, 80.0, n).astype(np.float32)
        counts = rng.integers(1, 12, n).astype(np.int32)
    elif name == "skip":  # live: a +inf key would vary the high digits
        key = (rng.integers(0, 256, n).astype(np.uint32)
               | 0x40000000).view(np.float32)
        counts = rng.integers(1, 12, n).astype(np.int32)
    elif name == "signed_zeros":
        key = pick([0.0, -0.0, 1.0, -1.0, np.inf])
    elif name == "denormals":
        key = pick([1e-45, -1e-45, 1e-40, -1e-40, 0.0, -0.0, 1.2e-38])
    elif name == "infinities":
        key = pick([np.inf, -np.inf, 5.0])
    elif name == "negatives":
        key = rng.uniform(-50.0, 50.0, n).astype(np.float32)
    else:
        key = np.where(rng.random(n) < 0.3, nans[rng.integers(0, 4, n)],
                       pick([-np.inf, -2.0, 0.0, 3.0, np.inf]))
    if name == "ties":  # as the table kernel writes
        key = np.where(counts > 0, key, np.float32(np.inf))
    return key.astype(np.float32), counts


def key_tables(key, counts):
    n = key.shape[0]
    rect = torch.zeros(n, 4, dtype=torch.int32)
    rect[:, 3] = torch.from_numpy(counts)
    return tb.GaussianTables(rect=rect, cull=torch.zeros(n, 8),
                             key=torch.from_numpy(key))


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 100_000])
@pytest.mark.parametrize("name", KEY_SETS)
def test_radix_order_plain_matches_argsort_and_jax(name, n):
    """``radix_order_plain`` (the radix sort's passes, its skip rule and
    its offsets) equal to ``depth_order_plain`` (``torch.argsort`` and
    ``cumsum``) on every key set, exactly; both equal to ``jnp.argsort``
    of the same keys and the JAX binning's ``associative_scan`` of the
    counts in that order (``event3dgs_tpu/ops/binning.py:306,326``), but
    for denormals, which XLA on the CPU compares as zeros: there the JAX
    order is the port's order of the keys with denormals flushed."""
    key, counts = key_set(name, n, KEY_SETS.index(name))
    tables = key_tables(key, counts)
    cap = tb.suggest_instance_cap(int(counts.sum()))
    got = tb.radix_order_plain(tables, cap)
    want = tb.depth_order_plain(tables, cap)
    for field, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), field
    plan = tb.radix_plan(tb.ordered_keys(tables.key))
    if name in ("all_equal", "all_dead") or n <= 1:
        assert plan == [tb.PASSES - 1]
    elif name == "skip":
        assert plan == [0]
    order = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
    scan = (np.asarray(jax.lax.associative_scan(
        jnp.add, jnp.asarray(counts)[order])) if n else np.zeros(0, np.int32))
    if name == "denormals":
        flushed = np.where(np.abs(key) < np.finfo(np.float32).tiny,
                           np.float32(0.0), key)
        np.testing.assert_array_equal(
            order, tb.radix_order_plain(key_tables(flushed, counts),
                                        cap).order.numpy())
        assert n < 2 or not np.array_equal(order, got.order.numpy())
        return
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(got.offsets.numpy(), np.r_[0, scan])


def test_table_keys_are_never_nan():
    """The depth order's kernel orders every NaN after +inf, where the
    card's ``torch.argsort`` puts a NaN with its sign bit set first: the
    table kernel never writes a NaN key.  Its key is the projection's
    depth where the count is positive, +inf else, and the projection's
    depth is its view z where the Gaussian is valid (in front of the near
    plane), +inf else, so NaN or infinite means, scales, rotations and
    opacities give keys that are positive or +inf (the table kernel and
    the preprocess forward equal these plain versions bit for bit on the
    card, ``tests/test_torch_kernels.py``)."""
    rng = np.random.default_rng(11)
    n = 64
    means = np.c_[rng.uniform(-1, 1, n), rng.uniform(-0.5, 0.5, n),
                  rng.uniform(-3, 8, n)].astype(np.float32)
    scales = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    bad = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    for k, v in enumerate(bad):
        means[k, k % 3] = v
        scales[8 + k, k % 3] = v
        rots[16 + k] = v
        opac[24 + k] = v
        means[32 + k, 2] = v
    rots[40] = 0.0
    f = lambda a: torch.from_numpy(a)
    cam = port_camera(np.eye(3), np.zeros(3), 1.0, 0.8, 96, 64, device="cpu")
    proj = port_project(f(means), f(scales), f(rots), cam, opacities=f(opac))
    tables = tb.gaussian_tables(proj.mean2d, proj.depth, proj.radius,
                                proj.valid, 96, 64, opacities=f(opac),
                                conic=proj.conic)
    assert not torch.isnan(tables.key).any()
    assert (tables.key > 0).all()
    assert (tables.rect[:, 3] > 0).any() and torch.isinf(tables.key).any()


def test_count_instances_matches(scene):
    _, cam, proj, opac, _, cull = scene
    extra = dict(conic=proj.conic, opacities=opac) if cull else {}
    ref = int(jcount(proj.mean2d, proj.radius, proj.valid, cam.width,
                     cam.height, **extra))
    inp = port_inputs(proj, opac, cull)
    out = int(tb.count_instances(inp["mean2d"], inp["radius"], inp["valid"],
                                 cam.width, cam.height, conic=inp["conic"],
                                 opacities=inp["opacities"]))
    assert out == ref


def jax_expand(rect, cull, offsets, order, seg_rank, cap, tiles_x, num_tiles):
    """The JAX kernel (interpret mode) on the port's Gaussian-order tables,
    fed in depth order as the JAX binning feeds it (K4's arguments; the JAX
    kernel finds its own starting ranks)."""
    o = order.long()
    sorted_cols = np.concatenate(
        [rect[o, :3].numpy().astype(np.float32), cull[o].numpy()], axis=1
    )  # the JAX kernel's [N, 11] layout: x0 y0 rw mx my ca cb cc nba nbc qthr
    tile, g = jexpand(jnp.asarray(offsets.numpy()), jnp.asarray(order.numpy()),
                      jnp.asarray(sorted_cols), cap, tiles_x, num_tiles,
                      interpret=True)
    return np.asarray(tile), np.asarray(g)


def test_plain_expand_matches_jax_kernel(scene):
    """K4's plain version (Gaussian-order tables and the depth order)
    against the JAX kernel fed the tables in depth order; its count rows
    against K5's plain histogram per segment and, summed, the JAX K5
    histogram (tests/test_torch_expand.py)."""
    _, cam, proj, opac, cap, cull = scene
    inp = port_inputs(proj, opac, cull)
    tables = tb.gaussian_tables(width=cam.width, height=cam.height, **inp)
    ranks = tb.depth_order(tables, cap)
    tiles_x, tiles_y = tb.tile_grid(cam.width, cam.height)
    args = (tables.rect, tables.cull, *ranks, cap, tiles_x, tiles_x * tiles_y)
    ref_tile, ref_g = jax_expand(*args)
    out = tex.expand_instances(*args, count_rows=True)
    np.testing.assert_array_equal(out.tile.numpy(), ref_tile)
    np.testing.assert_array_equal(out.gauss.numpy(), ref_g)
    assert_rows_are_segment_histograms(out, ranks.offsets, tiles_x * tiles_y)


def assert_rows_are_segment_histograms(out, offsets, num_tiles):
    """K4's count rows: per segment, K5's plain histogram of its tiles;
    over all segments, the JAX K5 histogram."""
    n_live = offsets[-1:]
    s = tst.SEGMENT
    assert out.rows.shape == (tst.sort_plan(out.tile.shape[0], num_tiles).segments,
                              num_tiles)
    for k, row in enumerate(out.rows):
        ref = tst.tile_histogram_plain(out.tile[k * s:(k + 1) * s], num_tiles,
                                       torch.clamp(n_live - k * s, min=0))
        assert torch.equal(row, ref), k
    live = min(int(n_live), out.tile.shape[0])
    ref_counts, _ = counting_sort_buckets(jnp.asarray(out.tile.numpy()),
                                          num_tiles, interpret=True,
                                          n_live=live)
    np.testing.assert_array_equal(out.rows.sum(0).numpy(),
                                  np.asarray(ref_counts))


@pytest.mark.parametrize("m,n_bins,n_live", [(4096, 40, 3000), (2048, 300, 2048)])
def test_plain_counting_sort_matches_jax_kernels(m, n_bins, n_live):
    rng = np.random.default_rng(m + n_bins)
    ids = rng.integers(0, n_bins + 1, m).astype(np.int32)  # incl. sentinels
    ids[n_live:] = n_bins
    ref_counts, ref_dest = counting_sort_buckets(
        jnp.asarray(ids), n_bins, interpret=True, n_live=n_live
    )
    counts = tst.tile_histogram(t(ids), n_bins, t([n_live]).int())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    offsets = (np.cumsum(counts.numpy()) - counts.numpy()).astype(np.int32)
    dest = tst.stable_tile_rank(t(ids), t([n_live]).int(), n_bins, t(offsets), m)
    ref = np.asarray(ref_dest(jnp.asarray(offsets), m))
    live = ids < n_bins
    d = dest.numpy()
    np.testing.assert_array_equal(d[live], ref[live])
    # sentinels: the port writes the drop slot itself, the JAX kernel the
    # drop slot plus a rank (both dropped by the scatter that follows)
    assert (ref[~live] >= m).all()
    # a stable counting sort: the destinations are a permutation of the
    # live slots and keep index order inside each bucket
    assert sorted(d[live]) == list(range(live.sum()))
    assert (d[~live] == m).all()
