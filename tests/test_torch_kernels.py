"""The port's CUDA kernels (the preprocess forward and backward, K1-K6 and
the binning's table kernel) against their plain PyTorch versions, the
wrappers' dispatch rules, and the event frames accumulated on the card
against the CPU's.

This file imports neither JAX nor the JAX package, so on a machine with a
card and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

Tests marked ``gpu`` need a CUDA card and skip without one; the others run
anywhere.
"""

import ctypes
import dataclasses
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from event3dgs_tpu_torch.core import make_camera
from event3dgs_tpu_torch.models import activated, params_from_numpy
from event3dgs_tpu_torch.ops import binning, expand, kernels, segscan, sort_tiles
from event3dgs_tpu_torch.ops import preprocess as pre
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.ops.projection import ProjectedGaussians, project_gaussians
from event3dgs_tpu_torch.ops.render import render

torch.set_num_threads(1)


def scene_inputs(n, seed, w, h, spread=1.2, z=(2.0, 6.0), scale=(0.03, 0.25),
                 ratio=1.0, opacity=(0.2, 0.95), device="cpu"):
    """Random Gaussians in front of an identity camera: (means, scales,
    rotations, opacities, colors, camera)."""
    rng = np.random.default_rng(seed)
    means = np.c_[rng.uniform(-spread, spread, n),
                  rng.uniform(-spread * 0.4, spread * 0.4, n), rng.uniform(*z, n)]
    scales = (np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)) * [1.0, 1.0 / ratio, 1.0])
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(*opacity, n)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, w, h, device=device)
    return f(means), f(scales), f(rots), f(opac), f(colors), cam


def scene(n, seed, w, h, device="cpu", **kw):
    """Random Gaussians in front of an identity camera, projected."""
    means, scales, rots, opac, colors, cam = scene_inputs(n, seed, w, h,
                                                          device=device, **kw)
    proj = project_gaussians(means, scales, rots, cam, opacities=opac)
    return proj, colors, opac, w, h


# the binning and rasterizer scenes of the JAX suite, plus one wide frame
SCENES = {
    "binning_seed0": dict(n=300, seed=0, w=256, h=64, spread=1.5, z=(2, 8),
                          scale=(0.02, 0.3)),
    "binning_aniso": dict(n=200, seed=5, w=256, h=96, ratio=8.0, z=(2, 6),
                          scale=(0.05, 0.25)),
    "dense_opaque": dict(n=150, seed=1, w=256, h=64, spread=0.3),
    "multi_tile_rows": dict(n=60, seed=2, w=384, h=96),
    "wide_frame": dict(n=20000, seed=3, w=1280, h=720, spread=3.0, z=(2, 10),
                       scale=(0.005, 0.05)),
}


def edge_scene(n, seed, w, h, device="cpu"):
    """Thin splats (axis ratio 8-40, along x or y) centred on the edges of
    the 16×8 sub-blocks the warps of K1 and K2 own: the warp cull removes
    most of their visits."""
    rng = np.random.default_rng(seed)
    mean2d = np.c_[rng.integers(0, w // 16 + 1, n) * 16.0,
                   rng.integers(0, h // 8 + 1, n) * 8.0]
    mean2d += rng.choice([-0.5, -1e-3, 0.0, 1e-3, 0.5], (n, 2))
    major = rng.uniform(2.0, 12.0, n)
    minor = np.maximum(major / rng.uniform(8.0, 40.0, n), 0.3)
    theta = rng.choice([0.0, np.pi / 2], n) + rng.normal(0.0, 0.02, n)
    c, s = np.cos(theta), np.sin(theta)
    # covariance R·diag(major², minor²)·Rᵀ and its inverse, the conic
    cxx = c * c * major ** 2 + s * s * minor ** 2
    cyy = s * s * major ** 2 + c * c * minor ** 2
    cxy = c * s * (major ** 2 - minor ** 2)
    det = cxx * cyy - cxy * cxy
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    proj = ProjectedGaussians(
        mean2d=f(mean2d), depth=f(rng.uniform(1.0, 10.0, n)),
        conic=f(np.c_[cyy / det, -cxy / det, cxx / det]),
        radius=f(np.ceil(3.0 * major)), valid=torch.ones(n, dtype=torch.bool,
                                                         device=device))
    colors = rng.uniform(0.0, 1.0, (n, 3))
    return proj, f(colors), f(rng.uniform(0.3, 0.99, n)), w, h


# scenes that stress the compositing kernels' batching and warp cull:
# name → function(device) that makes the scene
HARD_SCENES = {
    # tiles of ~700 instances, pixels stopping inside K1's second batch
    "deep_tiles": lambda device: scene(n=3000, seed=6, w=64, h=64, spread=0.6,
                                       scale=(0.02, 0.08), opacity=(0.05, 0.5),
                                       device=device),
    "thin_edges": lambda device: edge_scene(300, 7, 128, 64, device=device),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")


# the edge cases of preprocess_scene: a share of the Gaussians each
EDGE_CASES = ("behind the near plane", "off-screen", "past the fov clamp",
              "covariance overflow", "dead slot", "colour clamped at 0",
              "opacity below 1/255")


def preprocess_arrays(n, seed, w=256, h=144, sh_degree=3, coeffs=None,
                      edge=False, overflow=1e20):
    """Seeded inputs of the preprocess as float64 numpy arrays: means,
    scales, rotations (not normalised), opacities, [N, K, 3] features, and
    the camera's pose (R, t), fields of view and size.  A random pose, or
    with ``edge`` the identity pose and about an eighth of the Gaussians in
    each of ``EDGE_CASES`` (the covariance's overflow from scales of
    ``overflow``), and the first one at the camera centre (its direction
    0/0)."""
    rng = np.random.default_rng(seed)
    k = coeffs or (sh_degree + 1) ** 2
    means = np.c_[rng.uniform(-1.5, 1.5, n), rng.uniform(-0.8, 0.8, n),
                  rng.uniform(1.0, 8.0, n)]
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.3), (n, 3)))
    rots = rng.normal(size=(n, 4)) * rng.uniform(0.2, 5.0, (n, 1))
    opac = rng.uniform(0.05, 1.0, n)
    feats = rng.normal(0.0, 0.3, (n, k, 3))
    fov = (1.0, 0.7)
    if edge:
        R, t = np.eye(3), np.zeros(3)
        case = rng.integers(0, len(EDGE_CASES) + 1, n)  # 0: none
        sign = rng.choice([-1.0, 1.0], n)
        z = means[:, 2]
        tan_x = np.tan(fov[0] / 2)
        for j, name in enumerate(EDGE_CASES, start=1):
            sel = case == j
            if name == "behind the near plane":
                means[sel, 2] = rng.uniform(-2.0, 0.2, sel.sum())
            elif name == "off-screen":
                means[sel, 0] = sign[sel] * z[sel] * rng.uniform(1.0, 6.0, sel.sum())
            elif name == "past the fov clamp":  # large: some reach the image
                means[sel, 2] = rng.uniform(1.0, 3.0, sel.sum())
                means[sel, 0] = (sign[sel] * means[sel, 2] * tan_x * 1.3
                                 * rng.uniform(1.01, 1.4, sel.sum()))
                scales[sel] = rng.uniform(0.3, 0.8, (sel.sum(), 3))
            elif name == "covariance overflow":
                scales[sel] = overflow
            elif name == "dead slot":
                opac[sel] = 0.0
            elif name == "colour clamped at 0":
                feats[sel, 0, :] = -4.0
            elif name == "opacity below 1/255":
                opac[sel] = 1e-3
        if n:
            means[0] = 0.0  # the camera centre
    else:
        q = rng.normal(size=4) * [4, 0.2, 0.2, 0.2]
        q /= np.linalg.norm(q)
        qw, qx, qy, qz = q
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)]])
        t = rng.uniform(-0.3, 0.3, 3)
    return dict(means=means, scales=scales, rots=rots, opac=opac,
                feats=feats, R=R, t=t, fov=fov, w=w, h=h)


def preprocess_scene(n, seed, w=256, h=144, sh_degree=3, coeffs=None,
                     edge=False, device="cpu", dtype=torch.float32):
    """:func:`preprocess_arrays` as tensors of ``dtype`` on ``device``:
    (means, scales, rotations, opacities, features, camera)."""
    a = preprocess_arrays(n, seed, w, h, sh_degree, coeffs, edge,
                          overflow=1e20 if dtype == torch.float32 else 1e200)
    cam = make_camera(a["R"], a["t"], *a["fov"], w, h, device=device)
    if dtype != torch.float32:
        cam = dataclasses.replace(cam, **{
            fld: getattr(cam, fld).to(dtype) for fld in (
                "world_view", "full_proj", "camera_center", "tan_fovx",
                "tan_fovy")})
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return (f(a["means"]), f(a["scales"]), f(a["rots"]), f(a["opac"]),
            f(a["feats"]), cam)


def assert_bits_equal(got, want, what=""):
    """Equal bit for bit (a NaN where the other has one)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype != torch.float32:
        assert torch.equal(got, want), what
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


# the forward kernel's cases: (N, seed, SH degree, edge, scaling modifier,
# with opacities, with features)
PREPROCESS_FWD = [
    (257, 0, 3, False, 1.0, True, True), (257, 1, 3, True, 1.0, True, True),
    (255, 2, 0, True, 0.6, True, True), (1, 3, 1, False, 1.0, True, True),
    (0, 4, 3, False, 1.0, True, True), (3000, 5, 2, True, 1.0, False, True),
    (3000, 6, 4, True, 0.6, True, True), (3000, 7, 3, True, 1.0, True, False),
    (100_000, 8, 3, False, 1.0, True, True),
]


class ExpansionCase(NamedTuple):
    """K4's inputs: tables in Gaussian order, offsets and order by rank."""

    rect: torch.Tensor  # [N, 4] int32 x0, y0, rw, count
    cull: torch.Tensor  # [N, 8] float32
    offsets: torch.Tensor  # [N+1] int32
    order: torch.Tensor  # [N] int32
    seg_rank: torch.Tensor  # [segments] int32 rank of each segment's first slot
    cap: int
    tiles_x: int
    num_tiles: int

    def to(self, device):
        return self._replace(**{f: getattr(self, f).to(device) for f in
                                ("rect", "cull", "offsets", "order", "seg_rank")})

    def args(self):
        """K4's arguments."""
        return (self.rect, self.cull, self.offsets, self.order, self.seg_rank,
                self.cap, self.tiles_x, self.num_tiles)


def expansion_case(sizes, cap, seed, tiles_x=60, tiles_y=34) -> ExpansionCase:
    """Synthetic K4 inputs on the CPU: one rank per (rect width, rect
    height) of ``sizes``, in that depth order, placed at random Gaussian
    ids, with random rects on a 1080p tile grid and ellipse-cull data that
    drops some of their tiles (a tenth of them degenerate, never culling)."""
    rng = np.random.default_rng(seed)
    n = len(sizes)
    rw, rh = (np.array([s[k] for s in sizes], np.int64).reshape(n) for k in (0, 1))
    counts = rw * rh
    x0 = rng.integers(0, tiles_x - np.maximum(rw, 1) + 1)
    y0 = rng.integers(0, tiles_y - np.maximum(rh, 1) + 1)
    mx = (x0 + rw / 2) * 32 + rng.normal(0, 8, n)
    my = (y0 + rh / 2) * 32 + rng.normal(0, 8, n)
    sx, sy = rng.uniform(4, 40, n) * np.maximum(rw, 1), rng.uniform(4, 40, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx, cyy = c * c * sx ** 2 + s * s * sy ** 2, s * s * sx ** 2 + c * c * sy ** 2
    cxy = c * s * (sx ** 2 - sy ** 2)
    det = cxx * cyy - cxy * cxy
    ca, cb, cc = cyy / det, -cxy / det, cxx / det
    pd = rng.uniform(size=n) > 0.1
    ca, cb, cc = ca * pd, cb * pd, cc * pd
    nba = np.where(pd, -cb / np.where(pd, ca, 1), 0)
    nbc = np.where(pd, -cb / np.where(pd, cc, 1), 0)
    qthr = 2 * np.log(255 * rng.uniform(0.05, 1.0, n))
    perm = rng.permutation(n)  # the Gaussian of each rank
    rect = np.zeros((n, 4), np.int32)
    cull = np.zeros((n, 8), np.float32)
    rect[perm] = np.c_[x0, y0, rw, counts]
    cull[perm] = np.c_[mx, my, ca, cb, cc, nba, nbc, qthr]
    offsets = np.r_[0, np.cumsum(counts)].astype(np.int32)
    starts = np.arange(sort_tiles.segments(cap)) * sort_tiles.SEGMENT
    seg_rank = np.clip(np.searchsorted(offsets, starts, side="right") - 1, 0,
                       n - 1)
    return ExpansionCase(torch.tensor(rect), torch.tensor(cull),
                         torch.tensor(offsets), torch.tensor(perm, dtype=torch.int32),
                         torch.tensor(seg_rank, dtype=torch.int32), cap, tiles_x,
                         tiles_x * tiles_y)


# K4 edge cases: name → function that makes the case (on the CPU)
EXPAND_CASES = {
    # a 12×8 rect's 96 instances across the boundary of segments 0 and 1
    "cross_segment": lambda: expansion_case(
        [(3, 2)] * 330 + [(12, 8)] + [(2, 2)] * 700 + [(0, 0)] * 20, 8192, 1),
    # segment 0 holds 2,048 one-instance ranks (the widest rank window)
    "one_instance_ranks": lambda: expansion_case(
        [(1, 1)] * 3000 + [(4, 3)] * 50 + [(0, 2)] * 10, 4096, 2),
    # a cap of 3,072: the last segment is half of one, partly live
    "half_segment": lambda: expansion_case([(2, 3)] * 430 + [(0, 0)] * 5,
                                           3072, 3),
    # 6,000 instances for a cap of 2,048
    "overflow": lambda: expansion_case([(4, 3)] * 500, 2048, 4),
    # offsets[N] = 0
    "no_instances": lambda: expansion_case([(0, 0)] * 40 + [(3, 0)] * 10,
                                           2048, 5),
    "one_gaussian": lambda: expansion_case([(3, 2)], 1024, 6),
    # zero-count ranks between the live ones (never so in a binning, whose
    # depth order puts them last; the JAX kernel assumes it): segment 0
    # spans 6,142 ranks
    "zero_ranks_between": lambda: expansion_case(
        [(1, 1), (0, 0), (5, 0)] * 2100 + [(2, 2)] * 300, 8192, 7),
}
# cases outside the JAX kernel's assumptions (held against the plain version
# only)
EXPAND_CARD_ONLY = {"zero_ranks_between"}


def tables_scene(name, variant, device):
    """A test scene's projection outputs, with some Gaussians made hard for
    the table kernel by ``variant``."""
    proj, _, opac, w, h = scene(**SCENES[name], device=device)
    mean2d, conic, radius, valid, depth = (proj.mean2d.clone(), proj.conic.clone(),
                                           proj.radius.clone(), proj.valid.clone(),
                                           proj.depth.clone())
    n = mean2d.shape[0]
    k = torch.arange(n, device=device)
    if variant == "degenerate":
        # singular, indefinite, zero and NaN conics; NaN means on culled
        # Gaussians (projection leaves them unconstrained)
        conic[k % 7 == 0] = torch.tensor([1.0, 1.0, 1.0], device=device)
        conic[k % 7 == 1] = torch.tensor([-0.5, 0.1, 0.2], device=device)
        conic[k % 7 == 2] = 0.0
        conic[k % 11 == 3] = float("nan")
        cull = k % 13 == 4
        valid[cull], radius[cull], depth[cull] = False, 0.0, float("inf")
        mean2d[cull] = float("nan")
    elif variant == "opacity_edges":
        # opacities at and around 1/255, and 0, tiny and 1
        edge = torch.tensor([1 / 255, np.nextafter(1 / 255, 0),
                             np.nextafter(1 / 255, 1), 0.0, 1e-13, 1.0],
                            dtype=torch.float32, device=device)
        opac = opac.clone()
        opac[k % 3 == 0] = edge[(k[k % 3 == 0] // 3) % 6]
    elif variant == "no_conic":
        conic = None
    elif variant == "no_opacity":
        opac = None
    return (mean2d, depth, radius, valid, w, h), dict(opacities=opac, conic=conic)


TABLE_VARIANTS = ("plain", "degenerate", "opacity_edges", "no_conic",
                  "no_opacity")


def assert_tables_equal(tk, tp):
    """Rects, counts and keys of every Gaussian, and the cull rows of every
    Gaussian with instances, bit for bit."""
    assert torch.equal(tk.rect, tp.rect)
    assert torch.equal(tk.key.view(torch.int32), tp.key.view(torch.int32))
    live = tp.rect[:, 3] > 0
    assert torch.equal(tk.cull[live].view(torch.int32),
                       tp.cull[live].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("variant", TABLE_VARIANTS)
def test_table_kernel_matches_plain_version(name, variant):
    need_card()
    args, kw = tables_scene(name, variant, "cuda")
    before = binning.gaussian_tables_kernel.launches
    tk = binning.gaussian_tables(*args, **kw)
    assert binning.gaussian_tables_kernel.launches == before + 1
    tp = binning.gaussian_tables_plain(*args, **kw)
    assert_tables_equal(tk, tp)
    torch.cuda.synchronize()


def depth_tables(n, seed, device):
    """Random sort keys (ties among them, +inf where the count is 0) and
    instance counts, as the table kernel leaves them (its look-back state
    cleared)."""
    g = torch.Generator().manual_seed(seed)
    count = torch.randint(0, 12, (n,), generator=g, dtype=torch.int32)
    count[torch.rand(n, generator=g) < 0.3] = 0
    key = torch.randint(0, max(n // 4, 1), (n,), generator=g).float()
    key[count == 0] = float("inf")
    rect = torch.zeros(n, 4, dtype=torch.int32)
    rect[:, 3] = count
    return binning.GaussianTables(
        rect=rect.to(device), cull=torch.zeros(n, 8, device=device),
        key=key.to(device),
        lookback=torch.zeros(binning.lookback_words(n), dtype=torch.int64,
                             device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 100_000, 400_000])
def test_depth_offsets_kernel_matches_plain_version(n):
    """The depth offsets kernel (order cast, counts gathered in depth order,
    their prefix by a decoupled look-back over blocks of 2,048 ranks) equal
    to its plain version, on one block, on a block boundary and on 49 and
    196 blocks, twice on the same state."""
    need_card()
    tables = depth_tables(n, n, "cuda")
    cap = suggest_cap(int(tables.rect[:, 3].sum()))
    before = binning.depth_order_kernel.launches
    k = binning.depth_order(tables, cap)
    assert binning.depth_order_kernel.launches == before + 1
    p = binning.depth_order_plain(tables, cap)
    assert_depth_order_equal(k, p, cap)
    # the kernel leaves its state cleared: a second call repeats the first
    assert not tables.lookback.any()
    assert_depth_order_equal(binning.depth_order(tables, cap), p, cap)
    torch.cuda.synchronize()


def suggest_cap(total):
    """An instance cap for ``total`` instances: a multiple of 1,024 below it
    where there are many (the segments past it unwritten), else above."""
    return max(total // 2 // 1024 * 1024, 1024) if total > 4096 else \
        binning.suggest_instance_cap(total)


def assert_depth_order_equal(k, p, cap):
    """Order and offsets, and the first ranks of the live segments."""
    assert torch.equal(k.order, p.order) and torch.equal(k.offsets, p.offsets)
    live = -(-min(int(p.offsets[-1]), cap) // sort_tiles.SEGMENT)
    assert torch.equal(k.seg_rank[:live], p.seg_rank[:live])


def expansion_rows_live(exp, offsets, cap):
    """The count rows of the live segments (the kernel writes no other)."""
    live = min(int(offsets[-1]), cap)
    return exp.rows[:-(-live // sort_tiles.SEGMENT)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_kernel_edge_cases_match_plain_version(case):
    """K4 (tile, gauss and the count rows of the live segments) bit-equal to
    its plain version; the counting sort from K4's rows equal to the
    counting sort that counts for itself."""
    need_card()
    c = EXPAND_CASES[case]().to("cuda")
    args = c.args()
    before = expand.expand_instances_kernel.launches
    k = expand.expand_instances(*args, count_rows=True)
    assert expand.expand_instances_kernel.launches == before + 1
    p = expand.expand_instances_plain(*args, count_rows=True)
    assert torch.equal(k.tile, p.tile) and torch.equal(k.gauss, p.gauss)
    assert torch.equal(expansion_rows_live(k, c.offsets, c.cap),
                       expansion_rows_live(p, c.offsets, c.cap))
    n_live, n = c.offsets[-1:], c.order.shape[0]
    counted = sort_tiles.counting_sort(k.tile, k.gauss, n_live, c.num_tiles,
                                       n, base=k.rows)
    itself = sort_tiles.counting_sort(k.tile, k.gauss, n_live, c.num_tiles, n)
    for field, a, b in zip(counted._fields, counted, itself):
        assert torch.equal(a, b), field
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cap", [None, 1024])
def test_binning_kernels_match_plain_versions(name, cap):
    need_card()
    proj, _, opac, w, h = scene(**SCENES[name], device="cuda")
    cap = cap or rt.default_instance_cap(proj.mean2d.shape[0])
    args = (proj.mean2d, proj.depth, proj.radius, proj.valid, w, h)
    kw = dict(opacities=opac, conic=proj.conic)
    tables = binning.gaussian_tables(*args, **kw)
    assert_tables_equal(tables, binning.gaussian_tables_plain(*args, **kw))
    ranks = binning.depth_order(tables, cap)
    assert_depth_order_equal(ranks, binning.depth_order_plain(tables, cap), cap)
    tiles_x, tiles_y = binning.tile_grid(w, h)
    nt = tiles_x * tiles_y
    k = expand.expand_instances(tables.rect, tables.cull, *ranks, cap, tiles_x,
                                nt, count_rows=True)
    p = expand.expand_instances_plain(tables.rect, tables.cull, *ranks, cap,
                                      tiles_x, nt, count_rows=True)
    assert torch.equal(k.tile, p.tile) and torch.equal(k.gauss, p.gauss)
    assert torch.equal(expansion_rows_live(k, ranks.offsets, cap),
                       expansion_rows_live(p, ranks.offsets, cap))
    tk, n_live = k.tile, ranks.offsets[-1:]
    ck = sort_tiles.tile_histogram(tk, nt, n_live)
    assert torch.equal(ck, sort_tiles.tile_histogram_plain(tk, nt, n_live))
    starts = (torch.cumsum(ck, 0) - ck).to(torch.int32)
    dk = sort_tiles.stable_tile_rank(tk, n_live, nt, starts, cap)
    assert torch.equal(dk, sort_tiles.stable_tile_rank_plain(tk, n_live, nt,
                                                             starts, cap))
    n = proj.mean2d.shape[0]
    counted = sort_tiles.counting_sort(tk, k.gauss, n_live, nt, n, base=k.rows)
    itself = sort_tiles.counting_sort(tk, k.gauss, n_live, nt, n)
    for field, a, b in zip(counted._fields, counted, itself):
        assert torch.equal(a, b), field
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,m,n_live", [(40, 4096, 3000), (2040, 50_000, 50_000),
                                             (15_000, 9000, 100)])
def test_counting_sort_kernels_on_random_ids(n_bins, m, n_live):
    need_card()
    g = torch.Generator().manual_seed(n_bins)
    ids = torch.randint(0, n_bins + 1, (m,), generator=g, dtype=torch.int32)
    ids[n_live:] = n_bins
    ids, live = ids.cuda(), torch.tensor([n_live], dtype=torch.int32, device="cuda")
    counts = sort_tiles.tile_histogram_kernel(ids, n_bins, live)
    assert torch.equal(counts, sort_tiles.tile_histogram_plain(ids, n_bins, live))
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    dest = sort_tiles.stable_tile_rank_kernel(ids, live, n_bins, starts, m)
    assert torch.equal(dest, sort_tiles.stable_tile_rank_plain(ids, live, n_bins,
                                                               starts, m))


def _random_ids(m, n_bins, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, n_bins + 1, (m,), generator=g, dtype=torch.int32)


# counting-sort edge cases: name → (ids, n_live, n_bins), on the CPU
SORT_CASES = {
    # the train view's instance cap, every id in one tile of a 1080p grid
    "one_tile": lambda: (torch.full((428_032,), 1234, dtype=torch.int32),
                         428_032, 2040),
    "no_live": lambda: (_random_ids(20_000, 2040, 1), 0, 2040),
    "live_past_ids": lambda: (_random_ids(20_000, 2040, 2), 25_000, 2040),
    # the live count inside a segment, random ids past it (all sentinels)
    "live_off_segment": lambda: (_random_ids(50_000, 2040, 3), 3 * 4096 + 77,
                                 2040),
    "bins_8160": lambda: (_random_ids(300_000, 8160, 4), 290_001, 8160),
    "bins_15000": lambda: (_random_ids(120_000, 15_000, 5), 120_000, 15_000),
    "all_sentinels": lambda: (torch.full((50_000,), 2040, dtype=torch.int32),
                              50_000, 2040),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_counting_sort_edge_cases_match_plain_versions(case):
    """K5, K6 and the fused counting sort bit-equal to their plain versions
    on edge cases of the live count, the tile grid and the ids; the fused
    sort run twice gives bit-identical results."""
    need_card()
    ids, n_live, n_bins = SORT_CASES[case]()
    m = ids.shape[0]
    gauss = torch.randperm(m, generator=torch.Generator().manual_seed(m))
    ids, gauss = ids.cuda(), gauss.to(torch.int32).cuda()
    live = torch.tensor([n_live], dtype=torch.int32, device="cuda")
    counts = sort_tiles.tile_histogram_kernel(ids, n_bins, live)
    assert torch.equal(counts, sort_tiles.tile_histogram_plain(ids, n_bins, live))
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    dest = sort_tiles.stable_tile_rank_kernel(ids, live, n_bins, starts, m)
    assert torch.equal(dest, sort_tiles.stable_tile_rank_plain(ids, live, n_bins,
                                                               starts, m))
    fused = sort_tiles.counting_sort_kernel(ids, gauss, live, n_bins, -1)
    plain = sort_tiles.counting_sort_plain(ids, gauss, live, n_bins, -1)
    again = sort_tiles.counting_sort_kernel(ids, gauss, live, n_bins, -1)
    for field, k, p, a in zip(fused._fields, fused, plain, again):
        assert torch.equal(k, p), field
        assert torch.equal(k, a), field
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_graph_of_the_counting_sort_holds_its_three_functions():
    """One call of the fused counting sort captured in a CUDA graph holds
    one node of each of its CUDA functions and nothing else, as
    ``kernel_timing.graph_kernels`` reads the CUDA graph's DOT dump."""
    need_card()
    from event3dgs_tpu_torch.tools.kernel_timing import graph_kernels

    ids, n_live, n_bins = SORT_CASES["bins_8160"]()
    m = ids.shape[0]
    gauss = torch.randperm(m, generator=torch.Generator().manual_seed(m))
    ids, gauss = ids.cuda(), gauss.to(torch.int32).cuda()
    live = torch.tensor([n_live], dtype=torch.int32, device="cuda")
    nodes = graph_kernels(lambda: sort_tiles.counting_sort_kernel(
        ids, gauss, live, n_bins, -1))
    assert nodes == {"segment_count_kernel": 1, "scan_kernel": 1,
                     "rank_kernel": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES) + sorted(HARD_SCENES))
def test_whole_binning_matches_plain_version(name):
    """The kernel path's ``Binning`` (the table kernel, the depth offsets
    kernel, K4 and the fused counting sort from K4's count rows, one launch
    of each of them, K5 and K6) equal to the all-plain one."""
    need_card()
    make = HARD_SCENES.get(name) or (lambda device: scene(**SCENES[name],
                                                          device=device))
    proj, _, opac, w, h = make("cuda")
    args = (proj.mean2d, proj.depth, proj.radius, proj.valid, w, h,
            rt.default_instance_cap(proj.mean2d.shape[0]))
    wrappers = (binning.gaussian_tables_kernel, binning.depth_order_kernel,
                expand.expand_instances_kernel, sort_tiles.tile_histogram_kernel,
                sort_tiles.stable_tile_rank_kernel)
    before = [k.launches for k in wrappers]
    bk = binning.bin_gaussians(*args, opacities=opac, conic=proj.conic)
    assert [k.launches - b for k, b in zip(wrappers, before)] == [1] * 5
    bp = binning.bin_gaussians(*args, opacities=opac, conic=proj.conic,
                               plain=True)
    for field in ("inst_gauss", "tile_offsets", "tile_counts", "dest",
                  "overflow", "offsets", "order"):
        assert torch.equal(getattr(bk, field), getattr(bp, field)), field
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_binning_on_a_tile_grid_past_the_expansion_counts():
    """Where a segment's tile counts do not fit an expansion block's shared
    memory (32,000 tiles), K4 writes no count rows and the counting sort
    counts for itself; the ``Binning`` still equals the all-plain one."""
    need_card()
    w, h = 32 * 200, 32 * 160
    assert not expand.expand_plan(1 << 14, 200 * 160).counts
    proj, _, opac, _, _ = scene(n=3000, seed=8, w=w, h=h, spread=3.0,
                                scale=(0.01, 0.05), device="cuda")
    args = (proj.mean2d, proj.depth, proj.radius, proj.valid, w, h,
            rt.default_instance_cap(proj.mean2d.shape[0]))
    bk = binning.bin_gaussians(*args, opacities=opac, conic=proj.conic)
    bp = binning.bin_gaussians(*args, opacities=opac, conic=proj.conic,
                               plain=True)
    assert int(bp.tile_counts.sum()) > 0
    for field in ("inst_gauss", "tile_offsets", "tile_counts", "dest",
                  "overflow", "offsets", "order"):
        assert torch.equal(getattr(bk, field), getattr(bp, field)), field
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_composite_kernel_matches_plain_version(name):
    need_card()
    proj, colors, opac, w, h = scene(**SCENES[name], device="cuda")
    b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                              w, h, rt.default_instance_cap(proj.mean2d.shape[0]),
                              opacities=opac, conic=proj.conic)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    args = (b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x, w, h)
    rk, lk, sk = rt.composite_forward(*args)
    rp, lp, sp = rt.composite_forward_plain(*args)
    torch.testing.assert_close(rk, rp, atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.exp(lk), torch.exp(lp), atol=1e-6, rtol=0)
    assert torch.equal(sk, sp)  # the stop index K2 starts each pixel from
    full_k = rt.rasterize_tiled_partials(proj, colors, opac, w, h)
    full_p = rt.rasterize_tiled_partials(proj, colors, opac, w, h, plain=True)
    torch.testing.assert_close(full_k[0], full_p[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.exp(full_k[1]), torch.exp(full_p[1]),
                               atol=1e-6, rtol=0)


def _composite_inputs(name, device):
    """One scene's K1 arguments and K4's (tables and depth order)."""
    proj, colors, opac, w, h = scene(**SCENES[name], device=device)
    cap = rt.default_instance_cap(proj.mean2d.shape[0])
    targs = (proj.mean2d, proj.depth, proj.radius, proj.valid, w, h)
    b = binning.bin_gaussians(*targs, cap, opacities=opac, conic=proj.conic)
    tables = binning.gaussian_tables(*targs, opacities=opac, conic=proj.conic)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    return ((b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x,
             w, h),
            (tables.rect, tables.cull, *binning.depth_order(tables, cap), cap,
             b.num_tiles_x, b.tile_counts.shape[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["base", "clock"])
@pytest.mark.parametrize("name", ["dense_opaque", "wide_frame"])
def test_k1_probe_builds_with_the_shipping_arithmetic_equal_k1(name, variant):
    """The probes' K1 ``base`` (the shipping library) and ``clock`` (its
    arithmetic with block timers) give the shipping K1's outputs bit for
    bit; ``clock`` writes each block's entry before its exit."""
    from event3dgs_tpu_torch.tools import kernel_probes as kp

    need_card()
    args, _ = _composite_inputs(name, "cuda")
    v = kp.K1_VARIANTS[variant]
    clock = None
    if variant == "clock":
        clock = torch.zeros(args[2].shape[0], 2, dtype=torch.int64, device="cuda")
    got = v(*args, clock=clock)
    want = rt.composite_forward_kernel(*args)
    for g, k in zip(got, want):
        assert torch.equal(g, k)
    if variant == "base":
        assert kernels.library_path(v.source, v.defines) == \
            kernels.library_path("rasterize_fwd")
    else:
        assert bool((clock[:, 1] >= clock[:, 0]).all() and (clock[:, 0] > 0).all())


@pytest.mark.gpu
def test_every_probe_build_compiles_and_launches():
    """Each timing-only build of K1 and K4 compiles, reports its kernel to
    ``-Xptxas -v`` and launches on a small scene."""
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools import kernel_timing as kt

    need_card()
    logs = kernels.build(kp.variant_builds())
    k1_args, k4_args = _composite_inputs("binning_seed0", "cuda")
    for v in kp.variants():
        kernel = ("composite_forward_kernel" if v.kernel == "K1"
                  else "expand_kernel")
        assert kt.ptxas_report(logs[kernels.build_key(v.source, v.defines)],
                               kernel)["registers"] > 0
        clock = None
        if v.name == "clock":
            clock = torch.zeros(k1_args[2].shape[0], 2, dtype=torch.int64,
                                device="cuda")
        out = v(*k1_args, clock=clock) if v.kernel == "K1" else v(*k4_args)
        torch.cuda.synchronize()
        assert out[0].shape[0] > 0, v.label


@pytest.mark.gpu
def test_dyngrid_kernel_in_a_cuda_graph_serves_a_changing_count():
    """The probe kernel, captured once at capacity, replayed with n = 3 then
    n = 7 written into device memory: 3·1024, then 7·1024, bit-equal to
    the plain version; then over the seeded input, whose sums depend on
    the block order, at those counts, at 0, -1 and past capacity (clamped)
    and at 3 again, each bit-equal to the plain version."""
    from event3dgs_tpu_torch.tools import kernel_probes as kp

    need_card()
    rec = kp.dyngrid("cuda")
    assert rec["replays"] == {"3": 3072.0, "7": 7168.0}
    assert rec["equal_to_plain"] == {"3": True, "7": True}
    assert rec["order_sensitive"] == {"3": True, "7": True}
    assert rec["seeded_equal_to_plain"] == {
        str(n): True for n in kp.DYNGRID_SEEDED_COUNTS}
    assert rec["max_abs_err"] == 0.0


def _backward_inputs(name, cap, device):
    """One scene's binning, K1 outputs and random image cotangents."""
    proj, colors, opac, w, h = scene(**SCENES[name], device=device)
    cap = cap or rt.default_instance_cap(proj.mean2d.shape[0])
    b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                              w, h, cap, opacities=opac, conic=proj.conic,
                              plain=device == "cpu")
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    fwd = (b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x, w, h)
    _, logt, stop = rt.composite_forward_plain(*fwd)
    g = torch.Generator().manual_seed(7)
    g_rgb = torch.rand(h, w, 3, generator=g).to(device) - 0.5
    g_logt = torch.rand(h, w, generator=g).to(device) - 0.5
    return b, fwd + (g_rgb, g_logt, logt, stop, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cap", [None, 1024])
def test_backward_kernels_match_plain_versions(name, cap):
    """K2's rows within 1e-5 of its plain version (normalised by the max;
    the sums over a tile's pixels run in another order) and K3 bit-equal
    to its plain version, at the default cap and at cap 1024 (overflow on
    the large scenes; dropped instances have no slot and no gradient)."""
    need_card()
    b, args = _backward_inputs(name, cap, "cuda")
    before = rt.composite_backward_kernel.launches
    rows_k = rt.composite_backward(*args)
    assert rt.composite_backward_kernel.launches == before + 1
    rows_p = rt.composite_backward_plain(*args)
    live = int(b.tile_counts.sum())
    scale = rows_p[:live].abs().max().clamp(min=1e-12)
    torch.testing.assert_close(rows_k[:live] / scale, rows_p[:live] / scale,
                               atol=1e-5, rtol=0)
    before = segscan.segment_sums_kernel.launches
    gk = rt.gaussian_grads(b, rows_k)
    assert segscan.segment_sums_kernel.launches == before + 1
    assert torch.equal(gk, rt.gaussian_grads(b, rows_k, plain=True))
    assert torch.isfinite(gk).all()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(HARD_SCENES))
def test_composite_kernels_on_deep_and_culled_scenes(name):
    """K1 and K2 against their plain versions where tiles need several
    staging rounds and pixels stop inside them (``deep_tiles``) and where
    the warp cull removes most visits (``thin_edges``); K2 run twice gives
    bit-identical rows."""
    need_card()
    proj, colors, opac, w, h = HARD_SCENES[name]("cuda")
    cap = rt.default_instance_cap(proj.mean2d.shape[0])
    b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                              w, h, cap, opacities=opac, conic=proj.conic)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    fwd = (b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x, w, h)
    rk, lk, sk = rt.composite_forward_kernel(*fwd)
    rp, lp, sp = rt.composite_forward_plain(*fwd)
    torch.testing.assert_close(rk, rp, atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.exp(lk), torch.exp(lp), atol=1e-6, rtol=0)
    assert torch.equal(sk, sp)
    g = torch.Generator().manual_seed(7)
    g_rgb = (torch.rand(h, w, 3, generator=g) - 0.5).cuda()
    g_logt = (torch.rand(h, w, generator=g) - 0.5).cuda()
    args = fwd + (g_rgb, g_logt, lk, sk, cap)
    rows_k = rt.composite_backward_kernel(*args)
    rows_p = rt.composite_backward_plain(*args)
    live = int(b.tile_counts.sum())
    scale = rows_p[:live].abs().max().clamp(min=1e-12)
    torch.testing.assert_close(rows_k[:live] / scale, rows_p[:live] / scale,
                               atol=1e-5, rtol=0)
    assert torch.equal(rows_k[:live], rt.composite_backward_kernel(*args)[:live])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n_seg,n_rows,width", [(1, 10, 9), (5000, 40_000, 9),
                                                (300, 2000, 3)])
def test_segment_sum_kernel_on_random_rows(n_seg, n_rows, width):
    need_card()
    g = torch.Generator().manual_seed(n_seg)
    rows = torch.randn(n_rows, width, generator=g)
    lens = torch.randint(0, 2 * n_rows // n_seg + 1, (n_seg,), generator=g)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(lens, 0)])
    dest = torch.randint(0, n_rows + 1, (int(offsets[-1]),), generator=g)
    order = torch.randperm(n_seg, generator=g)
    cuda = lambda t: t.to(torch.int32).cuda()
    args = (rows.cuda(), cuda(offsets[:-1]), cuda(offsets[1:]),
            min(n_rows, int(offsets[-1])))
    for index in ((dest, order),  # through dest and order, as the rasterizer
                  (torch.arange(len(dest)), torch.arange(n_seg))):  # identity
        index = tuple(cuda(t) for t in index)
        assert torch.equal(segscan.segment_sums_kernel(*args, *index),
                           segscan.segment_sums_plain(*args, *index))


def long_tailed_segments(n_seg, n_empty, slots, seed=0):
    """K3's inputs at the shape of the 2M-slot step: ``n_seg`` contiguous
    segments of Poisson(1.2) rows, one in a hundred with a Zipf tail of up
    to 5,000 more, the last ``n_empty`` empty (culled Gaussians sort
    last); ``dest`` [slots] the instances' rows, a permutation of the
    ``slots`` rows with a tenth dropped past them; ``order`` a
    permutation."""
    rng = np.random.default_rng(seed)
    n_live = n_seg - n_empty
    lens = rng.poisson(1.2, n_live)
    tail = rng.random(n_live) < 0.01
    lens[tail] += np.minimum(rng.zipf(1.8, int(tail.sum())), 5000)
    lens = np.r_[lens, np.zeros(n_empty, np.int64)]
    offsets = np.r_[0, np.cumsum(lens)].astype(np.int32)
    total = int(offsets[-1])
    assert total <= slots
    # one entry per slot, as the counting sort's: past the instances and
    # for a tenth of them the drop value
    dest = np.full(slots, slots, np.int32)
    dest[:total] = rng.permutation(slots)[:total]
    dest[:total][rng.random(total) < 0.1] = slots
    order = rng.permutation(n_seg).astype(np.int32)
    rows = (rng.standard_normal((slots, 9), np.float32) * 10)
    cuda = lambda a: torch.from_numpy(a).cuda()
    off = cuda(offsets)
    return (cuda(rows), off[:-1], off[1:], slots, cuda(dest), cuda(order))


@pytest.mark.gpu
@pytest.mark.parametrize("by_output", [None, False, True],
                         ids=["wrapper", "rank_order", "output_order"])
def test_segment_sum_kernel_at_2m_size(by_output):
    """K3 bit-equal to its plain version at the 2M-slot step's shape:
    2,097,152 segments, about 2.6M instances over 4,127,744 slots with
    long-tailed lengths (up to 5,000) and the trailing segments empty; in
    the order the wrapper picks there (output order) and in each order."""
    need_card()
    args = long_tailed_segments(2_097_152, 197_152, 4_127_744)
    n_inst = int(args[2][-1])
    assert 2_300_000 < n_inst < 2_900_000
    before = segscan.segment_sums_kernel.launches
    if by_output is None:
        assert segscan.by_output_order(9, 2_097_152, torch.cuda.get_device_properties(
            0).L2_cache_size)
        got = segscan.segment_sums(*args)
    else:
        got = segscan.segment_sums_kernel(*args, by_output=by_output)
    assert segscan.segment_sums_kernel.launches == before + 1
    assert torch.equal(got, segscan.segment_sums_plain(*args))
    assert not got[args[5][-197_152:].long()].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("by_output", [False, True],
                         ids=["rank_order", "output_order"])
def test_segment_sum_kernel_in_a_cuda_graph(by_output):
    """K3 captured in a CUDA graph, in each order: each replay equals the
    plain version on the rows its static buffer holds at that time."""
    need_card()
    args = long_tailed_segments(60_000, 5_000, 120_000, seed=1)
    rows = args[0]
    segscan.segment_sums_kernel(*args, by_output=by_output)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segscan.segment_sums_kernel(*args, by_output=by_output)
    g = torch.Generator().manual_seed(3)
    for k in range(3):
        if k:
            rows.copy_(torch.randn(rows.shape, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, segscan.segment_sums_plain(*args))
    graph.reset()


@pytest.mark.gpu
def test_tiled_gradients_on_card_match_cpu():
    """The autograd path (binning + K1 forward, K2 + K3 backward) on the
    card against the plain path on the CPU, gradients of all four inputs."""
    need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        proj, colors, opac, w, h = scene(**SCENES["binning_seed0"], device=dev)
        leaves = [proj.mean2d.detach().requires_grad_(True),
                  proj.conic.detach().requires_grad_(True),
                  colors.requires_grad_(True), opac.requires_grad_(True)]
        p = proj._replace(mean2d=leaves[0], conic=leaves[1])
        wgt = torch.linspace(-1, 1, h * w * 3).reshape(h, w, 3).to(dev)
        img = rt.rasterize_tiled(p, leaves[2], leaves[3],
                                 torch.tensor([0.1, 0.2, 0.3], device=dev), w, h)
        out[dev] = [g.cpu() for g in torch.autograd.grad((img * wgt).sum(), leaves)]
    for gk, gp in zip(out["cuda"], out["cpu"]):
        scale = gp.abs().max()
        torch.testing.assert_close(gk / scale, gp / scale, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_render_on_card_matches_cpu_render():
    need_card()
    rng = np.random.default_rng(4)
    n = 500
    fields = dict(
        xyz=np.c_[rng.uniform(-1, 1, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(2, 5, n)],
        features_dc=rng.normal(0, 0.5, (n, 1, 3)),
        features_rest=rng.normal(0, 0.1, (n, 15, 3)),
        scaling=np.log(rng.uniform(0.02, 0.1, (n, 3))),
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(0, 1, (n, 1)),
        alive=rng.uniform(size=n) > 0.1,
    )
    out = {}
    for dev in ("cpu", "cuda"):
        a = activated(params_from_numpy(fields, device=dev))
        cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.7, 200, 120, device=dev)
        out[dev] = render(a.means3d, a.features, a.opacities, a.scales,
                          a.rotations, cam, torch.zeros(3, device=dev),
                          sh_degree=3, rasterizer="tiled").image.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=2e-5, rtol=1e-4)


def accumulation_streams():
    """Event streams at 1080p: random pixels, repeated pixels (the last
    event must win), ``x`` past the row (wraps) or past the image and ``y``
    past the image (dropped)."""
    rng = np.random.default_rng(21)
    w, h, n = 1920, 1080, 2_000_000
    x = rng.integers(0, w, n)
    y = rng.integers(0, h, n)
    p = rng.integers(0, 2, n)
    rep = rng.integers(0, 8, n)
    wrap_x = x.copy()
    wrap_x[: n // 10] = rng.integers(w, 3 * w, n // 10)
    wrap_x[n // 10: n // 10 + 100] = 1_000_000
    wrap_y = y.copy()
    wrap_y[:1000] = h + rng.integers(0, 5, 1000)
    return w, h, {
        "random": (x, y, p),
        "repeated_pixels": (rep % 4, rep // 4, p),
        "x_past_the_row": (wrap_x, y, p),
        "y_past_the_image": (x, wrap_y, p),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["event_count_image", "accumulation_frame",
                                "polarity_frame", "color_polarity_frame"])
def test_accumulation_on_card_equals_cpu(fn):
    """The event frames built on the card (atomic adds, an ``amax`` scatter)
    equal the CPU's exactly: counts are sums of ±1.0 in float32, and the
    last event of a pixel is found by its index, not by write order."""
    need_card()
    from event3dgs_tpu_torch.events import accumulate

    w, h, cases = accumulation_streams()
    for case, (x, y, p) in cases.items():
        want = getattr(accumulate, fn)(x, y, p, w, h, device="cpu")
        got = getattr(accumulate, fn)(x, y, p, w, h, device="cuda")
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), case
        on_card = [torch.as_tensor(a, device="cuda") for a in (x, y, p)]
        assert torch.equal(getattr(accumulate, fn)(*on_card, w, h, device="cuda").cpu(),
                           want), case


def graph_scene(capacity=512):
    """A small event-mode scene on the card: 400 Gaussians in ``capacity``
    slots, 12 views at 160×96."""
    from event3dgs_tpu_torch.data.synthetic import make_synthetic_scene
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.train import SceneData, init_train_state

    sc = make_synthetic_scene(n_gaussians=400, n_views=12, width=160,
                              height=96, device="cuda")
    params = init_from_point_cloud(sc.points, sc.colors, capacity=capacity,
                                   device="cuda")
    data = SceneData(cameras=sc.cameras, images=sc.images,
                     event_cameras=sc.cameras, event_images=sc.images)
    return init_train_state(params, spatial_lr_scale=sc.extent), data, sc.extent


@pytest.mark.gpu
def test_graphed_loop_matches_eager_loop():
    """``fused_steps`` 8 (a CUDA graph of the step, replayed) against the
    eager loop: 30 event iterations with one densify at 10 that grows the
    capacity and rebuilds the step at a new instance cap, so the graph is
    captured at the start and again after iteration 10.  The kernels
    launch in the warm-up steps and the captures only, never in a replay."""
    from event3dgs_tpu_torch.train import train_loop
    from event3dgs_tpu_torch.train.fused import WARMUP_STEPS
    from event3dgs_tpu_torch.train.loop import TrainCallbacks
    from event3dgs_tpu_torch.utils.config import OptimizationConfig, TrainConfig

    need_card()
    state, data, extent = graph_scene()
    opt = OptimizationConfig(densify_from_iter=2, densification_interval=10,
                             densify_until_iter=15, densify_grad_threshold=0.0)
    wrappers = (rt.composite_forward_kernel, rt.composite_backward_kernel,
                segscan.segment_sums_kernel, binning.gaussian_tables_kernel,
                binning.depth_order_kernel, expand.expand_instances_kernel,
                sort_tiles.tile_histogram_kernel,
                sort_tiles.stable_tile_rank_kernel)
    runs = {}
    for fused in (1, 8):
        cfg = TrainConfig(optimization=opt)
        cfg.pipeline.fused_steps = fused
        events = []
        cb = TrainCallbacks(on_metrics=lambda it, m: events.append((it, m)),
                            log_every=10)
        for w in wrappers:
            w.launches = 0
        res = train_loop(state, data, cfg, "event", extent, iterations=30,
                         callbacks=cb)
        runs[fused] = res, events, [w.launches for w in wrappers]
    (r1, e1, n1), (r8, e8, n8) = runs[1], runs[8]
    grown = [it for it, m in e1 if "capacity" in m]
    rebuilt = [it for it, m in e1 if "instance_cap" in m]
    assert grown == rebuilt == [10]
    captures = [it for it, m in e8 if "graph_capture_ms" in m]
    assert captures == [0, 10]
    host = lambda ev: [(it, m) for it, m in ev
                       if "loss" not in m and "graph_capture_ms" not in m]
    assert host(e8) == host(e1)  # densify, capacity and cap alike
    assert [it for it, m in e8 if "loss" in m] == [10, 20, 30]
    assert n1 == [90] * 8
    assert n8 == [3 * (WARMUP_STEPS + 1) * len(captures)] * 8
    np.testing.assert_allclose(r8.history, r1.history, rtol=2e-5, atol=1e-6)
    for f in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        np.testing.assert_allclose(getattr(r8.state.params, f).cpu().numpy(),
                                   getattr(r1.state.params, f).cpu().numpy(),
                                   atol=3e-3, err_msg=f)
    assert torch.equal(r8.state.params.alive, r1.state.params.alive)


@pytest.mark.gpu
def test_graph_cache_reuses_a_graph_until_the_step_is_rebuilt():
    """A second run of chunks on the same step object replays the cached
    graph (no capture); a rebuilt step (a new object, even from the same
    arguments) captures a new one and frees the old."""
    from event3dgs_tpu_torch.train.fused import GraphCache
    from event3dgs_tpu_torch.train.loop import measure_instance_cap
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    need_card()
    state, data, extent = graph_scene()
    cap = measure_instance_cap(state.params, data.cameras)
    build = lambda: GraphTrainStep("event", OptimizationConfig(),
                                   EventConfig(), spatial_lr_scale=extent,
                                   rasterizer="tiled", instance_cap=cap)
    step = build()
    rows = torch.from_numpy(np.stack([step.row(1 + i, (3 + i, 3 + i, 4 + i),
                                               np.zeros(3)) for i in range(4)]))
    cache = GraphCache()
    first = cache.get(step, state, data, 4)
    losses = first.run(rows)
    assert cache.captures == 1 and int(first.state.step) == 4
    again = cache.get(step, state, data, 4)
    assert again is first and cache.captures == 1
    assert int(again.state.step) == 0  # the state loaded again
    np.testing.assert_allclose(again.run(rows), losses, rtol=2e-5, atol=1e-6)
    rebuilt = cache.get(build(), state, data, 4)
    assert rebuilt is not first and cache.captures == 2
    assert first.graph is None and rebuilt.graph is not None
    np.testing.assert_allclose(rebuilt.run(rows), losses, rtol=2e-5, atol=1e-6)
    cache.clear()
    assert rebuilt.graph is None


# every train mode's graph beside the event mode's above: (mode, rasterizer)
GRAPH_MODES = [("rgb", "tiled"), ("gray", "tiled"), ("event_deblur", "tiled"),
               ("event", "reference")]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,rasterizer", GRAPH_MODES,
                         ids=[f"{m}-{r}" for m, r in GRAPH_MODES])
def test_graphed_loop_equals_eager_loop_in_every_mode(mode, rasterizer):
    """``fused_steps`` 8 against the eager loop in each train mode the
    event test above leaves out: 20 iterations with one densify at 10 that
    grows the capacity (captured at 0 and again after 10).  Losses, final
    parameters, contrast and alive slots equal bit for bit; the kernels
    launch in the warm-up steps and the captures only (the reference
    rasterizer launches none of K1-K6, the preprocess kernels as the tiled
    one does); the forward preprocess also in each instance-cap probe."""
    from event3dgs_tpu_torch.train import loop, train_loop
    from event3dgs_tpu_torch.train.fused import WARMUP_STEPS
    from event3dgs_tpu_torch.train.loop import TrainCallbacks
    from event3dgs_tpu_torch.utils.config import OptimizationConfig, TrainConfig

    need_card()
    state, data, extent = graph_scene()
    if mode == "event_deblur":  # blurry captures that differ from the views
        data = data._replace(blurry_images=data.images.flip(0).contiguous())
    opt = OptimizationConfig(densify_from_iter=2, densification_interval=10,
                             densify_until_iter=15, densify_grad_threshold=0.0)
    ws = wrappers_by_name()
    runs = {}
    for fused in (1, 8):
        cfg = TrainConfig(optimization=opt)
        cfg.pipeline.fused_steps = fused
        cfg.pipeline.rasterizer = rasterizer
        events = []
        cb = TrainCallbacks(on_metrics=lambda it, m: events.append((it, m)),
                            log_every=10)
        for w in ws.values():
            w.launches = 0
        loop.probe_instance_count.calls = 0
        res = train_loop(state, data, cfg, mode, extent, iterations=20,
                         callbacks=cb)
        runs[fused] = (res, events, {k: w.launches for k, w in ws.items()},
                       loop.probe_instance_count.calls)
    (r1, e1, n1, p1), (r8, e8, n8, p8) = runs[1], runs[8]
    assert [it for it, m in e1 if "capacity" in m] == [10]
    assert [it for it, m in e8 if "graph_capture_ms" in m] == [0, 10]
    renders = 3 if mode.startswith("event") else 1
    tiled = rasterizer == "tiled"
    assert (p1 > 0) == (p8 > 0) == tiled
    for n, steps, p in ((n1, 20, p1), (n8, 2 * (WARMUP_STEPS + 1), p8)):
        want = dict.fromkeys(ws, steps * renders if tiled else 0)
        # the preprocess kernels run under either rasterizer
        want["preprocess_fwd"] = steps * renders + p
        want["preprocess_bwd"] = steps * renders
        assert n == want
    assert np.array_equal(np.asarray(r8.history), np.asarray(r1.history))
    assert np.isfinite(r1.history).all()
    for f in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation", "alive"):
        assert torch.equal(getattr(r8.state.params, f),
                           getattr(r1.state.params, f)), f
    assert torch.equal(r8.state.contrast, r1.state.contrast)
    assert int(r8.state.step) == int(r1.state.step) == 20


def wrappers_by_name():
    """Every kernel's launch wrapper, by name (as ``chip_smoke.py``)."""
    return {
        "preprocess_fwd": pre.preprocess_forward_kernel,
        "preprocess_bwd": pre.preprocess_backward_kernel,
        "K1": rt.composite_forward_kernel,
        "K2": rt.composite_backward_kernel,
        "K3": segscan.segment_sums_kernel,
        "table": binning.gaussian_tables_kernel,
        "depth_offsets": binning.depth_order_kernel,
        "K4": expand.expand_instances_kernel,
        "K5": sort_tiles.tile_histogram_kernel,
        "K6": sort_tiles.stable_tile_rank_kernel,
    }


def preprocess_args(case, device):
    """The forward preprocess's arguments for a ``PREPROCESS_FWD`` case."""
    n, seed, deg, edge, smod, with_opac, with_feats = case
    means, scales, rots, opac, feats, cam = preprocess_scene(
        n, seed, sh_degree=deg, edge=edge, device=device)
    return (means, scales, rots, cam, smod, opac if with_opac else None,
            feats if with_feats else None, deg)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREPROCESS_FWD, ids=str)
def test_preprocess_forward_kernel_matches_plain_version(case):
    """mean2d, depth, conic, radius, valid and colours bit-equal to the
    plain version's (the kernel repeats its operations in their order),
    over SH degrees 0-4, a scaling modifier, with and without opacities
    and features, and the edge cases of ``preprocess_scene``."""
    need_card()
    args = preprocess_args(case, "cuda")
    before = pre.preprocess_forward_kernel.launches
    pk, ck = pre.preprocess_forward(*args)
    assert pre.preprocess_forward_kernel.launches == before + 1
    pp, cp = pre.preprocess_forward_plain(*args)
    for field, k, p in zip(pk._fields, pk, pp):
        assert_bits_equal(k, p, field)
    assert (ck is None) == (cp is None) == (args[6] is None)
    if ck is not None:
        assert_bits_equal(ck, cp, "colors")
    if case[3]:
        assert 0 < int(pk.valid.sum()) < case[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_preprocess_forward_kernel_on_the_rasterizer_scenes(name):
    """The rasterizer suite's scenes through the forward kernel: radius and
    valid (the binning's rects) and every other output bit-equal."""
    need_card()
    means, scales, rots, opac, _, cam = scene_inputs(**SCENES[name],
                                                     device="cuda")
    pk, _ = pre.preprocess_forward_kernel(means, scales, rots, cam,
                                          opacities=opac)
    pp, _ = pre.preprocess_forward_plain(means, scales, rots, cam,
                                         opacities=opac)
    for field, k, p in zip(pk._fields, pk, pp):
        assert_bits_equal(k, p, field)


def backward_case(args, seed):
    """The backward preprocess's arguments on a forward case's inputs:
    the forward's valid and seeded gradients of mean2d, conic and colours,
    slices of an [N, 9] tensor as the rasterizer's K3 hands them over."""
    means, scales, rots, cam, smod, opac, feats, deg = args
    valid = pre.preprocess_forward_plain(*args)[0].valid
    g = torch.Generator().manual_seed(seed)
    rows = (torch.rand(means.shape[0], 9, generator=g) - 0.5).to(means.device)
    return (means, scales, rots, cam, valid, rows[:, 0:2], rows[:, 2:5],
            rows[:, 6:9] if feats is not None else None, smod, feats, deg)


def assert_backward_close(got, want, valid, atol=2e-4):
    """Each gradient within ``atol`` of its max (tests/test_rasterize_tiled
    .py's normalisation), finite, and exactly zero for the Gaussians that
    are not ``valid``."""
    for name, a, b in zip(("means", "scales", "rotations", "features"),
                          got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        if not b.numel():
            continue
        scale = b.abs().max().clamp(min=1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=atol, rtol=0,
                                   msg=name)
        assert not a[~valid].any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREPROCESS_FWD, ids=str)
def test_preprocess_backward_kernel_matches_plain_version(case):
    """The backward kernel against the analytic plain backward, within 2e-4
    of each gradient's max, zero for the Gaussians that are not valid, and
    bit-identical when launched twice."""
    need_card()
    bargs = backward_case(preprocess_args(case, "cuda"), case[1])
    before = pre.preprocess_backward_kernel.launches
    gk = pre.preprocess_backward(*bargs)
    assert pre.preprocess_backward_kernel.launches == before + 1
    assert_backward_close(gk, pre.preprocess_backward_plain(*bargs), bargs[4])
    again = pre.preprocess_backward_kernel(*bargs)
    for a, b in zip(gk, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_preprocess_backward_kernel_at_2m_slots():
    """At ``tools/scale.py``'s 2,097,152-slot maxcap state (its main view,
    camera 1): the backward kernel against the plain backward, within 2e-4
    of each gradient's max, and bit-identical run twice; the forward
    bit-equal."""
    need_card()
    from event3dgs_tpu_torch.tools.scale import maxcap_scene

    state, data = maxcap_scene(2_097_152, 1920, 1080, "cuda")
    act = activated(state.params)
    args = (act.means3d, act.scales, act.rotations, data.cameras[1], 1.0,
            act.opacities, act.features, 3)
    pk, ck = pre.preprocess_forward_kernel(*args)
    pp, cp = pre.preprocess_forward_plain(*args)
    for field, k, p in zip((*pk._fields, "colors"), (*pk, ck), (*pp, cp)):
        assert_bits_equal(k, p, field)
    bargs = backward_case(args, 3)
    gk = pre.preprocess_backward_kernel(*bargs)
    assert_backward_close(gk, pre.preprocess_backward_plain(*bargs), bargs[4])
    assert all(torch.equal(a, b) for a, b in zip(
        gk, pre.preprocess_backward_kernel(*bargs)))


@pytest.mark.gpu
def test_preprocess_kernels_in_a_cuda_graph():
    """Both kernels captured in a CUDA graph with a camera picked on the
    device (``train/step.take``): each replay after the pick moves to
    another view equals the eager launches at that view bit for bit."""
    need_card()
    from event3dgs_tpu_torch.core.camera import stack_cameras
    from event3dgs_tpu_torch.train.step import take

    means, scales, rots, opac, feats, cam0 = preprocess_scene(
        3000, 9, device="cuda")
    cams = stack_cameras([cam0] + [make_camera(
        np.eye(3), np.array([0.1 * i, 0.0, -0.2 * i]), 1.0, 0.7, 256, 144,
        device="cuda") for i in (1, 2)])
    index = torch.zeros(1, dtype=torch.int64, device="cuda")
    rows = torch.rand(3000, 9, device="cuda") - 0.5

    def both(cam):
        proj, colors = pre.preprocess_forward_kernel(
            means, scales, rots, cam, 0.8, opac, feats, 3)
        grads = pre.preprocess_backward_kernel(
            means, scales, rots, cam, proj.valid, rows[:, 0:2], rows[:, 2:5],
            rows[:, 6:9], 0.8, feats, 3)
        return (*proj, colors, *grads)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        both(take(cams, index))  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both(take(cams, index))
    for view in (2, 0, 1):
        index.fill_(view)
        graph.replay()
        for a, b in zip(out, both(cams[view])):
            assert_bits_equal(a, b)


@pytest.mark.gpu
def test_kernel_step_losses_match_the_plain_step():
    """On ``bench.py``'s scene (4,000 Gaussians with random rotations and
    anisotropic scales, 8 views at 160×96), at each of ten successive
    event-step states (advanced by the kernel path's step): the kernel
    path's loss within 1e-5 relative of the plain path's (``plain=True``:
    the preprocess and K1-K6 in plain PyTorch) from the same state, and its
    gradients within 2e-4 of each field's max."""
    from event3dgs_tpu_torch.tools.kernel_timing import bench_state
    from event3dgs_tpu_torch.train.step import (
        make_loss_and_grads,
        make_train_step,
    )
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    need_card()
    state, data, cap = bench_state("cuda", 4000, 160, 96, views=8)
    extent = 3.0  # bench.py's spatial_lr_scale
    bg = torch.zeros(3, device="cuda")
    ev = EventConfig()
    grads = {plain: make_loss_and_grads("event", ev, ev.event_lambda_dssim,
                                        rasterizer="tiled", instance_cap=cap,
                                        plain=plain)
             for plain in (False, True)}
    step = make_train_step("event", OptimizationConfig(), ev,
                           spatial_lr_scale=extent, rasterizer="tiled",
                           instance_cap=cap)
    for i in range(10):
        v = 1 + i % 6
        (lk, _, gk), (lp, _, gp) = (grads[p](state, data, v, v, v + 1, bg)
                                    for p in (False, True))
        assert torch.isfinite(lk) and abs(float(lk) - float(lp)) <= \
            1e-5 * abs(float(lp)), (i, float(lk), float(lp))
        for name in gk["params"]:
            a, b = gk["params"][name], gp["params"][name]
            scale = b.abs().max().clamp(min=1e-30)
            torch.testing.assert_close(a / scale, b / scale, atol=2e-4,
                                       rtol=0, msg=f"step {i}: {name}")
        state, _ = step(state, data, v, v, v + 1, bg)


@pytest.mark.gpu
def test_kernel_steps_chained_match_the_plain_steps(monkeypatch, capsys):
    """Ten event steps chained on ``bench.py``'s scene (as above), on the
    kernel path and on the plain path (``make_train_step`` built over
    ``plain=True`` grads), each from its own last state.  Chained, the
    training itself moves a loss further than 1e-5 relative from a one-ulp
    change of the start state, so each step's loss is held within 1e-5
    relative of the plain path's plus the spread of three plain runs whose
    start has its means, rotations or opacities one ulp up.  Prints each
    run's relative difference by step."""
    import dataclasses
    import functools

    from event3dgs_tpu_torch.tools.kernel_timing import bench_state
    from event3dgs_tpu_torch.train import step as step_mod
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    need_card()
    state0, data, cap = bench_state("cuda", 4000, 160, 96, views=8)
    bg = torch.zeros(3, device="cuda")

    def build():
        return step_mod.make_train_step(
            "event", OptimizationConfig(), EventConfig(), spatial_lr_scale=3.0,
            rasterizer="tiled", instance_cap=cap)

    def nudged(field):
        x = getattr(state0.params, field)
        return state0.replace(params=dataclasses.replace(
            state0.params, **{field: torch.nextafter(x, x + 1)}))

    def chain(step, state):
        losses = []
        for i in range(10):
            v = 1 + i % 6
            state, metrics = step(state, data, v, v, v + 1, bg)
            losses.append(float(metrics["loss"]))
        return np.asarray(losses)

    kernel = chain(build(), state0)
    with monkeypatch.context() as m:
        m.setattr(step_mod, "_views_loss_and_grads", functools.partial(
            step_mod._views_loss_and_grads, plain=True))
        plain_step = build()
    plain = chain(plain_step, state0)
    moved = {f: np.abs(chain(plain_step, nudged(f)) - plain)
             for f in ("xyz", "rotation", "opacity")}
    spread = np.max(list(moved.values()), axis=0)
    with capsys.disabled():
        for name, d in (("kernel", np.abs(kernel - plain)), *moved.items()):
            print(f"chained steps, {name}: |loss - plain's| / plain's by "
                  f"step {(d / np.abs(plain)).tolist()}")
    assert np.isfinite(kernel).all()
    assert (np.abs(kernel - plain) <= 1e-5 * np.abs(plain) + spread).all(), \
        (kernel.tolist(), plain.tolist(), spread.tolist())


@pytest.mark.gpu
def test_depth_offsets_kernel_at_ceiling_size():
    """The depth offsets kernel's decoupled look-back over 8,192 + 1
    blocks of 2,048 ranks (16.8M Gaussians, far more blocks than the card
    holds at once), twice (the kernel clears its state for the next call):
    order, offsets and every live segment's first rank bit-equal to the
    plain version."""
    need_card()
    from event3dgs_tpu_torch.tools.scale import depth_offsets_case

    n = 8192 * binning.OFFSETS_TILE + 1000
    tables = depth_offsets_case(n)
    cap = 1 << 26
    want = binning.depth_order_plain(tables, cap)
    total = int(want.offsets[-1])
    live = -(-min(total, cap) // sort_tiles.SEGMENT)
    for _ in range(2):
        got = binning.depth_order_kernel(tables, cap)
        torch.cuda.synchronize()
        assert torch.equal(got.order, want.order)
        assert torch.equal(got.offsets, want.offsets)
        assert torch.equal(got.seg_rank[:live], want.seg_rank[:live])
    assert int(tables.lookback.abs().sum()) == 0  # left cleared


class _MemProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _MemAccess(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


class _DeviceArray:  # a torch view of device memory torch did not allocate
    def __init__(self, ptr, n):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "<i4", "data": (ptr, False),
            "version": 3, "strides": None}


class GuardedBuffers:
    """Int32 device buffers that each end where their mapping ends: each
    lies at the end of a granule mapped by ``cuMemCreate`` and ``cuMemMap``
    (libcuda), and the next granule of its reserved range is left unmapped,
    so a kernel's read or write past its end faults
    (``cudaErrorIllegalAddress``) wherever it lands.  The cached allocator's
    tensors usually have mapped memory after them."""

    def __init__(self):
        cu = ctypes.CDLL("libcuda.so.1")
        u64, size = ctypes.c_uint64, ctypes.c_size_t
        for fn, args in (
                ("cuMemGetAllocationGranularity",
                 [ctypes.POINTER(size), ctypes.POINTER(_MemProp), ctypes.c_int]),
                ("cuMemAddressReserve",
                 [ctypes.POINTER(u64), size, size, u64, u64]),
                ("cuMemCreate",
                 [ctypes.POINTER(u64), size, ctypes.POINTER(_MemProp), u64]),
                ("cuMemMap", [u64, size, size, u64, u64]),
                ("cuMemSetAccess",
                 [u64, size, ctypes.POINTER(_MemAccess), size]),
                ("cuMemUnmap", [u64, size]), ("cuMemRelease", [u64]),
                ("cuMemAddressFree", [u64, size])):
            getattr(cu, fn).argtypes = args
        self.cu = cu
        dev = torch.cuda.current_device()
        self.prop = _MemProp(type=1, loc_type=1, loc_id=dev)  # pinned, device
        self.access = _MemAccess(loc_type=1, loc_id=dev, flags=3)  # rw
        gran = ctypes.c_size_t()
        self.call("cuMemGetAllocationGranularity", ctypes.byref(gran),
                  ctypes.byref(self.prop), 0)
        self.gran = gran.value
        self.held = []  # (range start, range bytes, mapped bytes, handle)

    def call(self, fn, *args):
        rc = getattr(self.cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} returned CUresult {rc}")

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (int32) copied to the end of a mapping of its own."""
        nbytes = max(t.numel(), 1) * 4
        mapped = -(-nbytes // self.gran) * self.gran
        base, handle = ctypes.c_uint64(), ctypes.c_uint64()
        self.call("cuMemAddressReserve", ctypes.byref(base),
                  mapped + self.gran, 0, 0, 0)
        self.call("cuMemCreate", ctypes.byref(handle), mapped,
                  ctypes.byref(self.prop), 0)
        self.call("cuMemMap", base.value, mapped, 0, handle.value, 0)
        self.call("cuMemSetAccess", base.value, mapped,
                  ctypes.byref(self.access), 1)
        self.held.append((base.value, mapped + self.gran, mapped,
                          handle.value))
        out = torch.as_tensor(_DeviceArray(
            base.value + mapped - nbytes, nbytes // 4), device="cuda")
        out.copy_(t.reshape(-1).to(device="cuda", dtype=torch.int32))
        return out

    def release(self):
        torch.cuda.synchronize()
        for base, span, mapped, handle in self.held:
            self.call("cuMemUnmap", base, mapped)
            self.call("cuMemRelease", handle)
            self.call("cuMemAddressFree", base, span)
        self.held = []


# (instances, live count): the last segment of 2,048 ids half full (1,024)
# and live, past the slots or within them; and whole segments only
HALF_SEGMENTS = [(1024, 6024), (1024, 700), (3072, 8072), (3072, 2500),
                 (4096, 9096), (4096, 3000)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,live", HALF_SEGMENTS, ids=str)
def test_counting_sort_keeps_a_live_half_segment_in_bounds(m, live):
    """The fused counting sort with every input and output at the end of a
    mapping of its own (``GuardedBuffers``), so that an access past any of
    them faults: no fault, and the outputs equal the plain version's.  The
    cases put the last segment at half its 2,048 ids, live, with more or
    fewer live instances than slots.  (A rank kernel that staged the
    Gaussians with 16-byte loads of the whole segment behind a
    ``len == SEGMENT`` test read past ``gauss`` here as built for sm_90a.)"""
    need_card()
    nt, n = 920, 20_000
    g = torch.Generator().manual_seed(m + live)
    ids = torch.randint(0, nt + 1, (m,), generator=g, dtype=torch.int32)
    gauss = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    n_live = torch.tensor([live], dtype=torch.int32)
    want = sort_tiles.counting_sort_plain(ids, gauss, n_live, nt, n)
    mem = GuardedBuffers()
    try:
        dev = {f: mem.copy(t) for f, t in (
            ("ids", ids), ("gauss", gauss), ("n_live", n_live),
            ("base", torch.zeros(sort_tiles.segments(m) * nt)),
            ("counts", torch.zeros(nt)), ("offsets", torch.zeros(nt)),
            ("dest", torch.zeros(m)), ("inst", torch.zeros(m)),
            ("overflow", torch.zeros(1)))}
        kernels.launch(
            "sort_tiles", "e3d_counting_sort", dev["ids"].data_ptr(),
            dev["gauss"].data_ptr(), m, dev["n_live"].data_ptr(), nt, n, 0,
            *(dev[f].data_ptr() for f in (
                "base", "counts", "offsets", "dest", "inst", "overflow")))
        torch.cuda.synchronize()
        for field in ("counts", "offsets", "dest", "inst", "overflow"):
            got = dev[field].cpu().reshape(getattr(want, field).shape)
            assert torch.equal(got, getattr(want, field)), field
    finally:
        mem.release()


@pytest.mark.gpu
def test_counting_sort_at_ceiling_size():
    """K5 + K6 (the fused counting sort, and K5 and K6 alone) over 32M + 5
    instance slots at a 1080p tile grid, a quarter of them past the live
    count or dropped: bit-equal to the plain versions."""
    from event3dgs_tpu_torch.tools.scale import counting_sort_case

    need_card()
    nt = 60 * 34  # 1920×1080 in 32-px tiles
    m = (1 << 25) + 5
    ids, gauss, n_live = counting_sort_case(m, nt)
    want = sort_tiles.counting_sort_plain(ids, gauss, n_live, nt, 1 << 24)
    got = sort_tiles.counting_sort_kernel(ids, gauss, n_live, nt, 1 << 24)
    for field, k, p in zip(got._fields, got, want):
        assert torch.equal(k, p), field
    assert torch.equal(sort_tiles.tile_histogram_kernel(ids, nt, n_live),
                       want.counts)
    assert torch.equal(sort_tiles.stable_tile_rank_kernel(
        ids, n_live, nt, want.offsets, m), want.dest)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself (the dispatchers pick it for CPU tensors)."""
    proj, colors, opac, w, h = scene(n=50, seed=0, w=64, h=64)
    targs = (proj.mean2d, proj.depth, proj.radius, proj.valid, w, h)
    tables = binning.gaussian_tables(*targs, opacities=opac, conic=proj.conic)
    ranks = binning.depth_order(tables, 1024)
    ids = torch.zeros(8, dtype=torch.int32)
    live = torch.tensor([8], dtype=torch.int32)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    img = torch.zeros(h, w)
    rows = torch.zeros(8, 9)
    calls = [
        lambda: binning.gaussian_tables_kernel(*targs, opacities=opac,
                                               conic=proj.conic),
        lambda: binning.depth_order_kernel(tables, 1024),
        lambda: expand.expand_instances_kernel(tables.rect, tables.cull,
                                               *ranks, 1024, 2, 4),
        lambda: sort_tiles.tile_histogram_kernel(ids, 4, live),
        lambda: sort_tiles.stable_tile_rank_kernel(
            ids, live, 4, torch.zeros(4, dtype=torch.int32), 8),
        lambda: sort_tiles.counting_sort_kernel(ids, ids, live, 4, 50),
        lambda: rt.composite_forward_kernel(
            ids, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), feat, 2, w, h),
        lambda: rt.composite_backward_kernel(
            ids, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), feat, 2, w, h,
            torch.zeros(h, w, 3), img, img, img.to(torch.int32), 8),
        lambda: segscan.segment_sums_kernel(rows, ids, ids, 8, ids, ids),
    ]
    means, scales, rots, opac3, feats, cam = preprocess_scene(20, 0)
    calls += [
        lambda: pre.preprocess_forward_kernel(means, scales, rots, cam, 1.0,
                                              opac3, feats, 3),
        lambda: pre.preprocess_backward_kernel(
            means, scales, rots, cam, torch.ones(20, dtype=torch.bool),
            means[:, :2], means, means, 1.0, feats, 3),
    ]
    wrappers = [binning.gaussian_tables_kernel, binning.depth_order_kernel,
                expand.expand_instances_kernel, sort_tiles.tile_histogram_kernel,
                sort_tiles.stable_tile_rank_kernel, rt.composite_forward_kernel,
                rt.composite_backward_kernel, segscan.segment_sums_kernel,
                pre.preprocess_forward_kernel, pre.preprocess_backward_kernel]
    counts = [k.launches for k in wrappers]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    assert counts == [k.launches for k in wrappers]


def test_cpu_dispatch_takes_the_plain_versions():
    proj, colors, opac, w, h = scene(n=80, seed=1, w=96, h=64)
    wrappers = (rt.composite_forward_kernel, rt.composite_backward_kernel,
                segscan.segment_sums_kernel, pre.preprocess_forward_kernel,
                pre.preprocess_backward_kernel)
    before = [k.launches for k in wrappers]
    colors.requires_grad_(True)
    img = rt.rasterize_tiled(proj, colors, opac, torch.zeros(3), w, h)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    (g,) = torch.autograd.grad(img.sum(), [colors])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    means, scales, rots, opac, feats, cam = preprocess_scene(80, 1, 96, 64)
    feats.requires_grad_(True)
    out = render(means, feats, opac, scales, rots, cam, torch.zeros(3),
                 sh_degree=3, rasterizer="tiled")
    (g,) = torch.autograd.grad(out.image.sum(), [feats])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert [k.launches for k in wrappers] == before


def test_kernel_build_is_lazy_and_keyed_by_source(tmp_path, monkeypatch):
    """Importing the port loads no kernel library; each source has its own
    library path, keyed by the source's content and the headers it
    includes, and exports the C functions the bindings declare.  K1 and K2
    share ``csrc/composite.cuh``: a change to it changes both libraries'
    paths (so both rebuild) and no other's."""
    code = ("import event3dgs_tpu_torch.cli.render, event3dgs_tpu_torch.cli.train, "
            "event3dgs_tpu_torch.ops.render; "
            "from event3dgs_tpu_torch.ops import kernels; "
            "assert not kernels._loaded, kernels._loaded")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
    for name, functions in kernels.SIGNATURES.items():
        src = kernels.CSRC / f"{name}.cu"
        path = kernels.library_path(name)
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(f"lib{name}_")
        text = src.read_text()
        for fn in functions:
            assert f'extern "C" int {fn}(' in text
    for f in kernels.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert [p.name for p in kernels.sources("rasterize_bwd")] == [
        "rasterize_bwd.cu", "composite.cuh"]
    before = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    header = tmp_path / "composite.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    changed = sorted(n for n in before if before[n] != after[n])
    assert changed == ["rasterize_bwd", "rasterize_fwd"]
    # the expansion and the counting sort share csrc/segment.cuh
    header = tmp_path / "segment.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    again = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert sorted(n for n in after if after[n] != again[n]) == [
        "expand", "sort_tiles"]
