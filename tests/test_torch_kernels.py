"""The port's CUDA kernels (the preprocess forward and backward, K1-K6, the
binning's table kernel, the Adam update and the event loss forward and
backward) against their plain PyTorch versions, the
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
from event3dgs_tpu_torch.losses import event as ev_loss
from event3dgs_tpu_torch.models import activated, params_from_numpy
from event3dgs_tpu_torch.models import optimizer as opt
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
    Gaussian with instances, bit for bit; the kernel's count column equal
    to the rects' counts."""
    assert torch.equal(tk.rect, tp.rect)
    assert torch.equal(tk.counts, tp.rect[:, 3])
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


def depth_tables(n, seed, device, key=None):
    """Random sort keys (ties among them, +inf where the count is 0), or
    ``key``, and instance counts, as the table kernel leaves them (the
    depth order's state cleared)."""
    g = torch.Generator().manual_seed(seed)
    count = torch.randint(0, 12, (n,), generator=g, dtype=torch.int32)
    count[torch.rand(n, generator=g) < 0.3] = 0
    if key is None:
        key = torch.randint(0, max(n // 4, 1), (n,), generator=g).float()
        key[count == 0] = float("inf")
    rect = torch.zeros(n, 4, dtype=torch.int32)
    rect[:, 3] = count
    return binning.GaussianTables(
        rect=rect.to(device), cull=torch.zeros(n, 8, device=device),
        key=key.to(device), lookback=binning.depth_state(n, device),
        counts=count.to(device))


DEPTH_WRAPPERS = (binning.depth_order_kernel, binning.depth_sort_kernel,
                  binning.depth_offsets_kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 100_000, 400_000,
                               binning.SORT_LARGE])
def test_depth_order_kernels_match_plain_version(n):
    """The radix sort and the depth offsets kernel (``csrc/depth_sort.cu``)
    equal to both plain versions, on one tile, on tile and block
    boundaries, on 49 and 196 tiles a pass of 2,048 keys (and offsets
    blocks) and on 256 of 4,096 keys (from ``SORT_LARGE`` keys on), twice
    on the same state, which each call leaves cleared."""
    need_card()
    tables = depth_tables(n, n, "cuda")
    cap = suggest_cap(int(tables.rect[:, 3].sum()))
    p = binning.depth_order_plain(tables, cap)
    assert_depth_order_equal(binning.radix_order_plain(tables, cap), p, cap)
    for _ in range(2):
        before = [w.launches for w in DEPTH_WRAPPERS]
        k = binning.depth_order(tables, cap)
        assert [w.launches - b for w, b in zip(DEPTH_WRAPPERS, before)] == \
            [1, 1, 1]
        assert_depth_order_equal(k, p, cap)
        torch.cuda.synchronize()
        # the kernels leave every word of their state cleared
        assert not tables.lookback.any()


def adversarial_keys(name, n, seed):
    """Sort keys of one adversarial set, from numpy's seeded generator:
    ties, all equal, all dead (+inf), all live, digits constant in some
    radix passes, ±0.0, denormals of both signs, negatives and -inf, NaNs
    of both signs and several payloads among them."""
    rng = np.random.default_rng(seed)
    pick = lambda pool: np.asarray(pool, np.float32)[rng.integers(0, len(pool), n)]
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                     0x7FFFFFFF], np.uint32).view(np.float32)
    keys = {
        "ties": lambda: pick([0.5, 1.0, 1.0, 2.0, 7.25]),
        "all_equal": lambda: np.full(n, 3.5, np.float32),
        "all_dead": lambda: np.full(n, np.inf, np.float32),
        "all_live": lambda: rng.uniform(0.2, 80.0, n).astype(np.float32),
        # words vary in the low 8 bits only (three passes skipped), and in
        # bits 8-15 only (the lowest and the two highest skipped)
        "skip_low": lambda: (rng.integers(0, 256, n).astype(np.uint32)
                             | 0x40000000).view(np.float32),
        "skip_mid": lambda: ((rng.integers(0, 256, n).astype(np.uint32) << 8)
                             | 0x40000000).view(np.float32),
        "signed_zeros": lambda: pick([0.0, -0.0, 1.0, -1.0, np.inf]),
        "denormals": lambda: pick([1e-45, -1e-45, 1e-40, -1e-40, 0.0, -0.0,
                                   1.2e-38, -1.2e-38]),
        "negatives": lambda: np.where(
            rng.random(n) < 0.1, -np.inf,
            rng.uniform(-50.0, 50.0, n)).astype(np.float32),
        "nans": lambda: np.where(rng.random(n) < 0.3, nans[rng.integers(
            0, len(nans), n)], pick([-np.inf, -2.0, -0.0, 0.0, 3.0,
                                     np.inf])).astype(np.float32),
    }
    return torch.from_numpy(keys[name]())


ADVERSARIAL_KEYS = ("ties", "all_equal", "all_dead", "all_live", "skip_low",
                    "skip_mid", "signed_zeros", "denormals", "negatives",
                    "nans")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2049, 100_000])
@pytest.mark.parametrize("name", ADVERSARIAL_KEYS)
def test_depth_order_kernels_on_adversarial_keys(name, n):
    """The radix sort's order bit-equal to ``torch.argsort(key,
    stable=True)`` on the card on every adversarial key set but the NaNs,
    and to the CPU's order (every NaN last, in index order) on the NaNs,
    where the card's own ``argsort`` differs at 100,000 keys; the
    offsets and the live segments' first ranks equal to the plain
    versions; the passes the plan skips are those of ``radix_plan``."""
    need_card()
    key = adversarial_keys(name, n, ADVERSARIAL_KEYS.index(name))
    tables = depth_tables(n, n, "cuda", key=key)
    cap = suggest_cap(int(tables.rect[:, 3].sum()))
    got = binning.depth_order(tables, cap)
    plain = binning.radix_order_plain(tables, cap)
    assert_depth_order_equal(got, plain, cap)
    want = torch.argsort(key, stable=True).to(torch.int32)  # the CPU's
    card = torch.argsort(tables.key, stable=True).to(torch.int32).cpu()
    assert torch.equal(got.order.cpu(), want)
    if name != "nans":
        assert torch.equal(card, want)
    elif n >= 4096:
        assert not torch.equal(card, want)  # a NaN with its sign bit first
    assert not tables.lookback.any()
    plan = binning.radix_plan(binning.ordered_keys(key))
    if name in ("all_equal", "all_dead") or n == 1:
        assert plan == [binning.PASSES - 1]
    elif name in ("skip_low", "skip_mid"):
        assert plan == [0 if name == "skip_low" else 1]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_depth_order_kernels_in_a_cuda_graph():
    """The depth order captured in a CUDA graph and replayed twice gives
    the eager call's outputs (the state cleared by each replay), also after
    the keys change between replays."""
    need_card()
    n = 100_000
    tables = depth_tables(n, 3, "cuda")
    cap = suggest_cap(int(tables.rect[:, 3].sum()))
    eager = binning.depth_order(tables, cap)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = binning.depth_order(tables, cap)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert_depth_order_equal(captured, eager, cap)
        assert not tables.lookback.any()
    tables.key.copy_(depth_tables(n, 4, "cuda").key)
    graph.replay()
    torch.cuda.synchronize()
    assert_depth_order_equal(captured, binning.depth_order_plain(tables, cap),
                             cap)


@pytest.mark.gpu
def test_graphed_event_step_runs_no_library_sort():
    """One event step as ``--fused_steps`` captures it holds no library
    sort node (no CUB radix sort: the depth order is the port's radix
    sort) and the port's sort once per render: a histogram, four passes
    and an offsets kernel each of the step's three renders."""
    need_card()
    from event3dgs_tpu_torch.tools.kernel_timing import graph_kernels
    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import TrainConfig

    state, data, extent = graph_scene()
    cfg = TrainConfig()
    step = GraphTrainStep("event", cfg.optimization, cfg.event,
                          spatial_lr_scale=extent, rasterizer="tiled",
                          instance_cap=4096)
    runner = FusedSteps(step, state, data, 2)
    runner.table.copy_(torch.from_numpy(np.stack([
        step.row(int(state.step) + 1 + j, (1, 1, 2), np.zeros(3))
        for j in range(2)])))
    nodes = graph_kernels(lambda: (runner.cursor.zero_(), runner._call()))
    assert not [k for k in nodes if "sort" in k.lower()
                and not k.startswith("radix_")], nodes
    assert (nodes.get("radix_histogram_kernel"), nodes.get("radix_pass_kernel"),
            nodes.get("depth_offsets_kernel")) == (3, 12, 3), nodes


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
    """Each timing-only build of K1, K2 and K4 compiles, reports its kernel
    to ``-Xptxas -v`` and launches on a small scene."""
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools import kernel_timing as kt

    need_card()
    logs = kernels.build(kp.variant_builds())
    k1_args, k4_args = _composite_inputs("binning_seed0", "cuda")
    _, k2_args = _backward_inputs("binning_seed0", None, "cuda")
    function = {"K1": "composite_forward_kernel",
                "K2": "composite_backward_kernel", "K4": "expand_kernel"}
    for v in kp.variants():
        assert kt.ptxas_report(logs[kernels.build_key(v.source, v.defines)],
                               function[v.kernel])["registers"] > 0
        clock = None
        if v.name == "clock":
            clock = torch.zeros(k1_args[2].shape[0], 2, dtype=torch.int64,
                                device="cuda")
        if v.kernel == "K1":
            out = v(*k1_args, clock=clock)[0]
        else:
            out = v(*k2_args) if v.kernel == "K2" else v(*k4_args)[0]
        torch.cuda.synchronize()
        assert out.shape[0] > 0, v.label


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
    rasterizer launches none of K1-K6; the preprocess kernels, the Adam
    kernel once a step in every mode, the loss kernels once a step in the
    event modes); the forward preprocess also in each instance-cap
    probe."""
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
        # the preprocess kernels run under either rasterizer, once a step
        # for all its renders
        want["preprocess_fwd"] = steps + p
        want["preprocess_bwd"] = steps
        want["adam"] = steps  # both groups in one launch a step
        # the loss kernels in the event modes, whatever the rasterizer
        want["loss_fwd"] = want["loss_bwd"] = (
            steps if mode.startswith("event") else 0)
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
        "depth_sort": binning.depth_sort_kernel,
        "depth_offsets": binning.depth_offsets_kernel,
        "K4": expand.expand_instances_kernel,
        "K5": sort_tiles.tile_histogram_kernel,
        "K6": sort_tiles.stable_tile_rank_kernel,
        "adam": opt.adam_update_kernel,
        "loss_fwd": ev_loss.event_loss_forward_kernel,
        "loss_bwd": ev_loss.event_loss_backward_kernel,
    }


# positions of a case's views beside its own camera's, and their sizes as
# fractions of its own (the third view smaller: per-view sizes)
VIEW_SHIFTS = ((0.0, 0.0, 0.0), (0.1, 0.0, -0.2), (-0.15, 0.05, 0.1))
VIEW_SIZES = ((1, 1), (1, 1), (2, 1))


def view_cameras(n, seed, deg, edge, views, device):
    """``views`` cameras around the camera of ``preprocess_scene(n, seed,
    ...)``: shifted by ``VIEW_SHIFTS``, sized by ``VIEW_SIZES``."""
    a = preprocess_arrays(n, seed, sh_degree=deg, edge=edge)
    return [make_camera(a["R"], a["t"] + np.asarray(d), *a["fov"],
                        a["w"] // sw, a["h"] // sh, device=device)
            for d, (sw, sh) in zip(VIEW_SHIFTS[:views], VIEW_SIZES)]


def preprocess_args(case, device):
    """The forward preprocess's arguments for a ``PREPROCESS_FWD`` case:
    1 to 3 views (by the seed), the features as two contiguous leaves (even
    seeds: the kernels' bulk copy) or as strided views of one [N, K, 3]
    tensor (odd seeds: their copy float by float), and the mask of an
    active degree up to the case's (by the seed)."""
    n, seed, deg, edge, smod, with_opac, with_feats = case
    means, scales, rots, opac, feats, _ = preprocess_scene(
        n, seed, sh_degree=deg, edge=edge, device=device)
    cams = view_cameras(n, seed, deg, edge, 1 + seed % 3, device)
    dc, rest = feats[:, :1], feats[:, 1:]
    if seed % 2 == 0:
        dc, rest = dc.contiguous(), rest.contiguous()
    active = seed % (deg + 1)
    cmask = (torch.arange(feats.shape[1], device=device)
             < (active + 1) ** 2).float()
    if not with_feats:
        dc = rest = cmask = None
    return (means, scales, rots, cams, smod, opac if with_opac else None, dc,
            rest, cmask, deg)


def assert_forward_equal(got, want):
    """Each view's mean2d, depth, conic, radius, valid and colours bit for
    bit."""
    assert len(got) == len(want)
    for (pk, ck), (pp, cp) in zip(got, want):
        for field, k, p in zip(pk._fields, pk, pp):
            assert_bits_equal(k, p, field)
        assert (ck is None) == (cp is None)
        if ck is not None:
            assert_bits_equal(ck, cp, "colors")


def seeded_tap(n, seed, device):
    """A non-zero [N, 2] mean2d tap (a few pixels), seeded."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 2, generator=g) * 3.0).to(device)


def assert_packed_equal(got, want, opac):
    """``assert_forward_equal`` of the (proj, colours) pairs, and each
    view's packed rows 16-byte aligned and bit-equal to the plain
    version's and to ``pack_features`` of the view's own outputs."""
    assert_forward_equal([x[:2] for x in got], [x[:2] for x in want])
    for (pk, ck, fk), (_, _, fp) in zip(got, want):
        assert fk.data_ptr() % 16 == 0 and fk.shape == (len(opac), rt.FEAT)
        assert_bits_equal(fk, fp, "packed rows")
        assert_bits_equal(fk, rt.pack_features(pk.mean2d, pk.conic, ck, opac),
                          "pack_features")


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREPROCESS_FWD, ids=str)
def test_preprocess_forward_kernel_matches_plain_version(case):
    """mean2d, depth, conic, radius, valid and colours of every view
    bit-equal to the plain version's (the kernel repeats its operations in
    their order), over SH degrees 0-4 with a mask of a lower active degree,
    1 to 3 views of their own sizes, the leaves contiguous or strided, a
    scaling modifier, with and without opacities and features, and the
    edge cases of ``preprocess_scene``; with both, a non-zero tap and the
    packed rows (``assert_packed_equal``)."""
    need_card()
    args = preprocess_args(case, "cuda")
    packed = args[5] is not None and args[6] is not None
    kw = dict(mean2d_tap=seeded_tap(case[0], case[1], "cuda"),
              packed=True) if packed else {}
    before = pre.preprocess_forward_kernel.launches
    got = pre.preprocess_forward(*args, **kw)
    assert pre.preprocess_forward_kernel.launches == before + 1
    want = pre.preprocess_forward_plain(*args, **kw)
    if packed:
        assert_packed_equal(got, want, args[5])
    else:
        assert_forward_equal(got, want)
    assert all((x[1] is None) == (args[6] is None) for x in got)
    if case[3]:
        assert 0 < int(got[0][0].valid.sum()) < case[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_preprocess_forward_kernel_on_the_rasterizer_scenes(name):
    """The rasterizer suite's scenes through the forward kernel: radius and
    valid (the binning's rects) and every other output bit-equal."""
    need_card()
    means, scales, rots, opac, _, cam = scene_inputs(**SCENES[name],
                                                     device="cuda")
    assert_forward_equal(
        pre.preprocess_forward_kernel(means, scales, rots, [cam],
                                      opacities=opac),
        pre.preprocess_forward_plain(means, scales, rots, [cam],
                                     opacities=opac))


def backward_case(args, seed):
    """The backward preprocess's arguments on a forward case's inputs:
    each view's valid from the forward and seeded gradients of mean2d,
    conic and colours, slices of an [N, 9] tensor as the rasterizer's K3
    hands them over."""
    means, scales, rots, cams, smod, opac, dc, rest, cmask, deg = args
    out = pre.preprocess_forward_plain(*args)
    g = torch.Generator().manual_seed(seed)
    rows = [(torch.rand(means.shape[0], 9, generator=g) - 0.5).to(
        means.device) for _ in cams]
    return (means, scales, rots, cams, [proj.valid for proj, _ in out],
            [r[:, 0:2] for r in rows], [r[:, 2:5] for r in rows],
            [r[:, 6:9] if dc is not None else None for r in rows], smod, dc,
            rest, cmask, deg)


def assert_backward_close(got, want, valid, atol=2e-4):
    """The gradients of the means, scales and rotations within ``atol`` of
    each one's max (tests/test_rasterize_tiled.py's normalisation), the two
    feature leaves' bit for bit (each view's drgb·B, added from the last
    view to the first and masked as the plain version does), all finite,
    and exactly zero for the Gaussians valid in no view."""
    nowhere = ~torch.stack(list(valid)).any(0)
    for name, a, b in zip(("means", "scales", "rotations", "features_dc",
                           "features_rest"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        if not b.numel():
            continue
        if name.startswith("features"):
            assert_bits_equal(a, b.contiguous(), name)
        else:
            scale = b.abs().max().clamp(min=1e-30)
            torch.testing.assert_close(a / scale, b / scale, atol=atol,
                                       rtol=0, msg=name)
        assert not a[nowhere].any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREPROCESS_FWD, ids=str)
def test_preprocess_backward_kernel_matches_plain_version(case):
    """The backward kernel against the analytic plain backward summed over
    the views (``assert_backward_close``: the feature gradients bit for
    bit), zero for the Gaussians valid in no view, and bit-identical when
    launched twice."""
    need_card()
    bargs = backward_case(preprocess_args(case, "cuda"), case[1])
    before = pre.preprocess_backward_kernel.launches
    gk = pre.preprocess_backward(*bargs)
    assert pre.preprocess_backward_kernel.launches == before + 1
    assert_backward_close(gk, pre.preprocess_backward_plain(*bargs), bargs[4])
    again = pre.preprocess_backward_kernel(*bargs)
    for a, b in zip(gk, again):
        assert (a is None and b is None) or torch.equal(a, b)


# leaf layouts the kernels read: (name, N); the leaves as contiguous
# tensors (the bulk copy), as views of one [N, K, 3] tensor, and with rows
# wider than their data (a slice of a wider tensor); N = 1, one row past a
# block, a last block of 127 rows (dc 1,524 bytes, rest 22,860: neither a
# multiple of 16)
LEAF_LAYOUTS = [(layout, n) for layout in ("leaves", "whole", "padded")
                for n in (1, 129, 255)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout,n", LEAF_LAYOUTS,
                         ids=[f"{a}-n{b}" for a, b in LEAF_LAYOUTS])
def test_preprocess_kernels_on_strided_and_ragged_leaves(layout, n):
    """Both kernels over three views with the feature leaves laid out as
    ``layout``: the forward bit-equal to its plain version (with a tap, its
    packed rows too), the backward as ``assert_backward_close`` holds
    it."""
    need_card()
    means, scales, rots, opac, feats, _ = preprocess_scene(n, 30, edge=True,
                                                           device="cuda")
    if layout == "whole":
        dc, rest = feats[:, :1], feats[:, 1:]
    elif layout == "padded":
        wide = torch.zeros(n, 19, 3, device="cuda")
        wide[:, 1:2], wide[:, 3:18] = feats[:, :1], feats[:, 1:]
        dc, rest = wide[:, 1:2], wide[:, 3:18]
        assert rest.stride(0) == 57
    else:
        dc, rest = feats[:, :1].contiguous(), feats[:, 1:].contiguous()
    cmask = (torch.arange(16, device="cuda") < 9).float()
    args = (means, scales, rots, view_cameras(n, 30, 3, True, 3, "cuda"), 0.9,
            opac, dc, rest, cmask, 3)
    tap = seeded_tap(n, 34, "cuda")
    assert_packed_equal(
        pre.preprocess_forward_kernel(*args, mean2d_tap=tap, packed=True),
        pre.preprocess_forward_plain(*args, mean2d_tap=tap, packed=True),
        opac)
    bargs = backward_case(args, 31)
    assert_backward_close(pre.preprocess_backward_kernel(*bargs),
                          pre.preprocess_backward_plain(*bargs), bargs[4])


@pytest.mark.gpu
def test_preprocess_function_on_the_card():
    """Autograd through ``preprocess_views`` (three views, the leaves and a
    mask) and ``preprocess`` (one view, [N, K, 3] features, whose gradient
    the backward kernel writes as one tensor) on the card: one launch of
    each kernel a call, the outputs equal to ``plain=True``'s bit for bit,
    the gradients as ``assert_backward_close`` holds them."""
    need_card()
    means, scales, rots, opac, feats, _ = preprocess_scene(
        3000, 32, edge=True, device="cuda")
    cams = view_cameras(3000, 32, 3, True, 3, "cuda")
    cmask = (torch.arange(16, device="cuda") < 16).float()
    out = {}
    for plain in (False, True):
        leaves = [x.detach().clone().requires_grad_(True) for x in (
            means, scales, rots, feats[:, :1], feats[:, 1:])]
        before = (pre.preprocess_forward_kernel.launches,
                  pre.preprocess_backward_kernel.launches)
        views = pre.preprocess_views(*leaves[:3], cams, opacities=opac,
                                     features_dc=leaves[3],
                                     features_rest=leaves[4], cmask=cmask,
                                     sh_degree=3, plain=plain)
        loss = sum((p.mean2d.sin().sum() + p.conic.cos().sum()
                    + c.square().sum()) for p, c in views)
        grads = torch.autograd.grad(loss, leaves)
        after = (pre.preprocess_forward_kernel.launches,
                 pre.preprocess_backward_kernel.launches)
        assert after == ((before[0] + 1, before[1] + 1) if not plain
                         else before)
        out[plain] = views, grads
    assert_forward_equal(out[False][0], out[True][0])
    valid = [p.valid for p, _ in out[True][0]]
    assert_backward_close(out[False][1], out[True][1], valid)
    whole = {}
    for plain in (False, True):
        f = feats.detach().clone().requires_grad_(True)
        proj, colors = pre.preprocess(means, scales, rots, cams[0], 1.0, opac,
                                      f, 3, plain=plain)
        (whole[plain],) = torch.autograd.grad(colors.square().sum(), [f])
    assert whole[False].shape == feats.shape
    assert_bits_equal(whole[False], whole[True])


@pytest.mark.gpu
def test_preprocess_backward_kernel_at_2m_slots():
    """At ``tools/scale.py``'s 2,097,152-slot maxcap state, the step's three
    views (main view camera 1, event pair 1 → 2) with all 16 coefficients
    of the mask on: the forward bit-equal; the backward against the plain
    backward (``assert_backward_close``), bit-identical run twice."""
    need_card()
    from event3dgs_tpu_torch.tools.scale import maxcap_scene

    state, data = maxcap_scene(2_097_152, 1920, 1080, "cuda")
    act = activated(state.params, features=False)
    cams = [data.cameras[1], data.event_cameras[1], data.event_cameras[2]]
    args = (act.means3d, act.scales, act.rotations, cams, 1.0,
            act.opacities, state.params.features_dc,
            state.params.features_rest, torch.ones(16, device="cuda"), 3)
    assert_forward_equal(pre.preprocess_forward_kernel(*args),
                         pre.preprocess_forward_plain(*args))
    bargs = backward_case(args, 3)
    gk = pre.preprocess_backward_kernel(*bargs)
    assert_backward_close(gk, pre.preprocess_backward_plain(*bargs), bargs[4])
    assert all(torch.equal(a, b) for a, b in zip(
        gk, pre.preprocess_backward_kernel(*bargs)))


@pytest.mark.gpu
def test_preprocess_kernels_in_a_cuda_graph():
    """Both kernels captured in a CUDA graph over three views picked on the
    device (``train/step.take``), the mask a device tensor, the forward
    with a tap and the packed rows: each replay after the picks move to
    other views and the tap changes equals the eager launches at those
    views bit for bit, the rows too."""
    need_card()
    from event3dgs_tpu_torch.core.camera import stack_cameras
    from event3dgs_tpu_torch.train.step import take

    means, scales, rots, opac, feats, cam0 = preprocess_scene(
        3000, 9, device="cuda")
    cams = stack_cameras([cam0] + [make_camera(
        np.eye(3), np.array([0.1 * i, 0.0, -0.2 * i]), 1.0, 0.7, 256, 144,
        device="cuda") for i in (1, 2)])
    index = torch.zeros(3, dtype=torch.int64, device="cuda")
    cmask = torch.ones(16, device="cuda")
    tap = torch.zeros(3000, 2, device="cuda")
    dc, rest = feats[:, :1].contiguous(), feats[:, 1:].contiguous()
    rows = torch.rand(3, 3000, 9, device="cuda") - 0.5

    def both(views):
        out = pre.preprocess_forward_kernel(means, scales, rots, views, 0.8,
                                            opac, dc, rest, cmask, 3,
                                            mean2d_tap=tap, packed=True)
        grads = pre.preprocess_backward_kernel(
            means, scales, rots, views, [p.valid for p, _, _ in out],
            [r[:, 0:2] for r in rows], [r[:, 2:5] for r in rows],
            [r[:, 6:9] for r in rows], 0.8, dc, rest, cmask, 3)
        return (*(t for p, c, f in out for t in (*p, c, f)), *grads)

    picked = lambda: [take(cams, index[v:v + 1]) for v in range(3)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        both(picked())  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both(picked())
    for seed, views in enumerate(((2, 0, 1), (1, 1, 2), (0, 2, 0))):
        index.copy_(torch.tensor(views))
        tap.copy_(seeded_tap(3000, 36 + seed, "cuda"))
        graph.replay()
        for a, b in zip(out, both([cams[v] for v in views])):
            assert_bits_equal(a, b)


def step_state(device, n, width, height):
    """``bench.py``'s training state (``kernel_timing.bench_state``) at a
    small size, its higher-order features drawn from seed 4: (state, data,
    instance cap)."""
    from event3dgs_tpu_torch.tools.kernel_timing import bench_state

    state, data, cap = bench_state(device, n, width, height)
    rest = state.params.features_rest
    return state.replace(params=dataclasses.replace(
        state.params, features_rest=torch.tensor(
            np.random.default_rng(4).normal(0.0, 0.2, tuple(rest.shape)),
            dtype=torch.float32, device=rest.device))), data, cap


def per_render_loss_and_grads(state, data, mode, cmask, cap, parent=False):
    """The train step's loss and gradients at views (1, 1, 2) and the mask
    ``cmask``, from ``train/step``'s one preprocess call for its views,
    and as the step computed them before: each view rendered on its own
    through ``render`` with the concatenated features times the mask,
    autograd adding the views' gradients.  With ``parent`` each view is
    rendered as the render did before the preprocess took the tap and
    wrote the packed rows: ``preprocess``, the tap added to the main
    view's projected means, ``rasterize_tiled_partials`` packing the
    rows.  In event_deblur mode the
    blurry captures are the views in reverse order.  (On random images the
    event mode's main view gets no gradient, its coverage being 1;
    event_deblur's blur term gives it one, so that three views' gradients
    are added.)  Returns (the step's loss, its gradients, the per-render
    loss, its gradients in the order of ``names``, ``names``: the six
    leaves, the contrast, the tap)."""
    from event3dgs_tpu_torch.losses.event import effective_contrast
    from event3dgs_tpu_torch.losses.modes import (
        event_total_loss,
        rgb_total_loss,
    )
    from event3dgs_tpu_torch.train.step import (
        _views_loss_and_grads,
        step_inputs,
        step_views,
    )
    from event3dgs_tpu_torch.utils.config import EventConfig

    ev = EventConfig()
    event = mode.startswith("event")
    lam = ev.event_lambda_dssim if event else 0.2
    if mode == "event_deblur":
        data = data._replace(blurry_images=data.images.flip(0).contiguous())
    views = step_views(data, mode, 1, 1, 2)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cmask.device)
    loss, _, grads = _views_loss_and_grads(mode, ev, lam, 3, "tiled", cap)(
        state, views, bg, cmask)
    inp = step_inputs(state, 3, cmask)
    act = inp.act
    features = torch.cat([inp.leaves["features_dc"],
                          inp.leaves["features_rest"]], dim=1) * cmask[
                              None, :, None]

    def image(cam, tap=None):
        if not parent:
            return render(act.means3d, features, act.opacities, act.scales,
                          act.rotations, cam, bg, sh_degree=3,
                          mean2d_tap=tap, rasterizer="tiled",
                          instance_cap=cap).image
        proj, colors = pre.preprocess(act.means3d, act.scales, act.rotations,
                                      cam, opacities=act.opacities,
                                      features=features, sh_degree=3)
        if tap is not None:
            proj = proj._replace(mean2d=proj.mean2d + tap)
        rgb, logt = rt.rasterize_tiled_partials(
            proj, colors, act.opacities, cam.width, cam.height,
            instance_cap=cap)
        return rgb + torch.exp(logt)[:, :, None] * bg[None, None, :]

    main = image(views.cam_main, inp.tap)
    if mode == "rgb":
        want_loss, _ = rgb_total_loss(main, views.gt_main, lam)
    else:
        want_loss, _ = event_total_loss(
            image(views.cam_now), image(views.cam_next), main, views.gt_now,
            views.gt_next, views.gt_main,
            effective_contrast(inp.contrast, ev.contrast_parameterization),
            gt_contrast=ev.gt_contrast, event_weight=ev.event_weight,
            blurry_main=views.blurry_main, blur_alpha=ev.blur_alpha)
    inputs = [*inp.leaves.values(), inp.contrast, inp.tap]
    want = [torch.zeros_like(x) if g is None else g for x, g in zip(
        inputs, torch.autograd.grad(want_loss, inputs, allow_unused=True))]
    assert list(grads["params"]) == list(inp.leaves)
    return (loss, grads, want_loss.detach(), want,
            [*inp.leaves, "contrast", "tap"])


def composed_step_loss_and_grads(state, data, mode, cmask, cap,
                                 frames=False):
    """The event step's loss and gradients at views (1, 1, 2), the loss
    composing the renders' partials over the background (and, with
    ``frames``, reading the GT images as ``Frame``s of their stacks at
    device indices, as ``GraphTrainStep`` gives them), and as the step
    computed them before: each render composed by ``ops/render.composed``
    and the GT images picked, then the loss on images.  In event_deblur
    mode the blurry captures are the views in reverse order.  Returns (the
    step's loss, its eight gradients, the earlier step's loss, its
    gradients, their names: the six leaves, the contrast, the tap)."""
    from event3dgs_tpu_torch.losses import event as ev
    from event3dgs_tpu_torch.train import step as step_mod
    from event3dgs_tpu_torch.utils.config import EventConfig

    cfg = EventConfig()
    if mode == "event_deblur":
        data = data._replace(blurry_images=data.images.flip(0).contiguous())
    dev = cmask.device
    if frames:
        index = torch.tensor([1, 1, 2], device=dev)
        views = step_mod.step_views(data, mode, index[0:1], index[1:2],
                                    index[2:3], pick=step_mod.take,
                                    frame=ev.Frame)
        assert isinstance(views.gt_now, ev.Frame)
    else:
        views = step_mod.step_views(data, mode, 1, 1, 2)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    fn = step_mod._views_loss_and_grads(mode, cfg, cfg.event_lambda_dssim, 3,
                                        "tiled", cap)
    total = step_mod.event_total_loss
    calls = []

    def composed_first(*a, background=None, blurry_main=None, **kw):
        calls.append(tuple(type(x).__name__ for x in a[:6]))
        return total(*(ev.render_image(r, background) for r in a[:3]),
                     *(ev.frame_image(g) for g in a[3:6]), *a[6:],
                     blurry_main=(None if blurry_main is None
                                  else ev.frame_image(blurry_main)), **kw)

    out = {}
    for earlier in (False, True):
        if earlier:
            step_mod.event_total_loss = composed_first
        try:
            loss, _, grads = fn(state, views, bg, cmask)
        finally:
            step_mod.event_total_loss = total
        out[earlier] = (loss, [*grads["params"].values(), grads["contrast"],
                               grads["tap"]])
    gt = "Frame" if frames else "Tensor"
    assert calls == [("Partials",) * 3 + (gt,) * 3]
    return (*out[False], *out[True], [*grads["params"], "contrast", "tap"])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["event", "event_deblur", "rgb"])
def test_step_equals_the_per_render_step_on_the_card(mode):
    """On the card, the train step (one launch of each preprocess kernel
    for its views) against the step that renders each view on its own (a
    launch of each a view, autograd adding the views' gradients): the loss
    and every gradient bit for bit, at 3,000 Gaussians and 256×144."""
    need_card()
    state, data, cap = step_state("cuda", 3000, 256, 144)
    cmask = (torch.arange(16, device="cuda") < 9).float()
    before = pre.preprocess_backward_kernel.launches
    loss, grads, want_loss, want, names = per_render_loss_and_grads(
        state, data, mode, cmask, cap)
    views = 3 if mode.startswith("event") else 1
    assert pre.preprocess_backward_kernel.launches == before + 1 + views
    assert_bits_equal(loss, want_loss, "loss")
    got = [*grads["params"].values(), grads["contrast"], grads["tap"]]
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w.contiguous(), name)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["event", "event_deblur", "rgb"])
def test_step_equals_the_parents_add_and_pack_on_the_card(mode):
    """On the card, the train step (the forward preprocess taking the tap
    and writing the packed rows that K1 and K2 read) against the
    per-render step as it was built before (the tap added to the main
    view's projected means, ``pack_features`` in the rasterizer): the loss
    and every gradient bit for bit, at 3,000 Gaussians and 256×144; the
    step calls ``pack_features`` nowhere."""
    need_card()
    state, data, cap = step_state("cuda", 3000, 256, 144)
    cmask = (torch.arange(16, device="cuda") < 9).float()
    calls = []
    pack = rt.pack_features

    def counted(*a):
        calls.append(1)
        return pack(*a)

    rt.pack_features = pre.pack_features = counted
    try:
        loss, grads, want_loss, want, names = per_render_loss_and_grads(
            state, data, mode, cmask, cap, parent=True)
    finally:
        rt.pack_features = pre.pack_features = pack
    views = 3 if mode.startswith("event") else 1
    assert len(calls) == views  # the per-render step's rasterizers only
    assert_bits_equal(loss, want_loss, "loss")
    got = [*grads["params"].values(), grads["contrast"], grads["tap"]]
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w.contiguous(), name)


# the train state's trainable leaves: (name, trailing shape); the feature
# gradients are slices of one [C, 16, 3] gradient, as the preprocess
# backward writes them
ADAM_LEAVES = (("xyz", (3,)), ("features_dc", (1, 3)),
               ("features_rest", (15, 3)), ("scaling", (3,)),
               ("rotation", (4,)), ("opacity", (1,)))
ADAM_LRS = {"xyz": 1.6e-4 * 3.0, "features_dc": 0.0025,
            "features_rest": 0.0025 / 20.0, "opacity": 0.05,
            "scaling": 0.005, "rotation": 0.001}
# 99,991 slots: no multiple of the kernel's 1,024 floats a block of chunks
ADAM_SLOTS = (100_000, 2_097_152, 99_991)
ADAM_COUNTS = (1, 2, 10, 1_000, 30_000)  # the count after the increment


def adam_values(gen, shape, device, kind):
    """Seeded values of one Adam tensor: parameters, first moments, second
    moments (some exactly 0) or gradients over 23 decades (some exactly
    0, some whose squares are subnormal)."""
    x = torch.randn(shape, generator=gen, device=device)
    if kind == "p":
        return x
    if kind == "m":
        return x * 1e-3
    if kind == "v":
        return (x * 1e-3) ** 2 * (torch.rand(shape, generator=gen,
                                             device=device) > 0.05)
    scale = 10.0 ** torch.empty(shape, device=device).uniform_(
        -22.0, 1.0, generator=gen)
    return x * scale * (torch.rand(shape, generator=gen, device=device) > 0.02)


def adam_groups(slots, seed, device, lr_on_device=False):
    """A train step's two Adam groups at ``slots`` slots: the six leaves
    (the position rate a one-element device tensor with ``lr_on_device``)
    and the contrast."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = lambda k: (slots, *dict(ADAM_LEAVES)[k])
    params = {k: adam_values(gen, shape(k), device, "p")
              for k, _ in ADAM_LEAVES}
    feats = adam_values(gen, (slots, 16, 3), device, "g")
    grads = {k: adam_values(gen, shape(k), device, "g")
             for k, _ in ADAM_LEAVES}
    grads["features_dc"], grads["features_rest"] = feats[:, :1], feats[:, 1:]
    state = opt.AdamState(
        mu={k: adam_values(gen, shape(k), device, "m") for k in params},
        nu={k: adam_values(gen, shape(k), device, "v") for k in params},
        count=torch.zeros((), dtype=torch.int32, device=device))
    lrs = dict(ADAM_LRS)
    if lr_on_device:
        lrs["xyz"] = torch.tensor([lrs["xyz"]], device=device)
    contrast = opt.AdamGroup(
        torch.tensor(0.17, device=device), torch.tensor(-3e-4, device=device),
        opt.AdamState(torch.tensor(1e-4, device=device),
                      torch.tensor(2e-8, device=device),
                      torch.zeros((), dtype=torch.int32, device=device)),
        0.001)
    return [opt.AdamGroup(params, grads, state, lrs), contrast]


def adam_tensors(results) -> list:
    """Every tensor of [(params, AdamState)], in order."""
    out = []
    for params, state in results:
        for tree in (params, state.mu, state.nu, state.count):
            out += list(tree.values()) if isinstance(tree, dict) else [tree]
    return out


def adam_clone(groups) -> list:
    """The groups with their parameters and states copied (the gradients
    and rates shared)."""
    clone = lambda t: ({k: v.clone() for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    return [opt.AdamGroup(clone(g.params), g.grads, opt.AdamState(
        clone(g.state.mu), clone(g.state.nu), g.state.count.clone()), g.lr)
        for g in groups]


def assert_adam_equal(got, want):
    for a, b in zip(adam_tensors(got), adam_tensors(want), strict=True):
        assert_bits_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("slots", ADAM_SLOTS)
@pytest.mark.parametrize("in_place", [False, True],
                         ids=["out_of_place", "in_place"])
@pytest.mark.parametrize("lr_on_device", [False, True],
                         ids=["lr_float", "lr_pointer"])
def test_adam_kernel_matches_plain_version(slots, in_place, lr_on_device):
    """The two groups of a train step in one launch against
    ``adam_update_plain`` of each, bit for bit, at each of ADAM_COUNTS: out
    of place (the inputs untouched) or in place (the same addresses), the
    position rate a float or read from a device tensor."""
    need_card()
    groups = adam_groups(slots, slots % 97, "cuda", lr_on_device)
    for count in ADAM_COUNTS:
        for g in groups:
            g.state.count.fill_(count - 1)
        want = [opt.adam_update_plain(*g) for g in groups]
        launches = opt.adam_update_kernel.launches
        if in_place:
            work = adam_clone(groups)
            out = [(g.params, g.state) for g in work]
            ptrs = [t.data_ptr() for t in adam_tensors(out)]
            got = opt.adam_update_groups(work, out=out)
            assert [t.data_ptr() for t in adam_tensors(got)] == ptrs
        else:
            before = adam_clone(groups)
            got = opt.adam_update_groups(groups)
            assert_adam_equal([(g.params, g.state) for g in groups],
                              [(g.params, g.state) for g in before])
        assert opt.adam_update_kernel.launches == launches + 1
        assert_adam_equal(got, want)
        assert int(got[0][1].count) == int(got[1][1].count) == count


@pytest.mark.gpu
def test_adam_kernel_bias_corrections_at_every_count():
    """The kernel's float32 ``powf`` of the step count against PyTorch's
    ``pow`` for every count from 1 to 30,000 (the default run's length):
    64 floats a count with p = 0 and a rate of 1, so each output is
    (m'/c1) / (sqrt(v'/c2) + eps) and a c1 or c2 one ulp off moves it.
    Eight counts a launch, each its own group and count; the plain version
    takes all counts at once as a column of counts."""
    need_card()
    n, width = 30_000, 64
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = torch.zeros(n, width, device="cuda")
    g, m, v = (adam_values(gen, (n, width), "cuda", k) for k in "gmv")
    counts = torch.arange(n, dtype=torch.int32, device="cuda")
    outs = [torch.empty_like(p) for _ in range(3)]
    new_counts = torch.empty_like(counts)
    for i0 in range(0, n, opt.MAX_SEGMENTS):
        rows = range(i0, min(i0 + opt.MAX_SEGMENTS, n))
        opt.adam_update_kernel(
            [(p[i], g[i], opt.AdamState(m[i], v[i], counts[i]), 1.0)
             for i in rows],
            out=[(outs[0][i], opt.AdamState(outs[1][i], outs[2][i],
                                            new_counts[i])) for i in rows])
    want_p, want_s = opt.adam_update_plain(
        p, g, opt.AdamState(m, v, counts[:, None]), 1.0)
    assert torch.equal(new_counts, counts + 1)
    for a, b in zip(outs, (want_p, want_s.mu, want_s.nu)):
        assert_bits_equal(a, b)


@pytest.mark.gpu
def test_adam_kernel_in_a_cuda_graph():
    """The in-place update of both groups captured once, the position rate
    read from a device tensor: each replay, with the rate changed before
    it, equals ``adam_update_plain`` on the state just before it bit for
    bit, and the counts advance."""
    need_card()
    live = adam_clone(adam_groups(100_000, 5, "cuda", lr_on_device=True))
    out = [(g.params, g.state) for g in live]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        opt.adam_update_groups(live, out=out)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.adam_update_groups(live, out=out)
    lr = live[0].lr["xyz"]
    for k, rate in enumerate((1e-3, 2e-5, 7e-4)):
        lr.fill_(rate)
        before = adam_clone(live)
        want = [opt.adam_update_plain(*g) for g in before]
        graph.replay()
        assert_adam_equal(out, want)
        assert int(live[0].state.count) == int(live[1].state.count) == k + 2


# the event loss at 1080p and at an odd size (no multiple of 4 pixels)
LOSS_SIZES = ((1080, 1920), (37, 53))
LOSS_SETTINGS = dict(gt_contrast=0.17, event_weight=0.9, blur_alpha=0.5)


def loss_inputs(h, w, seed, gt_channels, deblur, device, offset=False):
    """Seeded event-loss inputs on ``device``: the renders now, next, main
    [h, w, 3] in [0, 1] with 1 % exact zeros (L + ε down to ε), the GT
    images gt_now, gt_next, gt_main of ``gt_channels`` with 30 % of the GT
    pairs unchanged (coverage below 1), planted ties on 5 % of the pixels
    each (r = 0, main = gt_main, blurry = main), the contrast 0.2 [] and
    the blurry image or None.  With ``offset`` each image is the second of
    a stack of two, an element offset that breaks the 16-byte alignment
    at the odd size."""
    rng = np.random.default_rng(seed)
    img = lambda c: rng.uniform(0.0, 1.0, (h, w, c)).astype(np.float32)
    share = lambda p: rng.random((h, w)) < p
    now, nxt, main = img(3), img(3), img(3)
    gnow, gnext, gmain = img(gt_channels), img(gt_channels), img(gt_channels)
    for x in (now, nxt):
        x[rng.random((h, w, 3)) < 0.01] = 0.0
    same = share(0.3)
    gnext[same] = gnow[same]
    tie = share(0.05)
    nxt[tie], gnext[tie] = now[tie], gnow[tie]
    tie = share(0.05)
    main[tie] = gmain[tie]
    blurry = None
    if deblur:
        blurry = img(3)
        tie = share(0.05)
        blurry[tie] = main[tie]

    def put(a):
        t = torch.tensor(a, device=device)
        return torch.stack([torch.zeros_like(t), t])[1] if offset else t

    return (*(put(a) for a in (now, nxt, main, gnow, gnext, gmain)),
            torch.tensor(0.2, device=device),
            None if blurry is None else put(blurry))


def assert_loss_close(got, want, what=""):
    """A loss scalar or the contrast's gradient: sums over 2M pixels in two
    orders (the kernels' in double), so within rtol 1e-5."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0, msg=what)


def loss_operands(h, w, seed, gt_channels, deblur, device, logt=True,
                  frames=True, offset=False):
    """``loss_inputs``' seeded inputs in the forms the train step gives the
    loss: with ``logt`` each render as ``Partials``, its image as rgb and
    a seeded log T in [-14, 0] with 5 % zeros (next's equal to now's, so
    that the event pair's ties stay; the main render's -inf, T = 0, where
    it ties with gt_main or the blurry image, so that its image there is
    its rgb); with ``frames`` each GT image as a ``Frame``, a seeded frame
    of a stack of 3 seeded frames.  ``offset`` as ``loss_inputs``' for the
    operands that are not stacks.  Returns (the renders, the GT operands,
    the contrast, the blurry operand or None, a seeded background [3])."""
    *images, contrast, blurry = loss_inputs(h, w, seed, gt_channels, deblur,
                                            "cpu")
    rng = np.random.default_rng(seed + 1000)
    uniform = lambda lo, hi, *shape: torch.tensor(
        rng.uniform(lo, hi, shape).astype(np.float32))
    renders, gts = images[:3], [*images[3:], blurry]
    if logt:
        lt = uniform(-14.0, 0.0, h, w)
        lt[torch.tensor(rng.random((h, w)) < 0.05)] = 0.0
        lt_main = uniform(-14.0, 0.0, h, w)
        main = renders[2]
        tie = (main == gts[2]).all(-1)
        if blurry is not None:
            tie |= (main == blurry).all(-1)
        lt_main[tie] = -float("inf")
        renders = [ev_loss.Partials(r, t)
                   for r, t in zip(renders, (lt, lt.clone(), lt_main))]
    if frames:
        def framed(g):
            k = int(rng.integers(3))
            stack = uniform(0.0, 1.0, 3, *g.shape)
            stack[k] = g
            return ev_loss.Frame(stack, torch.tensor([k]))

        gts = [None if g is None else framed(g) for g in gts]

    def put(x):
        if x is None:
            return None
        if isinstance(x, (ev_loss.Partials, ev_loss.Frame)):
            return type(x)(*(put(t) if isinstance(x, ev_loss.Partials)
                             else t.to(device) for t in x))
        t = x.to(device)
        return torch.stack([torch.zeros_like(t), t])[1] if offset else t

    return ([put(r) for r in renders], [put(g) for g in gts[:3]],
            contrast.to(device), put(gts[3]), uniform(0.0, 1.0, 3).to(device))


def flat_tensors(xs) -> list:
    """The tensors of loss operands or of the renders' gradients: a
    ``Partials``' rgb and log T, a ``Frame``'s stack and index, else the
    tensor (None: none)."""
    return [t for x in xs if x is not None
            for t in (x if isinstance(x, (ev_loss.Partials, ev_loss.Frame))
                      else (x,))]


def cloned(x, grad=False):
    """A copy of a loss operand (None: None), its float tensors requiring
    a gradient with ``grad``."""
    if x is None:
        return None
    if isinstance(x, (ev_loss.Partials, ev_loss.Frame)):
        return type(x)(*(cloned(t, grad) for t in x))
    return x.clone().requires_grad_(grad and x.is_floating_point())


def check_loss_kernels(images, contrast, kw, grad):
    """Both loss kernels against their plain versions on ``images`` (now,
    next, main, each its image or its ``Partials``; gt_now, gt_next,
    gt_main, each its image or a ``Frame``; the background in ``kw``
    where a render comes as partials): the coverage and the renders'
    gradients (d image, or d rgb and d log T) bit for bit, the loss, its
    parts and the contrast's gradient within rtol 1e-5; the plain
    backward against autograd of the plain forward on the card (the
    renders' gradients bit for bit); the kernels again giving the same
    bits; one launch a call."""
    launches = (ev_loss.event_loss_forward_kernel.launches,
                ev_loss.event_loss_backward_kernel.launches)
    loss, aux = ev_loss.event_loss_forward_kernel(*images, contrast, **kw)
    want_loss, want_aux = ev_loss.event_mixture_loss_plain(*images, contrast,
                                                           **kw)
    assert_bits_equal(aux[2], want_aux["coverage"], "coverage")
    assert_loss_close(loss, want_loss, "loss")
    for i, k in enumerate(ev_loss.AUX):
        if k in want_aux and k != "coverage":
            assert_loss_close(aux[i], want_aux[k], k)
    got = ev_loss.event_loss_backward_kernel(grad, *images, contrast, aux[2],
                                             **kw)
    want = ev_loss.event_loss_backward_plain(grad, *images, contrast,
                                             want_aux["coverage"], **kw)
    names = []
    for r, g in zip(("now", "next", "main"), want[:3]):
        names += ([f"{r} rgb", f"{r} log T"]
                  if isinstance(g, ev_loss.Partials) else [r])
    assert len(flat_tensors(got[:3])) == len(names)
    for a, b, what in zip(flat_tensors(got[:3]), flat_tensors(want[:3]),
                          names):
        assert_bits_equal(a, b, what)
    assert_loss_close(got[3], want[3], "contrast")
    leaves = [cloned(r, grad=True) for r in images[:3]]
    c = cloned(contrast, grad=True)
    auto_loss, _ = ev_loss.event_mixture_loss_plain(*leaves, *images[3:], c,
                                                    **kw)
    auto = torch.autograd.grad(auto_loss, flat_tensors(leaves) + [c], grad)
    for a, b, what in zip(flat_tensors(want[:3]), auto, names):
        assert_bits_equal(a, b, f"plain backward vs autograd: {what}")
    assert_loss_close(want[3], auto[-1], "plain backward vs autograd")
    again = ev_loss.event_loss_forward_kernel(*images, contrast, **kw)
    for a, b in zip(again, (loss, aux)):
        assert_bits_equal(a, b, "forward run twice")
    twice = ev_loss.event_loss_backward_kernel(grad, *images, contrast,
                                               aux[2], **kw)
    for a, b in zip(flat_tensors(twice[:3]) + [twice[3]],
                    flat_tensors(got[:3]) + [got[3]]):
        assert_bits_equal(a, b, "backward run twice")
    assert (ev_loss.event_loss_forward_kernel.launches,
            ev_loss.event_loss_backward_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


# the loss kernels' operand forms: (renders as partials, GT images as
# frames of stacks)
LOSS_FORMS = {"images": (False, False), "partials_frames": (True, True),
              "partials": (True, False), "frames": (False, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(LOSS_FORMS))
@pytest.mark.parametrize("size", LOSS_SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("deblur", [False, True],
                         ids=["event", "event_deblur"])
@pytest.mark.parametrize("gt_channels", [1, 3], ids=["gt1", "gt3"])
def test_event_loss_kernels_match_plain_versions(size, deblur, gt_channels,
                                                 form):
    """The forward and backward loss kernels against
    ``event_mixture_loss_plain`` and ``event_loss_backward_plain``
    (``check_loss_kernels``) at the gradient 1 and a seeded one, on each
    form of their operands (``loss_operands``): images, the renders as
    their partials (composed over the background in the kernels), the GT
    images as frames of stacks at device indices, and both; at the odd
    size also on unaligned operands (the kernels' scalar path); with both,
    also a mix: the main render as its image (the kernels' null log T)
    and the blurry image not a frame."""
    need_card()
    h, w = size
    logt, frames = LOSS_FORMS[form]
    for offset in (False, True) if (h * w) % 4 else (False,):
        renders, gts, contrast, blurry, bg = loss_operands(
            h, w, 7, gt_channels, deblur, "cuda", logt, frames, offset)
        kw = dict(LOSS_SETTINGS, blurry_main=blurry, background=bg)
        for grad in (1.0, -0.37):
            check_loss_kernels([*renders, *gts], contrast, kw,
                               torch.tensor(grad, device="cuda"))
    if form == "partials_frames":
        renders[2] = ev_loss.render_image(renders[2], bg).contiguous()
        if deblur:
            kw["blurry_main"] = ev_loss.frame_image(blurry).contiguous()
        check_loss_kernels([*renders, *gts], contrast, kw,
                           torch.tensor(0.5, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["images", "partials_frames"])
@pytest.mark.parametrize("deblur", [False, True],
                         ids=["event", "event_deblur"])
def test_event_loss_kernels_in_a_cuda_graph(deblur, form):
    """``event_mixture_loss`` (``EventLoss``: both kernels) and its
    gradients captured once at 1080p, on images or, as the graphed step
    gives them, on the renders' partials and the GT images' frames, then
    replayed over other operands (``loss_operands``) copied into the
    captured inputs, the frames' indices and the background among them:
    each replay equals the plain versions on those operands (the coverage
    and the renders' gradients bit for bit, the loss and the contrast's
    gradient within rtol 1e-5), and the kernels launch in the warm-up and
    the capture only."""
    need_card()
    h, w = LOSS_SIZES[0]
    logt, frames = LOSS_FORMS[form]
    renders, gts, contrast, blurry, bg = loss_operands(h, w, 1, 3, deblur,
                                                       "cuda", logt, frames)
    leaves = [cloned(r, grad=True) for r in renders]
    c = cloned(contrast, grad=True)
    live = [cloned(g) for g in (*gts, blurry)]
    background = bg.clone()

    def step():
        loss, aux = ev_loss.event_mixture_loss(
            *leaves, *live[:3], c, blurry_main=live[3],
            background=background, **LOSS_SETTINGS)
        return loss, aux, torch.autograd.grad(loss, flat_tensors(leaves) + [c])

    launches = (ev_loss.event_loss_forward_kernel.launches,
                ev_loss.event_loss_backward_kernel.launches)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss, aux, grads = step()
    for seed in (2, 3):
        renders, gts, contrast, blurry, bg = loss_operands(
            h, w, seed, 3, deblur, "cuda", logt, frames)
        with torch.no_grad():
            for dst, src in zip(
                    flat_tensors([*leaves, *live, c, background]),
                    flat_tensors([*renders, *gts, blurry, contrast, bg])):
                dst.copy_(src)
        graph.replay()
        kw = dict(LOSS_SETTINGS, blurry_main=blurry, background=bg)
        want_loss, want_aux = ev_loss.event_mixture_loss_plain(
            *renders, *gts, contrast, **kw)
        want = ev_loss.event_loss_backward_plain(
            torch.ones((), device="cuda"), *renders, *gts, contrast,
            want_aux["coverage"], **kw)
        assert_bits_equal(aux["coverage"], want_aux["coverage"])
        assert_loss_close(loss, want_loss, "loss")
        for a, b in zip(grads[:-1], flat_tensors(want[:3])):
            assert_bits_equal(a, b)
        assert_loss_close(grads[-1], want[3], "contrast")
    assert (ev_loss.event_loss_forward_kernel.launches,
            ev_loss.event_loss_backward_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


# a process that launches a loss kernel with GT frame indices past their
# stack (argv: "forward" or "backward", the index) and prints "no trap"
# if the launch ran to its end
TRAP_SCRIPT = """
import sys
import torch
from event3dgs_tpu_torch.losses import event as ev
which, index = sys.argv[1], int(sys.argv[2])
stack = torch.rand(3, 16, 24, 3, device="cuda")
frame = ev.Frame(stack, torch.tensor([index], device="cuda"))
img = lambda: torch.rand(16, 24, 3, device="cuda")
renders = [ev.Partials(img(), -torch.rand(16, 24, device="cuda"))
           for _ in range(3)]
bg, c = torch.rand(3, device="cuda"), torch.tensor(0.2, device="cuda")
gts = (stack[0], stack[1], frame)
if which == "forward":
    ev.event_loss_forward_kernel(*renders, *gts, c, background=bg)
else:
    one = torch.ones((), device="cuda")
    ev.event_loss_backward_kernel(one, *renders, *gts, c, one * 0.5,
                                  background=bg)
torch.cuda.synchronize()
print("no trap")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("index", [3, -1, 1 << 40])
def test_event_loss_kernels_trap_an_index_past_the_stack(which, index):
    """A GT frame index outside its stack (the stack's frame count, -1, a
    large one) makes the loss kernels trap instead of reading outside the
    stack: the launch fails on the card (in a process of its own, whose
    CUDA context the trap ends), and the process does not get past its
    synchronise."""
    need_card()
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", TRAP_SCRIPT, which,
                          str(index)], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "no trap" not in run.stdout, (
        run.returncode, run.stdout, run.stderr[-2000:])


@pytest.mark.gpu
def test_event_loss_expf_matches_torch_exp_on_every_float():
    """The loss kernels' ``expf`` (``csrc/loss.cu`` under ``-fmad=false``,
    through its test hook), which composes the renders, against PyTorch's
    ``torch.exp`` on the card, bit for bit, on every float32 bit pattern:
    both signs, the subnormals, the normals, the infinities and the
    NaNs."""
    need_card()
    chunk, top = 1 << 27, 1 << 32
    for start in range(0, top, chunk):
        bits = torch.arange(start, start + chunk, device="cuda")
        x = (bits - (bits >= 1 << 31).long() * (1 << 32)).to(
            torch.int32).view(torch.float32)
        del bits
        y = torch.empty_like(x)
        kernels.launch("loss", "e3d_event_loss_expf", x.data_ptr(),
                       y.data_ptr(), x.numel())
        assert_bits_equal(y, torch.exp(x), f"from bit pattern {start:#x}")


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [False, True], ids=["views", "frames"])
@pytest.mark.parametrize("mode", ["event", "event_deblur"])
def test_step_with_the_fold_equals_the_composed_step_on_the_card(mode,
                                                                  frames):
    """On the card, the train step whose loss kernels compose the renders'
    partials (and, as ``GraphTrainStep`` gives them, read the GT frames
    from their stacks at device indices) against the step that composed
    each render with ``ops/render.composed`` and picked the GT images
    first, the loss kernels then on images: the loss and the eight
    gradients bit for bit, at 3,000 Gaussians and 256×144."""
    need_card()
    state, data, cap = step_state("cuda", 3000, 256, 144)
    cmask = (torch.arange(16, device="cuda") < 9).float()
    before = ev_loss.event_loss_backward_kernel.launches
    loss, got, want_loss, want, names = composed_step_loss_and_grads(
        state, data, mode, cmask, cap, frames=frames)
    assert ev_loss.event_loss_backward_kernel.launches == before + 2
    assert_bits_equal(loss, want_loss, "loss")
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w.contiguous(), name)


@pytest.mark.gpu
def test_event_loss_logf_matches_torch_log_on_every_float():
    """The loss kernels' ``logf`` (``csrc/loss.cu`` under ``-fmad=false``,
    through its test hook) against PyTorch's ``torch.log`` on the card, bit
    for bit, on every float32 bit pattern from +0 up: the subnormals, the
    normals (1e-8 + x and the values near 1 among them), +inf, and the NaNs
    (NaN from both); then on a seeded sample of negative floats (NaN, and
    -inf at -0)."""
    need_card()
    chunk, top = 1 << 27, 1 << 31
    for start in range(0, top, chunk):
        bits = torch.arange(start, min(start + chunk, top), device="cuda")
        x = bits.to(torch.int32).view(torch.float32)
        del bits
        y = torch.empty_like(x)
        kernels.launch("loss", "e3d_event_loss_logf", x.data_ptr(),
                       y.data_ptr(), x.numel())
        assert_bits_equal(y, torch.log(x), f"from bit pattern {start:#x}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = -torch.rand(1 << 20, generator=gen, device="cuda") * 1e3
    x[0] = -0.0
    y = torch.empty_like(x)
    kernels.launch("loss", "e3d_event_loss_logf", x.data_ptr(), y.data_ptr(),
                   x.numel())
    assert_bits_equal(y, torch.log(x), "negative floats")


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
def test_depth_order_kernels_at_ceiling_size():
    """The depth order of 16.8M Gaussians: the radix sort's look-back over
    4,097 tiles a pass and the offsets kernel's over 8,192 + 1 blocks of
    2,048 ranks (far more blocks than the card holds at once), twice (the
    kernels clear their state for the next call): order, offsets and every
    live segment's first rank bit-equal to the plain version."""
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
        assert not tables.lookback.any()  # left cleared


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
        lambda: binning.depth_sort_kernel(tables),
        lambda: binning.depth_offsets_kernel(tables, ranks.order, 1024),
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
        lambda: pre.preprocess_forward_kernel(means, scales, rots, [cam], 1.0,
                                              opac3, feats[:, :1],
                                              feats[:, 1:], None, 3),
        lambda: pre.preprocess_backward_kernel(
            means, scales, rots, [cam], [torch.ones(20, dtype=torch.bool)],
            [means[:, :2]], [means], [means], 1.0, feats[:, :1],
            feats[:, 1:], None, 3),
    ]
    groups = adam_groups(20, 0, "cpu")
    calls += [lambda: opt.adam_update_kernel(groups),
              lambda: opt.adam_update_kernel(
                  groups, out=[(g.params, g.state) for g in groups])]
    wrappers = [binning.gaussian_tables_kernel, binning.depth_order_kernel,
                binning.depth_sort_kernel, binning.depth_offsets_kernel,
                expand.expand_instances_kernel, sort_tiles.tile_histogram_kernel,
                sort_tiles.stable_tile_rank_kernel, rt.composite_forward_kernel,
                rt.composite_backward_kernel, segscan.segment_sums_kernel,
                pre.preprocess_forward_kernel, pre.preprocess_backward_kernel,
                opt.adam_update_kernel]
    counts = [k.launches for k in wrappers]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    assert counts == [k.launches for k in wrappers]
    # a refused in-place update leaves the state's counts as they were
    assert all(int(g.state.count) == 0 for g in groups)


def test_cpu_dispatch_takes_the_plain_versions():
    proj, colors, opac, w, h = scene(n=80, seed=1, w=96, h=64)
    wrappers = (rt.composite_forward_kernel, rt.composite_backward_kernel,
                segscan.segment_sums_kernel, pre.preprocess_forward_kernel,
                pre.preprocess_backward_kernel, opt.adam_update_kernel)
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
    groups = adam_groups(30, 1, "cpu")
    got = opt.adam_update_groups(groups)
    assert_adam_equal(got, [opt.adam_update_plain(*g) for g in groups])
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
    # the expansion, the counting sort and the depth order's segment ranks
    # share csrc/segment.cuh
    header = tmp_path / "segment.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    again = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert sorted(n for n in after if after[n] != again[n]) == [
        "depth_sort", "expand", "sort_tiles"]
    # the two losses share csrc/block_sums.cuh
    header = tmp_path / "block_sums.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    last = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert sorted(n for n in again if again[n] != last[n]) == ["loss", "ssim"]


# the SSIM kernels (csrc/ssim.cu): sizes (1080p; 37×53, ragged; for the
# kernels' 54×16 tiles: 7×5, smaller than the window's halo, one tile
# exactly, and one tile and a pixel in each axis); (mode, GT channels); the
# operand forms of LOSS_FORMS, the render as partials or its image, the GT
# as a frame or its image
PHOTO_SIZES = ((1080, 1920), (37, 53), (5, 7), (16, 54), (17, 55))
PHOTO_CASES = (("rgb", 3), ("gray", 3), ("gray", 1))
PHOTO_CASE_IDS = ("rgb", "gray-gt3", "gray-gt1")


def photometric_operands(h, w, seed, gt_channels, device, logt=True,
                         frames=True):
    """Seeded SSIM-loss operands on ``device``: the render as ``Partials``
    (rgb in [0, 0.9] with 1 % zeros, log T in [-14, 0] with 5 % zeros and,
    where the render ties with the GT, -inf: its image there is its rgb)
    or, without ``logt``, its image; the GT [h, w, gt_channels] in [0, 1]
    with 5 % planted ties (x = y, sgn 0) as a ``Frame``, a seeded frame of
    a stack of 3, or, without ``frames``, its image; a seeded background
    [3]."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    rgb = f(0.0, 0.9, h, w, 3)
    rgb[rng.random((h, w, 3)) < 0.01] = 0.0
    gt = f(0.0, 1.0, h, w, gt_channels)
    tie = rng.random((h, w)) < 0.05
    gt[tie] = rgb[tie][:, :gt_channels]
    lt = f(-14.0, 0.0, h, w)
    lt[rng.random((h, w)) < 0.05] = 0.0
    lt[tie] = -np.inf
    bg = torch.tensor(f(0.0, 1.0, 3), device=device)
    render = torch.tensor(rgb, device=device)
    if logt:
        render = ev_loss.Partials(render, torch.tensor(lt, device=device))
    else:
        render = (render + torch.exp(torch.tensor(lt, device=device))[
            :, :, None] * bg).contiguous()
    gt = torch.tensor(gt, device=device)
    if frames:
        k = int(rng.integers(3))
        stack = torch.tensor(f(0.0, 1.0, 3, h, w, gt_channels),
                             device=device)
        stack[k] = gt
        gt = ev_loss.Frame(stack, torch.tensor([k], device=device))
    return render, gt, bg


def check_photometric_kernels(render, gt, lam, gray, bg, grad):
    """Both SSIM kernels against their plain versions: the derivative maps
    and the render's gradients (d image, or d rgb and d log T) bit for
    bit, the loss and l1 within rtol 1e-5 (sums in two orders); the
    kernels again giving the same bits; one launch a call."""
    from event3dgs_tpu_torch.losses import modes

    launches = (modes.photometric_loss_forward_kernel.launches,
                modes.photometric_loss_backward_kernel.launches)
    loss, l1, maps = modes.photometric_loss_forward_kernel(render, gt, lam,
                                                           gray, bg)
    want_loss, want_l1, want_maps = modes.photometric_loss_plain(
        render, gt, lam, gray, bg)
    assert_loss_close(loss, want_loss, "loss")
    assert_loss_close(l1, want_l1, "l1")
    assert (maps is None) == (want_maps is None) == (lam == 0.0)
    if maps is not None:
        for k, what in enumerate(("D_mu", "D_xx", "D_xy")):
            assert_bits_equal(maps[k], want_maps[k], what)
    got = modes.photometric_loss_backward_kernel(grad, render, gt, maps, lam,
                                                 gray, bg)
    want = modes.photometric_loss_backward_plain(grad, render, gt, want_maps,
                                                 lam, gray, bg)
    got, want = flat_tensors([got]), flat_tensors([want])
    assert len(got) == len(want) == (2 if isinstance(render,
                                                     ev_loss.Partials) else 1)
    for a, b, what in zip(got, want, ("d rgb or d image", "d log T")):
        assert_bits_equal(a, b, what)
    again = modes.photometric_loss_forward_kernel(render, gt, lam, gray, bg)
    for a, b in zip(again, (loss, l1, maps)):
        if b is not None:
            assert_bits_equal(a, b, "forward run twice")
    twice = modes.photometric_loss_backward_kernel(grad, render, gt, maps,
                                                   lam, gray, bg)
    for a, b in zip(flat_tensors([twice]), got):
        assert_bits_equal(a, b, "backward run twice")
    assert (modes.photometric_loss_forward_kernel.launches,
            modes.photometric_loss_backward_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [0.2, 0.0])
@pytest.mark.parametrize("form", list(LOSS_FORMS))
@pytest.mark.parametrize("case", PHOTO_CASES, ids=PHOTO_CASE_IDS)
@pytest.mark.parametrize("size", PHOTO_SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_photometric_kernels_match_plain_versions(size, case, form, lam):
    """The forward and backward SSIM kernels against
    ``photometric_loss_plain`` and ``photometric_loss_backward_plain``
    (``check_photometric_kernels``) at the gradient 1 and a seeded one, in
    rgb and gray mode (a three- and a one-channel GT), on each form of
    their operands (the render as its image or its partials, composed over
    the background in the kernels; the GT as its image or a frame of a
    stack at a device index), at 1080p and at a size of ragged tiles, at
    λ 0.2 and 0 (no SSIM work)."""
    need_card()
    mode, gt_channels = case
    logt, frames = LOSS_FORMS[form]
    render, gt, bg = photometric_operands(*size, 8, gt_channels, "cuda",
                                          logt, frames)
    for grad in (1.0, -0.37):
        check_photometric_kernels(render, gt, lam, mode == "gray", bg,
                                  torch.tensor(grad, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["images", "partials_frames"])
@pytest.mark.parametrize("case", PHOTO_CASES, ids=PHOTO_CASE_IDS)
def test_photometric_kernels_in_a_cuda_graph(case, form):
    """``rgb_total_loss`` / ``gray_total_loss`` (``PhotometricLoss``: both
    kernels) and the render's gradients captured once at 1080p, on images
    or, as the graphed step gives them, on the render's partials and the
    GT's frame, then replayed over other operands copied into the captured
    inputs (the frame's index and the background among them): each replay
    equals the plain versions on those operands (the gradients bit for
    bit, the loss and l1 within rtol 1e-5), and the kernels launch in the
    warm-up and the capture only."""
    from event3dgs_tpu_torch.losses import modes

    need_card()
    mode, gt_channels = case
    gray = mode == "gray"
    total = modes.gray_total_loss if gray else modes.rgb_total_loss
    h, w = PHOTO_SIZES[0]
    logt, frames = LOSS_FORMS[form]
    render, gt, bg = photometric_operands(h, w, 1, gt_channels, "cuda", logt,
                                          frames)
    leaf = cloned(render, grad=True)
    live, background = cloned(gt), bg.clone()

    def step():
        loss, aux = total(leaf, live, 0.2, background=background)
        return loss, aux["l1"], torch.autograd.grad(
            loss, flat_tensors([leaf]))

    launches = (modes.photometric_loss_forward_kernel.launches,
                modes.photometric_loss_backward_kernel.launches)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss, l1, grads = step()
    for seed in (2, 3):
        render, gt, bg = photometric_operands(h, w, seed, gt_channels,
                                              "cuda", logt, frames)
        with torch.no_grad():
            for dst, src in zip(flat_tensors([leaf, live, background]),
                                flat_tensors([render, gt, bg])):
                dst.copy_(src)
        graph.replay()
        want_loss, want_l1, maps = modes.photometric_loss_plain(
            render, gt, 0.2, gray, bg)
        want = modes.photometric_loss_backward_plain(
            torch.ones((), device="cuda"), render, gt, maps, 0.2, gray, bg)
        assert_loss_close(loss, want_loss, "loss")
        assert_loss_close(l1, want_l1, "l1")
        for a, b in zip(grads, flat_tensors([want])):
            assert_bits_equal(a, b)
    assert (modes.photometric_loss_forward_kernel.launches,
            modes.photometric_loss_backward_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("size", PHOTO_SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_photometric_forward_refuses_a_partials_scratch_one_row_short(size,
                                                                      gray):
    """The forward kernel's launch refuses a partials scratch one row
    shorter than the library asks for (``modes.partials_rows``: a row a
    block of its grid, whose tiles differ by mode) and takes one of exactly
    that size, equal to the wrapper's call; nothing is counted as a launch
    of the wrapper."""
    from event3dgs_tpu_torch.losses import modes

    need_card()
    render, gt, bg = photometric_operands(*size, 8, 3, "cuda")
    rows = modes.partials_rows(*size, gray)
    assert rows >= 1
    launches = modes.photometric_loss_forward_kernel.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        modes.launch_photometric_forward(render, gt, 0.2, gray, bg,
                                         rows=rows - 1)
    got = modes.launch_photometric_forward(render, gt, 0.2, gray, bg,
                                           rows=rows)
    want = modes.photometric_loss_forward_kernel(render, gt, 0.2, gray, bg)
    for a, b in zip(got, want):
        assert_bits_equal(a, b, "a scratch of exactly the rows")
    assert modes.photometric_loss_forward_kernel.launches == launches + 1


# a process that launches an SSIM kernel with a GT frame index past its
# stack (argv: "forward" or "backward", the index) and prints "no trap" if
# the launch ran to its end
PHOTO_TRAP_SCRIPT = """
import sys
import torch
from event3dgs_tpu_torch.losses import event as ev
from event3dgs_tpu_torch.losses import modes
which, index = sys.argv[1], int(sys.argv[2])
stack = torch.rand(3, 16, 24, 3, device="cuda")
frame = ev.Frame(stack, torch.tensor([index], device="cuda"))
render = ev.Partials(torch.rand(16, 24, 3, device="cuda"),
                     -torch.rand(16, 24, device="cuda"))
bg = torch.rand(3, device="cuda")
if which == "forward":
    modes.photometric_loss_forward_kernel(render, frame, background=bg)
else:
    maps = torch.rand(3, 16, 24, 3, device="cuda")
    modes.photometric_loss_backward_kernel(torch.ones((), device="cuda"),
                                           render, frame, maps,
                                           background=bg)
torch.cuda.synchronize()
print("no trap")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("index", [3, -1, 1 << 40])
def test_photometric_kernels_trap_an_index_past_the_stack(which, index):
    """A GT frame index outside its stack (the stack's frame count, -1, a
    large one) makes the SSIM kernels trap instead of reading outside the
    stack, in a process of its own, which does not get past its
    synchronise."""
    need_card()
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", PHOTO_TRAP_SCRIPT, which,
                          str(index)], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "no trap" not in run.stdout, (
        run.returncode, run.stdout, run.stderr[-2000:])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rgb", "gray"])
def test_photometric_step_kernel_path_matches_the_plain_path(mode):
    """On ``bench.py``'s scene (4,000 Gaussians, 8 views at 160×96), the
    rgb and gray steps' loss through the kernel path against the all-plain
    path (``plain=True``: the preprocess, K1-K6 and the SSIM loss in plain
    PyTorch) within 1e-5 relative, their gradients within 2e-4 of each
    field's max; the kernel path launches each SSIM kernel once."""
    from event3dgs_tpu_torch.losses import modes
    from event3dgs_tpu_torch.tools.kernel_timing import bench_state
    from event3dgs_tpu_torch.train.step import make_loss_and_grads
    from event3dgs_tpu_torch.utils.config import EventConfig

    need_card()
    state, data, cap = bench_state("cuda", 4000, 160, 96, views=8)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    launches = (modes.photometric_loss_forward_kernel.launches,
                modes.photometric_loss_backward_kernel.launches)
    (lk, ak, gk), (lp, ap, gp) = (
        make_loss_and_grads(mode, EventConfig(), 0.2, rasterizer="tiled",
                            instance_cap=cap, plain=plain)(
            state, data, 3, 3, 4, bg)
        for plain in (False, True))
    assert (modes.photometric_loss_forward_kernel.launches,
            modes.photometric_loss_backward_kernel.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(lk) and abs(float(lk) - float(lp)) <= \
        1e-5 * abs(float(lp)), (float(lk), float(lp))
    assert_loss_close(ak["l1"], ap["l1"], "l1")
    for name in gk["params"]:
        a, b = gk["params"][name], gp["params"][name]
        scale = b.abs().max().clamp(min=1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=2e-4, rtol=0,
                                   msg=name)
