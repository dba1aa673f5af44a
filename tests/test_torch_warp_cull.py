"""The warp cull of the compositing kernels K1 and K2 is conservative.

In K1 and K2 (``csrc/rasterize_fwd.cu``, ``csrc/rasterize_bwd.cu``) each
warp owns a 16×8 sub-block of its 32×32 tile and skips the instances whose
α ≥ 1/255 region cannot reach it.  ``rasterize_tiled.warp_cull_mask``
repeats the kernels' test operation for operation.  A culled (pixel,
instance) pair must be one the kernels would skip anyway: no pair that
``_TileGeometry.chunk`` keeps (alpha > 0, the kernels' arithmetic) may lie
in a culled sub-block, or K1's outputs would leave its plain version's.
Checked on the kernel tests' scenes, a scene drawn like ``bench.py``'s at
1920×1080, and hypothesis-drawn adversarial splats.
"""

import copy

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from event3dgs_tpu_torch.core import make_camera
from event3dgs_tpu_torch.ops import binning
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.ops.projection import project_gaussians
from test_torch_kernels import HARD_SCENES, SCENES, scene

torch.set_num_threads(1)


def cull_report(inst_gauss, tile_offsets, tile_counts, feat, tiles_x, w, h,
                tiles_per_step=64):
    """Over every (pixel inside the image, instance) pair of every tile's
    list: (pairs kept with alpha > 0 in a culled sub-block, culled pairs,
    pairs)."""
    nt = tile_counts.shape[0]
    geo = rt._TileGeometry(nt, tiles_x, w, h, "cpu")
    feat_pad = torch.cat([feat, feat.new_zeros(1, rt.FEAT)])
    bad = culled = total = 0
    for t0 in range(0, nt, tiles_per_step):
        sl = slice(t0, t0 + tiles_per_step)
        sub = copy.copy(geo)
        sub.ox, sub.oy, sub.inside = geo.ox[sl], geo.oy[sl], geo.inside[sl]
        counts = tile_counts[sl]
        for d0 in range(0, int(counts.max()), rt.DEPTH_CHUNK):
            _, has, _, f, *_, alpha = sub.chunk(inst_gauss, tile_offsets[sl],
                                                counts, feat_pad, d0)
            reach = rt.warp_cull_mask(f, sub.ox[:, None], sub.oy[:, None])
            pair = has[..., None] & sub.inside[:, None, :]
            cut = pair & ~reach[..., geo.sub]
            bad += int((cut & (alpha > 0.0)).sum())
            culled += int(cut.sum())
            total += int(pair.sum())
    return bad, culled, total


def binned(proj, colors, opac, w, h):
    b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                              w, h, rt.default_instance_cap(proj.mean2d.shape[0]),
                              opacities=opac, conic=proj.conic)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    return (b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x,
            w, h)


@pytest.mark.parametrize("name", sorted(SCENES) + sorted(HARD_SCENES))
def test_warp_cull_keeps_every_composited_pair(name):
    made = (scene(**SCENES[name]) if name in SCENES
            else HARD_SCENES[name]("cpu"))
    bad, culled, total = cull_report(*binned(*made))
    assert bad == 0, f"{bad} composited pairs in culled sub-blocks"
    assert total > 0 and culled > 0


def test_warp_cull_on_a_1080p_scene():
    """bench.py's scene recipe (means, scales, opacities; fov 1.2 × 0.75)
    at 1920×1080, cut to 10k Gaussians: no composited pair culled, and the
    cull removes a good share of the pairs."""
    rng = np.random.default_rng(0)
    n = 10_000
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)]
    scales = (np.exp(rng.uniform(np.log(0.005), np.log(0.03), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.75, 1920, 1080, device="cpu")
    proj = project_gaussians(f(means), f(scales), f(rots), cam, opacities=f(opac))
    bad, culled, total = cull_report(*binned(proj, f(colors), f(opac), 1920, 1080))
    assert bad == 0, f"{bad} composited pairs in culled sub-blocks"
    assert culled > 0.3 * total, (culled, total)


def test_plain_compositing_counts_the_culled_visits():
    """``_composite_plain``'s fourth count is the visited pairs the warp
    cull removes: none of them composited, most of them on thin splats
    centred on the sub-block edges."""
    args = binned(*HARD_SCENES["thin_edges"]("cpu"))
    _, _, stop, pairs = rt._composite_plain(*args)
    power_skipped, raw_skipped, composited, culled = pairs.tolist()
    assert power_skipped + raw_skipped + composited == int(stop.sum())
    assert 0.5 * (power_skipped + raw_skipped) < culled <= power_skipped + raw_skipped


def test_deep_scene_needs_several_staging_rounds():
    """The kernel tests' ``deep_tiles`` scene has tiles of more than 256
    instances (K1 stages 256 per round, K2 64), and pixels that stop inside
    a later round as well as pixels that never stop."""
    inst, offs, counts, feat, tiles_x, w, h = binned(*HARD_SCENES["deep_tiles"]("cpu"))
    _, _, stop, _ = rt._composite_plain(inst, offs, counts, feat, tiles_x, w, h)
    assert int(counts.max()) > 256
    tile = (torch.arange(h)[:, None] // 32) * tiles_x + torch.arange(w)[None, :] // 32
    count = counts[tile]
    for batch in (256, 64):
        assert bool(((stop > batch) & (stop < count) & (stop % batch != 0)).any())
    assert bool((stop == count).any())


# --- adversarial splats ------------------------------------------------------

W = H = 64  # 2×2 tiles; every splat is listed in every tile

_jitter = st.sampled_from([0.0, 1e-3, -1e-3, 0.25, -0.25, 0.5, -0.5, 0.999,
                           -0.999, 1.5, -1.5, 7.0, -7.0])
_alpha_min = np.float32(1.0 / 255.0)
_opacity = st.one_of(
    st.sampled_from([float(np.nextafter(_alpha_min, np.float32(1))),
                     float(_alpha_min * np.float32(1 + 1e-6)),
                     float(_alpha_min * np.float32(1.001)),
                     0.99, float(np.nextafter(np.float32(0.99), np.float32(1))),
                     0.995, 1.0]),
    st.floats(float(_alpha_min), 1.0, width=32),
)


@st.composite
def splats(draw):
    """(mean x, y, conic a, b, c, opacity) of one splat: centred on or near
    a sub-block or tile edge; thin (axis ratio 8 and up), round, or
    degenerate."""
    mx = draw(st.sampled_from(range(0, W + 1, 16))) + draw(_jitter)
    my = draw(st.sampled_from(range(0, H + 1, 8))) + draw(_jitter)
    kind = draw(st.sampled_from(["thin", "thin", "round", "degenerate"]))
    if kind == "degenerate":
        v = draw(st.floats(-3.0, 3.0, width=32))
        conic = draw(st.sampled_from([(0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                      (v * v, v, 1.0), (1e-13, 0.0, 1e-13),
                                      (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)]))
    else:
        major = draw(st.floats(0.5, 60.0))
        ratio = draw(st.floats(8.0, 400.0)) if kind == "thin" else 1.0
        theta = draw(st.one_of(st.sampled_from([0.0, np.pi / 4, np.pi / 2]),
                               st.floats(0.0, np.pi)))
        r = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
        cov = r @ np.diag([major ** 2, (major / ratio) ** 2]) @ r.T
        inv = np.linalg.inv(cov)
        conic = (inv[0, 0], inv[0, 1], inv[1, 1])
    return (mx, my) + tuple(conic) + (draw(_opacity),)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(splats(), min_size=1, max_size=6))
def test_warp_cull_is_conservative_on_adversarial_splats(drawn):
    a = np.asarray(drawn, np.float32)
    n = a.shape[0]
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    feat = rt.pack_features(t(a[:, 0:2]), t(a[:, 2:5]), t(np.full((n, 3), 0.5)),
                            t(a[:, 5]))
    tiles_x, nt = W // 32, (W // 32) * (H // 32)
    inst = torch.arange(n, dtype=torch.int32).repeat(nt)
    offs = torch.arange(nt, dtype=torch.int32) * n
    counts = torch.full((nt,), n, dtype=torch.int32)
    bad, _, total = cull_report(inst, offs, counts, feat, tiles_x, W, H)
    assert total == n * W * H
    assert bad == 0
