"""The port's CUDA kernels (K1-K6) against their plain PyTorch versions, and
the wrappers' dispatch rules.

This file imports neither JAX nor the JAX package, so on a machine with a
card and without JAX it runs on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

Tests marked ``gpu`` need a CUDA card and skip without one; the others run
anywhere.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from event3dgs_tpu_torch.core import make_camera
from event3dgs_tpu_torch.models import activated, params_from_numpy
from event3dgs_tpu_torch.ops import binning, expand, kernels, segscan, sort_tiles
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.ops.projection import project_gaussians
from event3dgs_tpu_torch.ops.render import render

torch.set_num_threads(1)


def scene(n, seed, w, h, spread=1.2, z=(2.0, 6.0), scale=(0.03, 0.25),
          ratio=1.0, device="cpu"):
    """Random Gaussians in front of an identity camera, projected."""
    rng = np.random.default_rng(seed)
    means = np.c_[rng.uniform(-spread, spread, n),
                  rng.uniform(-spread * 0.4, spread * 0.4, n), rng.uniform(*z, n)]
    scales = (np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)) * [1.0, 1.0 / ratio, 1.0])
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 0.95, n)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, w, h, device=device)
    proj = project_gaussians(f(means), f(scales), f(rots), cam, opacities=f(opac))
    return proj, f(colors), f(opac), w, h


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


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cap", [None, 1024])
def test_binning_kernels_match_plain_versions(name, cap):
    need_card()
    proj, _, opac, w, h = scene(**SCENES[name], device="cuda")
    cap = cap or rt.default_instance_cap(proj.mean2d.shape[0])
    tables = binning.depth_tables(proj.mean2d, proj.depth, proj.radius,
                                  proj.valid, w, h, opacities=opac,
                                  conic=proj.conic)
    tiles_x, tiles_y = binning.tile_grid(w, h)
    nt = tiles_x * tiles_y
    before = expand.expand_instances_kernel.launches
    tk, gk = expand.expand_instances(*tables, cap, tiles_x, nt)
    assert expand.expand_instances_kernel.launches == before + 1
    tp, gp = expand.expand_instances_plain(*tables, cap, tiles_x, nt)
    assert torch.equal(tk, tp) and torch.equal(gk, gp)
    n_live = tables.offsets[-1:]
    ck = sort_tiles.tile_histogram(tk, nt, n_live)
    assert torch.equal(ck, sort_tiles.tile_histogram_plain(tk, nt, n_live))
    starts = (torch.cumsum(ck, 0) - ck).to(torch.int32)
    dk = sort_tiles.stable_tile_rank(tk, n_live, nt, starts, cap)
    assert torch.equal(dk, sort_tiles.stable_tile_rank_plain(tk, n_live, nt,
                                                             starts, cap))
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


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself (the dispatchers pick it for CPU tensors)."""
    proj, colors, opac, w, h = scene(n=50, seed=0, w=64, h=64)
    tables = binning.depth_tables(proj.mean2d, proj.depth, proj.radius,
                                  proj.valid, w, h, opacities=opac,
                                  conic=proj.conic)
    ids = torch.zeros(8, dtype=torch.int32)
    live = torch.tensor([8], dtype=torch.int32)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    img = torch.zeros(h, w)
    rows = torch.zeros(8, 9)
    calls = [
        lambda: expand.expand_instances_kernel(*tables, 1024, 2, 4),
        lambda: sort_tiles.tile_histogram_kernel(ids, 4, live),
        lambda: sort_tiles.stable_tile_rank_kernel(
            ids, live, 4, torch.zeros(4, dtype=torch.int32), 8),
        lambda: rt.composite_forward_kernel(
            ids, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), feat, 2, w, h),
        lambda: rt.composite_backward_kernel(
            ids, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), feat, 2, w, h,
            torch.zeros(h, w, 3), img, img, img.to(torch.int32), 8),
        lambda: segscan.segment_sums_kernel(rows, ids, ids, 8, ids, ids),
    ]
    wrappers = [expand.expand_instances_kernel, sort_tiles.tile_histogram_kernel,
                sort_tiles.stable_tile_rank_kernel, rt.composite_forward_kernel,
                rt.composite_backward_kernel, segscan.segment_sums_kernel]
    counts = [k.launches for k in wrappers]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    assert counts == [k.launches for k in wrappers]


def test_cpu_dispatch_takes_the_plain_versions():
    proj, colors, opac, w, h = scene(n=80, seed=1, w=96, h=64)
    wrappers = (rt.composite_forward_kernel, rt.composite_backward_kernel,
                segscan.segment_sums_kernel)
    before = [k.launches for k in wrappers]
    colors.requires_grad_(True)
    img = rt.rasterize_tiled(proj, colors, opac, torch.zeros(3), w, h)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    (g,) = torch.autograd.grad(img.sum(), [colors])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert [k.launches for k in wrappers] == before


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the port loads no kernel library; each source has its own
    library path, keyed by the source's content, and exports the C launch
    functions the bindings declare."""
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
