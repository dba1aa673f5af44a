#!/usr/bin/env python3
"""Smoke run of event3dgs_tpu_torch's render and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. Build the CUDA kernels of ``event3dgs_tpu_torch/csrc/`` (one ``nvcc``
   per source, in parallel) and print what ``-Xptxas -v`` reports.
2. Generate a model from seed 0 with ``bench.py``'s scene recipe: 100k
   Gaussians, SH degree 3 with small random higher-order coefficients,
   saved as a PLY with a ``cfg.json``, and a Blender-style source with
   four 1920×1080 views at ``bench.py``'s four camera poses.
3. Render the train views through the entry point
   (``event3dgs_tpu_torch.cli.render.main``) and check that each kernel of
   the path (K1, K4, K5, K6) launched once per view and that the PNGs exist.
4. Hold each render kernel against its plain PyTorch version at the shapes
   of view 0 (K4, K5, K6 exactly, K1 within 1e-5), one full view of the
   kernel path against the all-plain path, and the kernel path against the
   oracle rasterizer on a small scene.
5. Time each render kernel, its plain version and the PyTorch yardstick
   call with CUDA events, and one view's render with the host clock.
6. Train through the entry point: a COLMAP scene with 8 views at
   1920×1080 (``images/`` and ``images_event/``) and a 100k-point cloud
   drawn like ``bench.py``'s scene; ``cli.train --gray --event`` for 6
   iterations with densification at 3 and 6 (threshold 0, so both passes
   clone and split every Gaussian and the instance cap is re-measured), then
   ``cli.render`` on the saved PLY.  Every kernel (K1-K6) must launch 3
   times per step, the alive count must grow and the loss must be finite.
7. At ``bench.py``'s training configuration (100k Gaussians with its
   scales, 4 cameras, event mode, spatial_lr_scale 3.0, a measured instance
   cap): K1's stop index, K2's rows (1e-5 of the max) and K3 (bit-equal)
   against their plain versions on the main view; one step's gradients,
   kernel path against the all-plain path (2e-4 of each field's max); the
   same step twice under ``torch.use_deterministic_algorithms`` giving
   bit-identical parameters.
8. Time the event step (host clock: ``bench.py``'s pixels/s over a 50-step
   window, then the median and spread of 50 steps timed one by one),
   profile one step, and time K2 and K3 with CUDA events; the bounds count
   the (pixel, instance) pairs by what the kernels do with them.  Then
   densify the timed state with capacity growth and run one more step at a
   re-measured instance cap (3 launches of each kernel, finite loss).

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line of per-kernel numbers, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# cuBLAS needs this before CUDA starts for use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1920, 1080
VIEWS = 4
TRAIN_VIEWS = 8
TRAIN_ITERS = 6
DEVICE = "cuda"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM FP32 outside the tensor cores is 67 TFLOP/s with an FMA counted
# as two operations.  The kernels are built with -fmad=false, so they issue
# no FMA: one FP32 instruction is one operation, at half that rate.
PEAK_FP32_PER_S = 33.5e12
# exp, log and reciprocal run on the special function units: 16 of an SM's
# 128 lanes per clock, so an eighth of the FP32 instruction rate
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 8
# (FP32, SFU) operations per (pixel, instance) pair a compositing kernel
# visits, by what it does with the pair: skipped at power > 0, skipped at
# raw < 1/255, composited.  Counted from the sources' arithmetic
# (rasterize_fwd.cu, rasterize_bwd.cu), an expf, log1pf or division as one
# SFU operation and nothing more, so the bound stays a lower bound.
K1_PAIR_OPS = ((10, 0), (12, 1), (23, 3))
K2_PAIR_OPS = ((10, 0), (12, 1), (53, 4))
CUDA_BASELINE_PIX_S = 30e6  # bench.py's yardstick for vs_baseline
# bench.py times 5 steps; a 50-step window separates a noisy host from
# stalls, and its median and spread are printed beside bench.py's mean
STEP_ITERS = 50
WARMUP_STEPS = 3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def bench_scene(rng):
    """bench.py's scene (`_scene`): means, scales, rotations, opacities,
    colors."""
    n = N_GAUSSIANS
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)]
    scales = (np.exp(rng.uniform(np.log(0.005), np.log(0.03), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    return means, scales, rots, opac, colors


def generate(root: str):
    """Phase 2: model dir + Blender-style source dir under ``root``."""
    from PIL import Image

    from event3dgs_tpu_torch.core.sh import rgb_to_sh
    from event3dgs_tpu_torch.data.ply import save_gaussian_ply, store_point_cloud
    from event3dgs_tpu_torch.data.scene import CameraInfo
    from event3dgs_tpu_torch.models import params_from_numpy
    from event3dgs_tpu_torch.tools.render_products import export_transforms_json
    from event3dgs_tpu_torch.utils.config import TrainConfig

    rng = np.random.default_rng(0)
    means, scales, rots, opac, colors = bench_scene(rng)
    params = params_from_numpy(dict(
        xyz=means,
        features_dc=rgb_to_sh(colors)[:, None, :],
        features_rest=rng.normal(0.0, 0.05, (N_GAUSSIANS, 15, 3)),
        scaling=np.log(scales),
        rotation=rots,
        opacity=np.log(opac / (1 - opac))[:, None],
        alive=np.ones(N_GAUSSIANS, bool),
    ), device="cpu")
    model, src = os.path.join(root, "model"), os.path.join(root, "src")
    save_gaussian_ply(os.path.join(model, "point_cloud", "iteration_1",
                                   "point_cloud.ply"), params)
    cfg = TrainConfig()
    cfg.model.source_path = src
    cfg.model.resolution = 1
    cfg.model.sh_degree = 3
    with open(os.path.join(model, "cfg.json"), "w") as f:
        f.write(cfg.to_json())
    # bench.py's camera poses (`bench_train_step`): identity rotation,
    # translations (0.01·i, 0, 0.02·i), fov_x 1.2
    infos = [
        CameraInfo(uid=i, R=np.eye(3), T=np.asarray([0.01 * i, 0.0, 0.02 * i]),
                   fov_x=1.2, fov_y=0.75, image_path="", image_name=f"r_{i}",
                   width=WIDTH, height=HEIGHT)
        for i in range(VIEWS)
    ]
    os.makedirs(os.path.join(src, "train"))
    export_transforms_json(infos, os.path.join(src, "transforms_train.json"))
    gray = np.full((HEIGHT, WIDTH, 3), 128, np.uint8)
    for i in range(VIEWS):
        Image.fromarray(gray).save(os.path.join(src, "train", f"r_{i}.png"))
    store_point_cloud(os.path.join(src, "points3d.ply"), means[:1000],
                      np.full((1000, 3), 128))
    return model, src


def generate_colmap(root: str) -> str:
    """Phase 6's source: a COLMAP scene with ``TRAIN_VIEWS`` views at
    bench.py's camera poses (identity rotation, centers (-0.01·i, 0,
    -0.02·i)), ``images/`` and ``images_event/`` holding the same smooth
    patterns that move from view to view, and a point cloud drawn like
    bench.py's scene."""
    from PIL import Image

    from event3dgs_tpu_torch.core.transforms import fov2focal
    from event3dgs_tpu_torch.data.colmap import ColmapCamera, ColmapImage, write_model

    src = os.path.join(root, "colmap")
    rng = np.random.default_rng(0)
    means, _, _, _, colors = bench_scene(rng)
    cams = {1: ColmapCamera(id=1, model="PINHOLE", width=WIDTH, height=HEIGHT,
                            params=np.array([fov2focal(1.2, WIDTH),
                                             fov2focal(0.75, HEIGHT),
                                             WIDTH / 2.0, HEIGHT / 2.0]))}
    images = {
        i + 1: ColmapImage(id=i + 1, qvec=np.array([1.0, 0.0, 0.0, 0.0]),
                           tvec=np.array([0.01 * i, 0.0, 0.02 * i]),
                           camera_id=1, name=f"r_{i:05d}.png")
        for i in range(TRAIN_VIEWS)
    }
    write_model(cams, images, (means, colors * 255.0), os.path.join(src, "sparse", "0"))
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    for folder in ("images", "images_event"):
        os.makedirs(os.path.join(src, folder))
    for i in range(TRAIN_VIEWS):
        img = np.stack([0.5 + 0.4 * np.sin(x / (60.0 + 7 * c) + 0.3 * i)
                        * np.cos(y / (45.0 + 5 * c) - 0.2 * i) for c in range(3)],
                       axis=-1)
        png = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        for folder in ("images", "images_event"):
            png.save(os.path.join(src, folder, f"r_{i:05d}.png"))
    return src


def pair_ops(pairs, table):
    """(FP32, SFU) operations of the visited pairs ``pairs`` (counts by
    kind, as ``_composite_plain`` returns them)."""
    return (sum(n * fp for n, (fp, _) in zip(pairs, table)),
            sum(n * sfu for n, (_, sfu) in zip(pairs, table)))


def pairs_text(pairs) -> str:
    return (f"{sum(pairs)} (pixel, instance) pairs visited: {pairs[0]} skipped "
            f"at power > 0, {pairs[1]} at raw < 1/255, {pairs[2]} composited")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_view(fn, what: str = "one view", top: int = 12):
    """Where ``fn``'s time goes: device time per kernel name (torch
    profiler) against its host-clock time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"profile of {what}: {wall_ms:.2f} ms host clock (profiler on), "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(r[1] for r in rows)} device kernels")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.4f} ms  x{count:<3d} {key[:90]}")


def wrappers():
    """Every kernel's launch wrapper, by name."""
    from event3dgs_tpu_torch.ops import expand, segscan, sort_tiles
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt

    return {
        "K1 composite_forward": rt.composite_forward_kernel,
        "K2 composite_backward": rt.composite_backward_kernel,
        "K3 segment_sums": segscan.segment_sums_kernel,
        "K4 expand_instances": expand.expand_instances_kernel,
        "K5 tile_histogram": sort_tiles.tile_histogram_kernel,
        "K6 stable_tile_rank": sort_tiles.stable_tile_rank_kernel,
    }


def count_launches(fn):
    """Run ``fn`` with every launch count set to 0; return (its result, the
    counts it left)."""
    import torch

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in ws.items()}


def render_path(root: str, dev):
    """Phases 2-5: cli.render on bench.py's model; the render kernels against
    their plain versions and timed.  Returns (launches, errors, rows)."""
    import torch

    from event3dgs_tpu_torch.cli.render import main as render_main
    from event3dgs_tpu_torch.data.ply import load_gaussian_ply
    from event3dgs_tpu_torch.data.scene import build_camera_batch, read_blender_scene
    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops import binning, expand, sort_tiles
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.ops.projection import project_gaussians
    from event3dgs_tpu_torch.ops.rasterize_reference import rasterize_reference
    from event3dgs_tpu_torch.ops.render import gaussian_colors, render

    # 2. generate ----------------------------------------------------------
    t0 = time.perf_counter()
    model, src = generate(root)
    print(f"generate: {time.perf_counter() - t0:.1f} s")

    # 3. the render path: cli.render on the card ----------------------------
    t0 = time.perf_counter()
    rc, launches = count_launches(
        lambda: render_main(["-m", model, "--skip_test", "--device", DEVICE]))
    check(rc == 0, "cli.render failed")
    cli_s = time.perf_counter() - t0
    print(f"cli.render: {VIEWS} views in {cli_s:.2f} s (PNG IO included); "
          f"launches {launches}")
    for k, n in launches.items():
        want = 0 if k[:2] in ("K2", "K3") else VIEWS
        check(n == want, f"{k} launched {n} times for {VIEWS} views")
    out = os.path.join(model, "train", "ours_1")
    for sub in ("renders", "gt"):
        for i in range(VIEWS):
            p = os.path.join(out, sub, f"{i:05d}.png")
            check(os.path.exists(p), f"missing {p}")
    from PIL import Image

    png = np.asarray(Image.open(os.path.join(out, "renders", "00000.png")))
    check(png.shape == (HEIGHT, WIDTH, 3), f"render shape {png.shape}")
    check(png.std() > 1.0, "view 0 rendered flat")

    # 4. kernels vs plain versions at view 0's shapes --------------------
    params = load_gaussian_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"),
        device=dev)
    cams = build_camera_batch(read_blender_scene(src).train_cameras, 1,
                              device=dev)
    cam = cams[0]
    act = activated(params)
    proj = project_gaussians(act.means3d, act.scales, act.rotations, cam,
                             opacities=act.opacities)
    colors = gaussian_colors(3, act.features, act.means3d, cam.camera_center)
    cap = rt.default_instance_cap(N_GAUSSIANS)
    tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT)
    nt = tiles_x * tiles_y
    tables = binning.depth_tables(proj.mean2d, proj.depth, proj.radius,
                                  proj.valid, WIDTH, HEIGHT,
                                  opacities=act.opacities, conic=proj.conic)
    n_live = tables.offsets[-1:]
    errs = {}

    tk, gk = expand.expand_instances_kernel(*tables, cap, tiles_x, nt)
    tp, gp = expand.expand_instances_plain(*tables, cap, tiles_x, nt)
    errs["K4 expand_instances"] = max(
        (tk - tp).abs().max().item(), (gk - gp).abs().max().item())
    ck = sort_tiles.tile_histogram_kernel(tk, nt, n_live)
    cp = sort_tiles.tile_histogram_plain(tk, nt, n_live)
    errs["K5 tile_histogram"] = (ck - cp).abs().max().item()
    starts = (torch.cumsum(ck, 0) - ck).to(torch.int32)
    dk = sort_tiles.stable_tile_rank_kernel(tk, n_live, nt, starts, cap)
    dp = sort_tiles.stable_tile_rank_plain(tk, n_live, nt, starts, cap)
    errs["K6 stable_tile_rank"] = (dk - dp).abs().max().item()
    for k in ("K4 expand_instances", "K5 tile_histogram", "K6 stable_tile_rank"):
        check(errs[k] == 0, f"{k} differs from its plain version by {errs[k]}")

    bk = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                               WIDTH, HEIGHT, cap, opacities=act.opacities,
                               conic=proj.conic)
    bp = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                               WIDTH, HEIGHT, cap, opacities=act.opacities,
                               conic=proj.conic, plain=True)
    check(torch.equal(bk.inst_gauss, bp.inst_gauss)
          and torch.equal(bk.tile_counts, bp.tile_counts)
          and torch.equal(bk.dest, bp.dest), "binning differs")
    live = int(bk.tile_counts.sum())
    n_inst = int(n_live)
    print(f"view 0: {n_inst} rect instances, {live} after the ellipse cull, "
          f"cap {cap}, overflow {int(bk.overflow)}, "
          f"max per tile {int(bk.tile_counts.max())}")
    check(int(bk.overflow) == 0, "instance cap overflowed")

    feat = rt.pack_features(proj.mean2d, proj.conic, colors, act.opacities)
    k1_args = (bk.inst_gauss, bk.tile_offsets, bk.tile_counts, feat, tiles_x,
               WIDTH, HEIGHT)
    rk, lk, sk = rt.composite_forward_kernel(*k1_args)
    rp, lp, sp, pairs = rt._composite_plain(*k1_args)
    pairs = pairs.tolist()
    errs["K1 composite_forward"] = (rk - rp).abs().max().item()
    t_err = (torch.exp(lk) - torch.exp(lp)).abs().max().item()
    print(f"K1 vs plain: rgb {errs['K1 composite_forward']:.3g}, T {t_err:.3g}; "
          + pairs_text(pairs))
    check(errs["K1 composite_forward"] <= 1e-5, "K1 rgb differs by > 1e-5")
    check(t_err <= 1e-6, "K1 transmittance differs by > 1e-6")
    check(torch.equal(sk, sp), "K1 stop index differs from its plain version")

    bg = torch.zeros(3, device=dev)
    view = (act.means3d, act.features, act.opacities, act.scales,
            act.rotations, cam, bg)
    img_k = render(*view, sh_degree=3, rasterizer="tiled").image
    img_p = rt.rasterize_tiled(proj, colors, act.opacities, bg, WIDTH, HEIGHT,
                               plain=True)
    view_err = (img_k - img_p).abs().max().item()
    check(torch.isfinite(img_k).all().item(), "non-finite image")
    check(view_err <= 1e-5, f"view 0: kernel path vs plain path {view_err}")
    print(f"view 0 image, kernel path vs all-plain path: max |diff| {view_err:.3g}")

    # the oracle on a small scene (tests/test_rasterize_tiled.py's simple one)
    from event3dgs_tpu_torch.core import make_camera

    rng = np.random.default_rng(0)
    n = 80
    small = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        np.c_[rng.uniform(-1.2, 1.2, n), rng.uniform(-0.48, 0.48, n),
              rng.uniform(2.0, 6.0, n)],
        np.exp(rng.uniform(np.log(0.03), np.log(0.25), (n, 1)))
        * rng.uniform(0.7, 1.4, (n, 3)),
        rng.normal(size=(n, 4)), rng.uniform(0.2, 0.95, n),
        rng.uniform(0.0, 1.0, (n, 3)))]
    scam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, 256, 64, device=dev)
    sproj = project_gaussians(small[0], small[1], small[2], scam)
    sbg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    tiled = rt.rasterize_tiled(sproj, small[4], small[3], sbg, 256, 64)
    oracle = rasterize_reference(sproj, small[4], small[3], sbg, 256, 64)
    torch.testing.assert_close(tiled, oracle, atol=2e-5, rtol=1e-4)
    print(f"small scene, kernels vs oracle: max |diff| "
          f"{(tiled - oracle).abs().max().item():.3g}")

    # 5. timing --------------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reps = 5
    with torch.no_grad():
        for _ in range(reps):
            render(*view, sh_degree=3, rasterizer="tiled")
    torch.cuda.synchronize()
    view_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"render, one {WIDTH}x{HEIGHT} view (N={N_GAUSSIANS}, SH 3, kernels): "
          f"{view_ms:.2f} ms host clock; peak memory {peak:.0f} MiB")
    with torch.no_grad():
        profile_view(lambda: render(*view, sh_degree=3, rasterizer="tiled"))

    ids_long = tk.long()
    timings = {
        "K4 expand_instances": (
            lambda: expand.expand_instances_kernel(*tables, cap, tiles_x, nt),
            lambda: expand.expand_instances_plain(*tables, cap, tiles_x, nt),
            None, 50),
        "K5 tile_histogram": (
            lambda: sort_tiles.tile_histogram_kernel(tk, nt, n_live),
            lambda: sort_tiles.tile_histogram_plain(tk, nt, n_live),
            lambda: torch.bincount(ids_long, minlength=nt + 1), 50),
        "K6 stable_tile_rank": (
            lambda: sort_tiles.stable_tile_rank_kernel(tk, n_live, nt, starts, cap),
            lambda: sort_tiles.stable_tile_rank_plain(tk, n_live, nt, starts, cap),
            lambda: torch.sort(tk, stable=True), 50),
        "K1 composite_forward": (
            lambda: rt.composite_forward_kernel(*k1_args),
            lambda: rt.composite_forward_plain(*k1_args),
            None, 20),
    }
    capped = min(n_inst, cap)
    bounds = {  # (bytes, (FP32, SFU) operations) this run's inputs need
        "K4 expand_instances": (
            (N_GAUSSIANS + 1) * 4 + N_GAUSSIANS * (4 + 12 + 32) + cap * 8,
            (0, 0)),
        "K5 tile_histogram": (capped * 4 + nt * 4, (0, 0)),
        "K6 stable_tile_rank": (capped * 4 + nt * 4 + cap * 4, (0, 0)),
        "K1 composite_forward": (
            live * 4 + N_GAUSSIANS * 48 + nt * 8 + WIDTH * HEIGHT * 20,
            pair_ops(pairs, K1_PAIR_OPS)),
    }
    meta = {
        "K1 composite_forward": ("rasterize_fwd.cu", "event3dgs_tpu/ops/rasterize_tiled.py:296"),
        "K4 expand_instances": ("expand.cu", "event3dgs_tpu/ops/expand.py:65"),
        "K5 tile_histogram": ("sort_tiles.cu", "event3dgs_tpu/ops/sort_tiles.py:62"),
        "K6 stable_tile_rank": ("sort_tiles.cu", "event3dgs_tpu/ops/sort_tiles.py:88"),
    }
    return launches, errs, kernel_rows(timings, bounds, meta, errs)


def kernel_rows(timings, bounds, meta, errs):
    """Time each kernel, its plain version and its yardstick; one JSON row
    each (``launches`` is filled in by the caller)."""
    rows = {}
    for name, (kern, plain, lib, iters) in timings.items():
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(plain, max(iters // 10, 2), warmup=1)
        lib_ms = cuda_ms(lib, iters) if lib is not None else None
        nbytes, (fp32, sfu) = bounds[name]
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        # the FP32 lanes and the SFUs work side by side
        t_ops = max(fp32 / PEAK_FP32_PER_S, sfu / PEAK_SFU_PER_S) * 1e3
        src_file, replaces = meta[name]
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": f"event3dgs_tpu_torch/csrc/{src_file}",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": lib_ms,
        }
        lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_txt} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({rows[name]['bound_by']})")
    return rows


def train_path(root: str):
    """Phase 6: cli.train --gray --event on a 1080p COLMAP scene, then
    cli.render on its PLY.  Returns the training run's launch counts."""
    from event3dgs_tpu_torch.cli.render import main as render_main
    from event3dgs_tpu_torch.cli.train import main as train_main

    t0 = time.perf_counter()
    src = generate_colmap(root)
    print(f"generate COLMAP scene: {time.perf_counter() - t0:.1f} s")
    model = os.path.join(root, "trained")
    # threshold 0: every alive Gaussian is a candidate, so both densify
    # passes clone and split and the instance cap is re-measured on twice
    # the Gaussians.  In event mode the densify statistic is the main view's
    # gradient, weighted by 1 - coverage of the event pair: near 0 here, so
    # no Gaussian crosses the default 2e-4 in 6 steps.
    args = ["-s", src, "-m", model, "--gray", "--event", "-r", "1",
            "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "2",
            "--densification_interval", "3", "--densify_grad_threshold", "0",
            "--save_iterations", str(TRAIN_ITERS),
            "--checkpoint_iterations", str(TRAIN_ITERS), "--device", DEVICE]
    print("cli.train " + " ".join(args))
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            rc, launches = count_launches(lambda: train_main(args))
    finally:
        print(log.getvalue().strip())
    train_s = time.perf_counter() - t0
    check(rc == 0, "cli.train failed")
    print(f"cli.train: {TRAIN_ITERS} iterations in {train_s:.2f} s (scene "
          f"load, init and PLY/checkpoint IO included); launches {launches}")
    for k, n in launches.items():
        check(n == 3 * TRAIN_ITERS,
              f"{k} launched {n} times in {TRAIN_ITERS} event steps")
    last = re.search(r"last loss (\S+)", log.getvalue())
    check(last is not None and math.isfinite(float(last.group(1))),
          "no finite loss reported")
    alive = [int(n) for n in re.findall(r"num_alive=(\d+)", log.getvalue())]
    check(len(alive) == 2, "densify did not run at iterations 3 and 6")
    check(N_GAUSSIANS < alive[0] < alive[1],
          f"densify did not add Gaussians: {N_GAUSSIANS} -> {alive}")
    caps = re.findall(r"instance_cap=(\d+)", log.getvalue())
    print(f"densify: {N_GAUSSIANS} -> {alive[0]} -> {alive[1]} alive; instance "
          f"cap re-measured upward {len(caps)} times ({', '.join(caps) or '-'}), "
          f"each time with the step rebuilt")
    ck = np.load(os.path.join(model, f"chkpnt{TRAIN_ITERS}.npz"))
    check(int(ck["step"]) == TRAIN_ITERS, "checkpoint step")
    check(not ck["stats/denom"].any(), "densify at the last iteration did not "
          "reset the stats")
    for key in ("params/xyz", "params/opacity", "params/scaling", "contrast"):
        check(np.isfinite(ck[key]).all(), f"non-finite {key} in the checkpoint")
    print(f"checkpoint: {int(ck['params/alive'].sum())} alive of "
          f"{ck['params/alive'].shape[0]} slots, contrast "
          f"{float(ck['contrast']):.6f}")

    t0 = time.perf_counter()
    rc, rlaunches = count_launches(
        lambda: render_main(["-m", model, "--device", DEVICE]))
    check(rc == 0, "cli.render of the trained model failed")
    print(f"cli.render of the trained model: {TRAIN_VIEWS} views in "
          f"{time.perf_counter() - t0:.2f} s; launches {rlaunches}")
    for k, n in rlaunches.items():
        want = 0 if k[:2] in ("K2", "K3") else TRAIN_VIEWS
        check(n == want, f"{k} launched {n} times rendering {TRAIN_VIEWS} views")
    renders = os.path.join(model, "train", f"ours_{TRAIN_ITERS}", "renders")
    check(len(os.listdir(renders)) == TRAIN_VIEWS, "missing trained renders")
    return launches


def bench_state(dev):
    """bench.py's `bench_train_step` set-up: state, data, instance cap."""
    import torch

    from event3dgs_tpu_torch.core.camera import make_camera, stack_cameras
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.models.gaussians import GaussianParams
    from event3dgs_tpu_torch.train import SceneData, init_train_state
    from event3dgs_tpu_torch.train.loop import measure_instance_cap

    means, scales, rots, opac, colors = bench_scene(np.random.default_rng(0))
    cameras = stack_cameras([
        make_camera(np.eye(3), np.asarray([0.01 * i, 0.0, 0.02 * i]), 1.2, 0.75,
                    WIDTH, HEIGHT, device=dev) for i in range(4)])
    images = torch.tensor(np.random.default_rng(1).uniform(
        0, 1, (4, HEIGHT, WIDTH, 3)), dtype=torch.float32, device=dev)
    params = init_from_point_cloud(means, colors, capacity=N_GAUSSIANS,
                                   device=dev)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    params = GaussianParams(
        xyz=params.xyz, features_dc=params.features_dc,
        features_rest=params.features_rest, scaling=f32(np.log(scales)),
        rotation=f32(rots), opacity=f32(np.log(opac / (1 - opac))[:, None]),
        alive=params.alive)
    state = init_train_state(params, spatial_lr_scale=3.0)
    data = SceneData(cameras=cameras, images=images, event_cameras=cameras,
                     event_images=images)
    return state, data, measure_instance_cap(state.params, cameras)


def train_kernels(dev):
    """Phases 7-8 at bench.py's training configuration.  Returns (errors,
    rows of K2 and K3, launches per step)."""
    import torch

    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops import binning, segscan
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.ops.projection import project_gaussians
    from event3dgs_tpu_torch.ops.render import gaussian_colors
    from event3dgs_tpu_torch.train.step import make_loss_and_grads, make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    state, data, icap = bench_state(dev)
    opt, ev = OptimizationConfig(), EventConfig()
    bg = torch.zeros(3, device=dev)
    idx = (1, 1, 2)  # bench.py's views: main 1, event pair 1 → 2
    print(f"bench training state: {N_GAUSSIANS} Gaussians, 4 views at "
          f"{WIDTH}x{HEIGHT}, measured instance cap {icap}")

    # 7. K1's stop index, K2 and K3 against their plain versions, main view
    # (K2 visits exactly K1's pairs, so K1's plain version counts them)
    cam = data.cameras[idx[0]]
    act = activated(state.params)
    with torch.no_grad():
        proj = project_gaussians(act.means3d, act.scales, act.rotations, cam,
                                 opacities=act.opacities)
        colors = gaussian_colors(3, act.features, act.means3d, cam.camera_center)
        b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius,
                                  proj.valid, WIDTH, HEIGHT, icap,
                                  opacities=act.opacities, conic=proj.conic)
        feat = rt.pack_features(proj.mean2d, proj.conic, colors, act.opacities)
    check(int(b.overflow) == 0, "measured instance cap overflowed")
    fwd = (b.inst_gauss, b.tile_offsets, b.tile_counts, feat, b.num_tiles_x,
           WIDTH, HEIGHT)
    _, logt, stop = rt.composite_forward_kernel(*fwd)
    _, _, stop_p, pairs = rt._composite_plain(*fwd)
    check(torch.equal(stop, stop_p), "K1 stop index differs from its plain version")
    pairs = pairs.tolist()
    g = torch.Generator().manual_seed(7)
    g_rgb = (torch.rand(HEIGHT, WIDTH, 3, generator=g) - 0.5).to(dev)
    g_logt = (torch.rand(HEIGHT, WIDTH, generator=g) - 0.5).to(dev)
    k2_args = fwd + (g_rgb, g_logt, logt, stop, icap)
    rows_k = rt.composite_backward_kernel(*k2_args)
    rows_p = rt.composite_backward_plain(*k2_args)
    live = int(b.tile_counts.sum())
    scale = rows_p[:live].abs().max().item()
    errs = {"K2 composite_backward":
            (rows_k[:live] - rows_p[:live]).abs().max().item()}
    check(errs["K2 composite_backward"] <= 1e-5 * scale,
          f"K2 rows differ by {errs['K2 composite_backward']:.3g} "
          f"(max {scale:.3g})")
    gk = rt.gaussian_grads(b, rows_k)
    gp = rt.gaussian_grads(b, rows_k, plain=True)
    errs["K3 segment_sums"] = (gk - gp).abs().max().item()
    check(torch.equal(gk, gp), "K3 differs from its plain version")
    print(f"main view: {live} live instances, {pairs_text(pairs)}; K2 vs "
          f"plain max |diff| {errs['K2 composite_backward']:.3g} of max "
          f"{scale:.3g}; K3 vs plain bit-equal; K1 stop index equal")

    # one step's gradients: kernel path against the all-plain path
    grads = {}
    for plain in (False, True):
        fn = make_loss_and_grads("event", ev, ev.event_lambda_dssim,
                                 rasterizer="tiled", instance_cap=icap,
                                 plain=plain)
        loss, _, gr = fn(state, data, *idx, bg)
        grads[plain] = dict(gr["params"], contrast=gr["contrast"], tap=gr["tap"],
                            loss=loss)
    worst = 0.0
    for k, gk_ in grads[False].items():
        gp_ = grads[True][k]
        check(bool(torch.isfinite(gk_).all()), f"non-finite gradient {k}")
        err = ((gk_ - gp_).abs().max() / gp_.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, err)
        check(err <= 2e-4, f"step gradient {k}: kernel vs plain {err:.3g} of max")
    print(f"one event step, kernel path vs all-plain path: gradients within "
          f"{worst:.3g} of each field's max; loss {float(grads[False]['loss']):.6f} "
          f"vs {float(grads[True]['loss']):.6f}")

    # the same step twice from the same state, deterministic algorithms on
    step = make_train_step("event", opt, ev, spatial_lr_scale=3.0,
                           rasterizer="tiled", instance_cap=icap)
    torch.use_deterministic_algorithms(True)
    try:
        s1, _ = step(state, data, *idx, bg)
        s2, _ = step(state, data, *idx, bg)
    finally:
        torch.use_deterministic_algorithms(False)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        check(torch.equal(getattr(s1.params, f), getattr(s2.params, f)),
              f"step not repeatable: {f}")
    check(torch.equal(s1.stats.grad_accum, s2.stats.grad_accum)
          and torch.equal(s1.contrast, s2.contrast), "step not repeatable")
    print("one event step run twice under use_deterministic_algorithms: "
          "bit-identical parameters, contrast and stats")

    # 8. timing: bench.py's event step ---------------------------------------
    (st, _), per_step = count_launches(lambda: step(state, data, *idx, bg))
    for k, n in per_step.items():
        check(n == 3, f"{k}: {n} launches in one event step")
    for _ in range(WARMUP_STEPS):
        st, _ = step(st, data, *idx, bg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # bench.py's measure: one window, synchronised at its end
    t0 = time.perf_counter()
    for _ in range(STEP_ITERS):
        st, metrics = step(st, data, *idx, bg)  # state evolves every call
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEP_ITERS
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(math.isfinite(float(metrics["loss"])), "non-finite loss")
    # and each step on its own, synchronised after it
    each = []
    for _ in range(STEP_ITERS):
        t1 = time.perf_counter()
        st, metrics = step(st, data, *idx, bg)
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t1) * 1e3)
    check(math.isfinite(float(metrics["loss"])), "non-finite loss")
    q = np.percentile(each, [0, 10, 50, 90, 100])
    print(f"event train step (bench.py's configuration): {dt * 1e3:.3f} ms "
          f"host clock, mean of a {STEP_ITERS}-step window; each of "
          f"{STEP_ITERS} more steps: median {q[2]:.3f} ms, p10 {q[1]:.3f}, "
          f"p90 {q[3]:.3f}, min {q[0]:.3f}, max {q[4]:.3f}; peak memory "
          f"{peak:.0f} MiB")
    pix_s = 3 * WIDTH * HEIGHT / dt
    print(json.dumps({
        "metric": "train-step pixels/s at 1080p (3 renders/step)",
        "value": round(pix_s, 1), "unit": "pixels/s",
        "vs_baseline": round(pix_s / CUDA_BASELINE_PIX_S, 4)}))
    profile_view(lambda: step(st, data, *idx, bg), what="one event step",
                 top=15)

    n_exp = min(int(b.offsets[-1]), icap)
    rows_pad = torch.cat([rows_k, rows_k.new_zeros(1, rt.NGRAD)])
    dest = b.dest[:n_exp].long()
    gathered = rows_pad[torch.where(dest < icap, dest, icap)]
    off = torch.clamp(b.offsets.long(), max=icap)
    lengths = off[1:] - off[:-1]
    timings = {
        "K2 composite_backward": (
            lambda: rt.composite_backward_kernel(*k2_args),
            lambda: rt.composite_backward_plain(*k2_args), None, 20),
        "K3 segment_sums": (
            lambda: rt.gaussian_grads(b, rows_k),
            lambda: rt.gaussian_grads(b, rows_k, plain=True),
            lambda: torch.segment_reduce(gathered, "sum", lengths=lengths), 50),
    }
    nt = b.tile_counts.shape[0]
    bounds = {
        "K2 composite_backward": (
            live * 4 + N_GAUSSIANS * 48 + nt * 8 + WIDTH * HEIGHT * 24
            + live * rt.NGRAD * 4, pair_ops(pairs, K2_PAIR_OPS)),
        "K3 segment_sums": (
            live * rt.NGRAD * 4 + n_exp * 4 + (N_GAUSSIANS + 1) * 4
            + N_GAUSSIANS * 4 + N_GAUSSIANS * rt.NGRAD * 4,
            (live * rt.NGRAD, 0)),
    }
    meta = {
        "K2 composite_backward": ("rasterize_bwd.cu",
                                  "event3dgs_tpu/ops/rasterize_tiled.py:386"),
        "K3 segment_sums": ("segsum.cu", "event3dgs_tpu/ops/segscan.py:46"),
    }
    rows = kernel_rows(timings, bounds, meta, errs)
    densify_growth(st, data, idx, bg)
    return errs, rows, per_step


def densify_growth(state, data, idx, bg):
    """Densify the timed state with capacity growth (its 100k slots are all
    alive, so any candidate grows them), then one event step at a
    re-measured instance cap: every kernel launches 3 times and the loss is
    finite.  Threshold 0 makes every alive Gaussian a candidate: the
    event pair's coverage is 1 on bench.py's random images, so the main
    view's gradient, the densify statistic, is exactly 0."""
    import torch

    from event3dgs_tpu_torch.train.loop import densify_with_growth, measure_instance_cap
    from event3dgs_tpu_torch.train.step import make_densify_step, make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    dev = state.params.device
    capacity, alive = state.params.capacity, int(state.params.alive.sum())
    gen = torch.Generator().manual_seed(0)
    normals = lambda c: torch.randn((2, c, 3), generator=gen).to(dev)
    # extent 3.0: bench.py's spatial_lr_scale, the reference's scene extent
    densify = make_densify_step(OptimizationConfig(densify_grad_threshold=0.0),
                                3.0)
    t0 = time.perf_counter()
    grown, grew = densify_with_growth(state, densify, normals,
                                      use_size_prune=False)
    torch.cuda.synchronize()
    densify_ms = (time.perf_counter() - t0) * 1e3
    alive_after = int(grown.params.alive.sum())
    check(grew and grown.params.capacity > capacity,
          f"capacity did not grow from {capacity}")
    check(alive_after > alive, f"densify added no Gaussian ({alive})")
    icap = measure_instance_cap(grown.params, data.cameras)
    step = make_train_step("event", OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=3.0, rasterizer="tiled",
                           instance_cap=icap)
    (after, metrics), launches = count_launches(
        lambda: step(grown, data, *idx, bg))
    for k, n in launches.items():
        check(n == 3, f"{k}: {n} launches in the step after densify")
    check(math.isfinite(float(metrics["loss"])), "non-finite loss after densify")
    for f in ("xyz", "scaling", "opacity"):
        check(bool(torch.isfinite(getattr(after.params, f)).all()),
              f"non-finite {f} after densify")
    print(f"densify with growth: {alive} -> {alive_after} alive, capacity "
          f"{capacity} -> {grown.params.capacity}, {densify_ms:.1f} ms host "
          f"clock; next step at instance cap {icap}: launches {launches}, "
          f"loss {float(metrics['loss']):.6f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from event3dgs_tpu_torch.ops import kernels

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    for name, log in kernels.build().items():
        print(f"--- nvcc {name}.cu (sm_90a) ---\n{log.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as root:
        render_launches, _, rows = render_path(root, dev)
        train_launches = train_path(root)
    _, train_rows, per_step = train_kernels(dev)
    rows.update(train_rows)
    print(f"launches: cli.render {render_launches}; cli.train "
          f"{train_launches}; one event step {per_step}")
    for name, row in rows.items():
        row["launches"] = train_launches[name]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
