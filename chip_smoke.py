#!/usr/bin/env python3
"""Smoke run of event3dgs_tpu_torch's render and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

1. Build the CUDA kernels of ``event3dgs_tpu_torch/csrc/`` and the
   probes' K1 and K4 builds with ablation macros (one ``nvcc`` per build,
   in parallel) and print what ``-Xptxas -v`` reports.
2. Generate a model from seed 0 with ``bench.py``'s scene recipe: 100k
   Gaussians, SH degree 3 with small random higher-order coefficients,
   saved as a PLY with a ``cfg.json``, and a Blender-style source with
   four 1920×1080 views at ``bench.py``'s four camera poses.
3. Render the train views through the entry point
   (``event3dgs_tpu_torch.cli.render.main``) and check that each kernel of
   the path (the forward preprocess, the binning's table kernel, radix
   sort and depth offsets kernel, K1, K4, K5, K6) launched once per view, that
   ``pack_features`` was called nowhere (the preprocess forward writes the
   packed rows K1 reads) and that the PNGs exist.
4. Hold each render kernel against its plain PyTorch version at the shapes
   of view 0 (the forward preprocess bit for bit: mean2d, depth, conic,
   radius, valid, colours and the packed rows, the rows also against
   ``pack_features`` of the kernel's own outputs; the table kernel, the
   radix sort and the depth offsets kernel (also alone, and against
   ``radix_order_plain`` too), K4 with its count rows, K5, K6, the fused
   counting sort with and without K4's rows and
   the whole ``Binning`` exactly, K1 within 1e-5), one full view of the
   kernel path against the all-plain path, and the kernel path against the
   oracle rasterizer on a small scene.  The fused counting sort (K5 and K6
   with the tile lists) must run as its three CUDA functions and nothing
   else, and the binning from the projection's outputs to the ``Binning``
   in at most 10 device kernels (memsets and copies counted beside them),
   none of them a library sort.
5. Time each render kernel, its plain version and the PyTorch yardstick
   call with CUDA events (per call, the host's enqueue included) and the
   profiler's device time in the kernel's own CUDA functions (``device_ms``:
   each function's time over the launches the profiler saw of it),
   and one view's render with the host clock.
6. Train through the entry point: a COLMAP scene with 8 views at
   1920×1080 (``images/``, ``images_event/`` and the held-out ``renders/``)
   and a 100k-point cloud drawn like ``bench.py``'s scene; ``cli.train
   --gray --event`` for 6 iterations with densification at 3 and 6
   (threshold 0, so both passes clone and split every Gaussian and the
   instance cap is re-measured), then ``cli.render`` on the saved PLY (the
   train and test sets).  Every kernel of a render (K1-K6 and the
   binning's table kernel, radix sort and depth offsets kernel) must
   launch 3 times per
   step, the preprocess forward and backward once (one launch for the
   step's three views), the Adam kernel once (the six leaves and the
   contrast in one launch) and the loss kernels once each (forward and
   backward, ``csrc/loss.cu``), the forward preprocess once more per
   instance-cap probe (``train/loop.probe_instance_count``, counted), the
   alive count must grow and the loss must be finite.  Then ``cli.train``
   in rgb mode (no flag) and in gray mode (``--gray``) on the same scene
   for 2 iterations each: each render kernel and the SSIM loss kernels
   (``csrc/ssim.cu``) once a step, the event loss kernels never, no
   ``ops/render.composed`` and no ``F.conv2d`` call, a finite loss; the
   SSIM kernels' JSON rows take their launches from these two runs.
7. At ``bench.py``'s training configuration (100k Gaussians with its
   scales, 4 cameras, event mode, spatial_lr_scale 3.0, a measured instance
   cap): the forward preprocess over the step's three 1080p views with
   the step's zero mean2d tap and the packed rows (bit-equal, the rows to
   ``pack_features`` too), the backward preprocess there on seeded
   upstream gradients
   (2e-4 of each gradient's max, the feature gradients bit-equal,
   bit-identical run twice), with both kernels' registers and resident
   blocks per SM, K1's stop index, K2's rows (1e-5 of the max) and K3
   (bit-equal) against their plain versions on the main view, and K2 run
   twice giving bit-identical rows; the table kernel, the radix sort, the
   depth offsets kernel, K4, K5,
   K6, the fused counting sort and the whole ``Binning`` there exactly (and
   the counting sort and the binning's device kernels timed); one step's
   gradients, kernel path against the
   all-plain path (2e-4 of each field's max); the same step twice under
   ``torch.use_deterministic_algorithms`` giving bit-identical parameters;
   the Adam kernel (``csrc/adam.cu``) on the next step's update of that
   state, two chained updates out of place and in place, bit-equal to its
   plain version; the two loss kernels (``csrc/loss.cu``) on the step's
   three 1080p renders as their partials (rgb, log T; composed by the
   kernels over a seeded background) and the GT images as frames of their
   stacks at device indices, in event and event_deblur mode, and on the
   composed images and picked frames in event mode (the sharded step's
   form), against their plain versions (the coverage and the renders'
   gradients, d rgb and d log T, bit for bit, the loss, its parts and the
   contrast's gradient within rtol 1e-5; the plain backward bit-equal to
   autograd's; two runs bit-identical).  The two SSIM loss kernels
   (``csrc/ssim.cu``) on the main view's 1080p render as its partials
   (composed by the kernels over a seeded background) and its GT as the
   frame of ``images`` at a device index, in rgb and gray mode, and on the
   composed image and picked frame in rgb mode (the sharded step's form),
   against their plain versions: the three derivative maps and the
   render's gradients (d rgb and d log T, or d image) bit for bit, the
   loss and l1 within rtol 1e-5, two runs bit-identical.
8. Time the event step (host clock: ``bench.py``'s pixels/s over a 50-step
   window, then the median and spread of 50 steps timed one by one),
   profile one step (its device kernels), check that neither the eager
   step nor the graphed one (``FusedSteps``' warm-up and capture) calls
   ``pack_features`` or ``ops/render.composed`` (the loss kernels compose
   the renders), print the device nodes one graphed step enqueues (its
   CUDA graph read back; its ``indexSelect`` nodes, 16: the table row and
   15 camera fields, the GT frames read where they lie) and its device ms
   per replay; the same for one rgb and one gray step, eager (each kernel
   of the render and the SSIM loss kernels launched once, no
   ``composed``, no ``F.conv2d``) and graphed (6 ``indexSelect`` nodes:
   the table row, 5 camera fields); time the
   forward preprocess with and without the packed rows, and time K2, K3,
   the Adam kernel (its yardstick
   ``torch._fused_adam_``, one call per learning rate), the event loss
   kernels and the SSIM loss kernels in rgb mode, gray mode's graph ms
   beside them (no yardstick: no one PyTorch call computes a loss), as in
   phase 5, with the SSIM kernels' registers, spills and shared memory; K3
   also over the
   rows put into expansion order beforehand and, through ``dest``, in
   each of its two orders of work (``ops/segscan.py``), each bit-equal to
   K3 as the path calls it, with their graph ms.  Then densify
   the timed state with capacity growth and run one more step at a
   re-measured instance cap (3 launches of each kernel, finite loss).

9. (Run after phase 6, on its trained model of ~400k alive Gaussians.)
   ``cli.evaluate --save_images --lpips_weights`` with AlexNet-shaped
   random weights from seed 0: each render kernel launched once for the
   holdout view 5, finite SSIM, PSNR and LPIPS, the ``sim_``/``real_``
   PNGs; LPIPS of one 1080p pair on the card against the CPU for the three
   backbones (rtol 1e-4), its time on the card and its convolutions' FLOPs
   against the FP32 peak; ``cli.metrics``
   (``results.json``, ``per_view.json``); ``cli.render --depth --point
   --blurrySpeed 1 --export_transforms --skip_test``: 8 depth, 8 point and
   7 blurry images and the transforms, each render kernel launched
   8 + 8 + 7·18 times, the forward preprocess 8 more for the point maps;
   ``point_depth_map`` launching the forward preprocess alone; a blurry
   frame timed alone; an SH degree 4 render of ``bench.py``'s scene, kernel
   path against the all-plain path within 1e-5.  Each part prints its wall
   time with the card's name and power limit.
10. (On the same model, behind a copy of its source whose cameras are 20
   times farther apart along x: phase 6's move about a pixel from view to
   view, too little for the DVS to fire.) ``cli.render --event
   --interpolationN 3 --dt 1000 --skip_train --skip_test``: 22 renders of
   the interpolated chain, each render kernel launched 22 times,
   ``raw.dat`` read back (events, sorted timestamps, x < 1920, y < 1080)
   and one ``frames/`` PNG per window; the four frame functions of
   ``events/accumulate`` on the card against the CPU, exactly, on the
   stream's busiest window (repeated pixels) and on it with half its x
   moved past the row; the native DVS simulator, built with g++, equal to
   the numpy model along the chain (deterministic, frame by frame from the
   first until one fires); each part of the synthesis timed on the host
   clock (renders, host copies, PNG writes, luminance, the median DVS
   update per 1080p frame of each simulator, the frames on the card, the
   ``.dat`` write), the numpy model reproducing the CLI's stream; and
   ``cli.generate_dataset`` with ``--events raw.dat`` and with
   ``--images`` of the chain's 22 renders.
11. (Last, on phase 6's COLMAP scene.) ``init_distributed`` at world size 1 with
   NCCL and a 1 × 1 mesh; ``train_loop_sharded`` (exact mode) and
   ``train_loop`` from the same state for 6 event steps, densifying at 3
   and 6 as phase 6 does: each render kernel launched 3 times per step in
   both (the preprocess kernels once a step in ``train_loop``, 3 times in
   the sharded step, which projects each render on its own), the loss
   histories within rel 1e-5 and the same alive count;
   each loop's host clock per step and peak device memory; one step of
   each (``train_step``, the sharded step) at the trained state timed in
   turns, 10 steps a turn, with its peak memory; the profiler's
   device time in NCCL kernels over one more sharded run; then
   ``destroy_process_group``.  ``synthesize_scene`` writes an 8-view
   1920×1080 scene of 100k Gaussians through the kernels (each render
   kernel once per view) and its COLMAP model reads back.

12. (After phase 10 and phases 7-8, before phase 11.) The profiling probes
   (``event3dgs_tpu_torch/tools/kernel_probes.py`` ``all``) at full size,
   every probe build's launch count set to 0 before and read after: the
   event step of phases 7-8's state in seven cumulative stages (device µs,
   device kernels, event and host ms each); each K1 and K4 build (the
   timing-only ablations, ``base`` and K1's ``clock``) at phase 4's view
   (device ms, registers, spills, blocks per SM, K1's evaluated pairs, the
   tile imbalance from ``clock``); K1's stop statistics at both views; K1,
   K2 and K3 relaunched at the train view against their bounds; the
   dynamic-grid kernel of ``csrc/probes.cu`` in a CUDA graph; each build
   of the SSIM loss kernels (``kernel_probes.SSIM_VARIANTS``: ``base`` and
   the timing-only ablations), forward and backward, in rgb and gray mode
   on seeded 1080p partials and a GT frame (graph and event ms,
   registers, shared bytes, blocks per SM: the split).  Checks: ``base``
   is the shipping K1 library and it and ``clock`` equal the shipping K1
   bit for bit; the SSIM ``base`` is the shipping library and equals the
   shipping kernels bit for bit; the graph's replays give 3·1024 and 7·1024
   over ones, and over a seeded input whose sums depend on the block order
   (at 3, 7, 0, -1, past capacity and 3 again) each replay equals the
   plain version bit for bit; the stop statistics of K1's stop equal
   those of the plain K1's; stage 7's parameters (finite) equal
   ``train_step``'s from the same state.  A probe row's ``launches``
   counts its wrapper's calls in that run, the 20 calls captured into a
   CUDA graph for ``graph_ms`` included and their replays not.

13. (After phase 12, before phase 11.) ``pipeline.fused_steps``: at
   phases 7-8's training state with 8 views (the loop's event-mode view
   pick needs 6), ``train_loop`` for 60 event iterations, log every 10,
   with ``fused_steps`` 1 (eager) and 10 (a CUDA graph of the step,
   replayed once per step): losses within rtol 2e-5 / atol 1e-6 and
   final parameters within 3e-3 of the eager loop's; each kernel
   launched 3 times per eager step, and in the fused loop only in the
   warm-up steps and the capture (9 launches), with 60 graph replays.
   Printed beside the card's name and power limit: the capture time, host
   ms per step and ``bench.py``'s pixels/s of both loops over iterations
   11-60, the device ms per replayed step (CUDA events around 10 replays,
   5 windows), the peak memory of both loops and what the fused steps
   reserve.  One step's CUDA graph read back (``graph_kernels``) holds the
   Adam kernel, each loss kernel and each preprocess kernel once; the Adam
   kernel captured in a CUDA graph at the trained state equals its plain
   version bit for bit,
   and so do the loss kernels as phase 7 holds them, replayed from a
   graph.  Then a graph
   swap: 12 iterations densifying at 5 and 10 with capacity growth (the instance cap re-measured upward), captured again
   after each, against the eager loop; and ``cli.train --fused_steps 3``
   on phase 6's scene as phase 6 runs it, ending with phase 6's alive
   count and launching the kernels in its captures only.

14. (After phase 13, before phase 11.) Scale, through
   ``event3dgs_tpu_torch/tools/scale.py`` in process: ``maxcap`` at
   2,097,152 slots (the JAX package's largest working point), the event
   step eager (1 + 3 steps) and graphed (``fused_steps`` 10: warm-up,
   capture, 1 + 3 replays), each on the scene built anew; every kernel
   launched 3 × 4 + 3 × 3 times (Adam, the loss and the preprocess kernels
   4 + 3) with the counts set to 0
   before, ``ops/render.composed`` called in neither, the same loss from
   both, state GiB, instance cap, ms per step,
   device ms per replay, capture ms, peak and reserved memory.  At that
   state's main view (camera 1) each kernel of the path against its plain
   version at phases 4 and 7's tolerances (the preprocess forward and
   backward over the step's three views, the table kernel, the radix sort,
   the depth offsets kernel, K4, K5, K6, the
   counting sort and the ``Binning`` exactly, K1 within 1e-5 with its
   stop index equal, K2 within 1e-5 of the max, K3 bit-equal, the Adam
   kernel bit-equal, also in a CUDA graph, the event and SSIM loss
   kernels as in phase 7, in a CUDA graph) and its graph ms beside its
   bound (the SSIM kernels' in rgb and gray mode; the whole depth order
   against its bound, the argsort's bound and ``torch.argsort``, with its
   scratch
   bytes), K3 in its orders as in phase 8.  The depth order (the radix
   sort and the offsets kernel) over 16.8M ranks (8,192 + 1 look-back
   blocks of the offsets kernel; twice, its state left cleared) and the
   counting sort, K5 and K6 over 2^25 + 5 slots, on synthetic inputs,
   bit-equal to their plain versions.  ``train --densify --fused_steps
   10`` at 1,048,576 slots (12 1080p views of a 100k-point world), cut
   from 300 to 160 iterations so that the script's cadence densifies at
   100 and 150: finite, decreasing losses (the script's checks), no
   instance overflow at the loop's last cap, the kernels launched in the
   warm-ups and captures only (the SSIM loss kernels once a step there,
   the event loss kernels never), and its first 20 losses equal to the
   eager loop's bit for bit, its it/s printed beside the card's name and
   power limit; then phase 8's densify with capacity growth on its
   trained state (threshold 0: ~0.9M alive slots all candidates) and one
   rgb step at the re-measured instance cap.  At the 2M state, as in
   phase 8: the graphed step's device nodes and ``indexSelect`` nodes,
   its device ms per replay and no ``pack_features`` or
   ``ops/render.composed`` call, and the forward preprocess with and without
   the packed rows.  Each kernel's JSON row gets the 2M columns under
   ``scale``.

For K1 and K2 the script prints their time beside the earlier design's
(before the warp cull, from PERF.md), their bound over the composited
(pixel, instance) pairs (the work the function needs) and the earlier
bound over the visited pairs, the pairs they evaluate after the warp cull
(counted by the plain versions' mirror of it), and their registers and
resident blocks per SM; the preprocess kernels' rows carry their
registers and resident blocks per SM too (``registers``,
``blocks_per_sm``), and their bound counts the step's three views.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line of per-kernel numbers (phase 12 adds one row per probe build,
marked ``timing_only`` where it is an ablation, and one for the
dynamic-grid kernel), and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
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
PHOTO_ITERS = 2  # phase 6's rgb and gray cli.train runs
BLUR_STEPS = 18  # renders per blurry frame (render_blurry_set's default)
EVENT_STEPS = 3  # cli.render --event's --interpolationN (its default)
EVENT_DT = 1000.0  # µs between the chain's frames (--dt's default)
EVENT_SPREAD = 20.0  # phase 10's camera spacing along x, times phase 6's
DEVICE = "cuda"
# library code (cuDNN's convolutions) runs FMAs: the data sheet's 67
# TFLOP/s of FP32 outside the tensor cores, an FMA counted as two FLOPs
# (the kernels' own rates and the bound arithmetic are in
# event3dgs_tpu_torch/tools/kernel_timing.py)
PEAK_FP32_FLOPS = 67e12
# (FP32, SFU) operations per visited (pixel, instance) pair of K2's design
# before the warp cull (the earlier bound charged every visited pair; K1's
# table is kernel_timing.K1_PAIR_OPS)
EARLIER_K2_PAIR_OPS = ((10, 0), (12, 1), (53, 4))
# the card times of the design before the warp cull (PERF.md's kernel
# table, NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
EARLIER_MS = {"K1 composite_forward": "0.596-0.603",
              "K2 composite_backward": "1.242-1.253"}
CUDA_BASELINE_PIX_S = 30e6  # bench.py's yardstick for vs_baseline
# the JAX code the preprocess kernels replace: the projection, the SH
# colours and the train step's SH mask, which XLA fuses (no Pallas kernel)
PREPROCESS_REPLACES = ", ".join(("event3dgs_tpu/ops/projection.py:51",
                                 "event3dgs_tpu/ops/render.py:49",
                                 "event3dgs_tpu/train/step.py:135"))
# the JAX code the Adam kernel replaces: adam_update, which XLA fuses inside
# the jitted train step (no Pallas kernel)
ADAM_REPLACES = "event3dgs_tpu/models/optimizer.py:39"
# the JAX code the loss kernels replace: event_mixture_loss and deblur_mix,
# with the renders' composition and the GT frame picks before them, which
# XLA fuses inside the jitted train step (no Pallas kernel)
LOSS_REPLACES = ", ".join(("event3dgs_tpu/losses/event.py:68",
                           "event3dgs_tpu/losses/modes.py:59",
                           "event3dgs_tpu/ops/render.py:122",
                           "event3dgs_tpu/train/step.py:115",
                           "event3dgs_tpu/train/step.py:151",
                           "event3dgs_tpu/train/step.py:152",
                           "event3dgs_tpu/train/step.py:164"))
# the JAX code the SSIM loss kernels replace: rgb_total_loss and
# gray_total_loss on _depthwise_blur's convolutions, with the render's
# composition and the GT pick before them, which XLA fuses inside the jitted
# train step (no Pallas kernel)
PHOTO_REPLACES = ", ".join(("event3dgs_tpu/losses/modes.py:16",
                            "event3dgs_tpu/losses/modes.py:25",
                            "event3dgs_tpu/losses/basic.py:71",
                            "event3dgs_tpu/losses/basic.py:98",
                            "event3dgs_tpu/ops/render.py:122",
                            "event3dgs_tpu/train/step.py:115"))
# bench.py times 5 steps; a 50-step window separates a noisy host from
# stalls, and its median and spread are printed beside bench.py's mean
STEP_ITERS = 50
WARMUP_STEPS = 3
STEP_TURN = 10  # phase 11: steps timed in each of its four turns
# phase 13: pipeline.fused_steps against the per-step loop; the loop's
# event-mode view pick needs at least 6 views, so bench.py's state with 8
FUSED_VIEWS = 8
FUSED_ITERS = 60
FUSED_STEPS = 10
FUSED_LOG = 10  # log_every: the host clock is read at these ticks
# phase 14: the JAX package's largest working point (RESULTS_r5.json), the
# sizes of the 80 GB card's ceiling for the look-back and the counting sort,
# and scale.train cut from 300 to 160 iterations: the script's cadence
# (every 50 after 50, below the last) densifies at 100 and 150
SCALE_CAPACITY = 2_097_152
SCALE_FUSED = 10
CEILING_BLOCKS = 8192  # look-back blocks of 2,048 ranks (16.8M Gaussians)
CEILING_SLOTS = 1 << 25  # instance slots of the counting sort
SCALE_TRAIN_ITERS = 160
SCALE_TRAIN_CAPACITY = 1 << 20  # scale.train's slots and world
SCALE_TRUE_POINTS = 100_000
SCALE_TRAIN_EAGER = 20  # its first iterations, held against the eager loop


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def bench_scene(rng):
    """bench.py's scene (`_scene`): means, scales, rotations, opacities,
    colors."""
    from event3dgs_tpu_torch.tools import kernel_timing

    return kernel_timing.bench_scene(rng, N_GAUSSIANS)


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
    patterns that move from view to view, ``renders/`` (the held-out ground
    truth of the evaluation) the same patterns shifted, and a point cloud
    drawn like bench.py's scene."""
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
    for folder in ("images", "images_event", "renders"):
        os.makedirs(os.path.join(src, folder))

    def pattern(i, shift):
        img = np.stack([0.5 + 0.4 * np.sin(x / (60.0 + 7 * c) + 0.3 * i + shift)
                        * np.cos(y / (45.0 + 5 * c) - 0.2 * i) for c in range(3)],
                       axis=-1)
        return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))

    for i in range(TRAIN_VIEWS):
        png = pattern(i, 0.0)
        for folder in ("images", "images_event"):
            png.save(os.path.join(src, folder, f"r_{i:05d}.png"))
        pattern(i, 0.5).save(os.path.join(src, "renders", f"r_{i:05d}.png"))
    return src


def evaluated(pairs) -> int:
    """The visited pairs the kernels evaluate: less those the warp cull
    removes."""
    return sum(pairs[:3]) - pairs[3]


def pairs_text(pairs) -> str:
    visited = sum(pairs[:3])
    return (f"{visited} (pixel, instance) pairs visited: {pairs[0]} skipped "
            f"at power > 0, {pairs[1]} at raw < 1/255, {pairs[2]} composited; "
            f"{evaluated(pairs)} evaluated after the warp cull "
            f"({100 * evaluated(pairs) / max(visited, 1):.1f} %)")


def composite_report(name, row, pairs, nbytes, lib, fn):
    """K1's or K2's time against the earlier design's, its bound over the
    composited pairs and the earlier bound over the visited pairs, the
    pairs it evaluates, its registers and resident blocks per SM."""
    from event3dgs_tpu_torch.ops import kernels
    from event3dgs_tpu_torch.tools.kernel_timing import (
        COMPOSITED,
        K1_PAIR_OPS,
        bound_ms,
        pair_ops,
    )

    visited = K1_PAIR_OPS if name.startswith("K1") else EARLIER_K2_PAIR_OPS
    old, _ = bound_ms(nbytes, pair_ops(pairs, visited,
                                       kinds=(0, 1, COMPOSITED)))
    regs, blocks = kernels.occupancy(lib, fn)
    print(f"{name}: kernel {row['ms']:.4f} ms (before the warp cull "
          f"{EARLIER_MS[name]} ms, PERF.md); bound {row['bound_ms']:.4f} ms "
          f"over the {pairs[2]} composited pairs "
          f"({row['ms'] / row['bound_ms']:.2f}x), the "
          f"earlier visited-pairs bound {old:.4f} ms ({row['ms'] / old:.2f}x); "
          f"{evaluated(pairs)} pairs evaluated after the warp cull of "
          f"{sum(pairs[:3])} visited; {regs} registers, {blocks} blocks per SM")


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


# each kernel's own CUDA functions (csrc/), whose device time is its
# device_ms; K5 and K6 share the count and scan of csrc/sort_tiles.cu; the
# table kernel (csrc/expand.cu), the radix sort and the depth offsets
# kernel (csrc/depth_sort.cu) build K4's inputs
KERNEL_FUNCTIONS = {
    "preprocess_forward": ("preprocess_forward_kernel",),
    "preprocess_backward": ("preprocess_backward_kernel",),
    "K1 composite_forward": ("composite_forward_kernel",),
    "K2 composite_backward": ("composite_backward_kernel",),
    "K3 segment_sums": ("segment_sums_kernel",),
    "K4 gaussian_tables": ("gaussian_table_kernel",),
    "K4 depth_sort": ("radix_histogram_kernel", "radix_pass_kernel"),
    "K4 depth_offsets": ("depth_offsets_kernel",),
    "K4 expand_instances": ("expand_kernel",),
    "K5 tile_histogram": ("segment_count_kernel", "scan_kernel"),
    "K6 stable_tile_rank": ("segment_count_kernel", "scan_kernel", "rank_kernel"),
    "adam_update": ("adam_update_kernel",),
    "event_loss_forward": ("event_loss_forward_kernel",),
    "event_loss_backward": ("event_loss_backward_kernel",),
    "photometric_loss_forward": ("photometric_loss_forward_kernel",),
    "photometric_loss_backward": ("photometric_loss_backward_kernel",),
}
SORT_FUNCTIONS = KERNEL_FUNCTIONS["K6 stable_tile_rank"]
# launches per call of a function of KERNEL_FUNCTIONS where not 1: the
# radix sort's pass kernel runs once per digit (a pass that is a no-op
# returns at once)
LAUNCHES_PER_CALL = {"radix_pass_kernel": 4}
# the device kernels of one binning from the projection's outputs: the
# table kernel, the radix sort (5), the depth offsets kernel, K4 and the
# counting sort's scan and rank kernels (K4 counts the tiles for it)
BINNING_KERNELS = 10


def expansion_check(what, args, kw, cap):
    """The table kernel, the depth order (the radix sort and the depth
    offsets kernel) and K4 (tile, gauss and the live segments' count rows)
    bit-equal to their plain versions on the projection's outputs
    ``args``, ``kw`` (the depth order also to ``radix_order_plain``); the
    counting sort from K4's rows equal to its plain version; the binning
    from the projection's outputs to the ``Binning`` in at most
    BINNING_KERNELS device kernels, none of them a library sort.  Returns
    (the tables, the depth order, K4's output, the errors)."""
    import torch

    from event3dgs_tpu_torch.ops import binning, expand, sort_tiles
    from event3dgs_tpu_torch.tools.kernel_timing import (
        device_profile,
        graph_kernels,
    )

    tiles_x, tiles_y = binning.tile_grid(args[4], args[5])
    nt, n = tiles_x * tiles_y, args[0].shape[0]
    tk = binning.gaussian_tables_kernel(*args, **kw)
    tp = binning.gaussian_tables_plain(*args, **kw)
    bits = lambda t: t.view(torch.int32)
    live = tp.rect[:, 3] > 0
    check(torch.equal(tk.rect, tp.rect) and torch.equal(bits(tk.key), bits(tp.key))
          and torch.equal(bits(tk.cull[live]), bits(tp.cull[live]))
          and torch.equal(tk.counts, tp.rect[:, 3]),
          f"{what}: the table kernel differs from its plain version")
    errs = {"K4 gaussian_tables": max(
        (tk.rect - tp.rect).abs().max().item(),
        (tk.cull[live] - tp.cull[live]).abs().max().item())}
    rk = binning.depth_order_kernel(tk, cap)
    rp = binning.depth_order_plain(tk, cap)
    rr = binning.radix_order_plain(tk, cap)
    segments = -(-min(int(rk.offsets[-1]), cap) // sort_tiles.SEGMENT)
    errs["K4 depth_sort"] = max((rk.order - p.order).abs().max().item()
                                for p in (rp, rr))
    errs["K4 depth_offsets"] = max(max(
        (rk.offsets - p.offsets).abs().max().item(),
        (rk.seg_rank[:segments] - p.seg_rank[:segments]).abs().max().item())
        for p in (rp, rr))
    for k in ("K4 depth_sort", "K4 depth_offsets"):
        check(errs[k] == 0, f"{what}: {k} differs from its plain versions "
              f"by {errs[k]}")
    k4 = (tk.rect, tk.cull, *rk, cap, tiles_x, nt, True)
    ek, ep = expand.expand_instances_kernel(*k4), expand.expand_instances_plain(*k4)
    errs["K4 expand_instances"] = max(
        (ek.tile - ep.tile).abs().max().item(),
        (ek.gauss - ep.gauss).abs().max().item(),
        (ek.rows[:segments] - ep.rows[:segments]).abs().max().item())
    check(errs["K4 expand_instances"] == 0, f"{what}: K4 differs from its "
          f"plain version by {errs['K4 expand_instances']}")
    n_live = rk.offsets[-1:]
    counted = sort_tiles.counting_sort_kernel(ek.tile, ek.gauss, n_live, nt, n,
                                              base=ek.rows.clone())
    plain = sort_tiles.counting_sort_plain(ek.tile, ek.gauss, n_live, nt, n)
    for field, k, p in zip(counted._fields, counted, plain):
        check(torch.equal(k, p), f"{what}: the counting sort from K4's rows: "
              f"{field} differs from its plain version")
    call = lambda: binning.bin_gaussians(*args, cap, **kw)
    nodes = graph_kernels(call)
    n_other = sum(nodes.pop(k, 0) for k in ("memset", "memcpy", "other"))
    n_kernels = sum(nodes.values())
    check(n_kernels <= BINNING_KERNELS, f"{what}: {n_kernels} device kernels "
          f"from the projection's outputs to the Binning ({nodes})")
    check(not any("sort" in k.lower() and "radix_" not in k for k in nodes),
          f"{what}: a library sort in the binning ({nodes})")
    prof = device_profile(call)
    device_us = sum(v[0] for v in prof.values()) * 1e3
    print(f"{what}: table kernel, radix sort, depth offsets kernel and K4 "
          f"(tile, gauss and "
          f"{segments} count rows) bit-equal to their plain versions; the "
          f"counting sort from K4's rows equal to its plain version; the "
          f"binning from the projection's outputs: {n_kernels} device "
          f"kernels and {n_other} memsets, copies or other nodes in its CUDA "
          f"graph; profiler: {device_us:.2f} us of device time per binning ("
          + ", ".join(f"{k} x{c:.0f} {ms * 1e3:.2f}" for k, (ms, c) in
                      sorted(prof.items(), key=lambda kv: -kv[1][0])) + ")")
    return tk, rk, ek, errs


def counting_sort_check(what, tile, gauss, n_live, nt, n):
    """K5, K6 and the fused counting sort against their plain versions on
    K4's output (bit-equal); the fused sort's event time, its device time
    per CUDA function and the device kernels it runs (all of them from
    K4's output to the ``Binning``), beside its bound.  Returns the K5 and
    K6 errors."""
    import torch

    from event3dgs_tpu_torch.ops import sort_tiles
    from event3dgs_tpu_torch.tools.kernel_timing import (
        bound_ms,
        cuda_ms,
        device_profile,
        graph_kernels,
    )

    ck = sort_tiles.tile_histogram_kernel(tile, nt, n_live)
    cp = sort_tiles.tile_histogram_plain(tile, nt, n_live)
    starts = (torch.cumsum(ck, 0) - ck).to(torch.int32)
    cap = tile.shape[0]
    dk = sort_tiles.stable_tile_rank_kernel(tile, n_live, nt, starts, cap)
    dp = sort_tiles.stable_tile_rank_plain(tile, n_live, nt, starts, cap)
    errs = {"K5 tile_histogram": (ck - cp).abs().max().item(),
            "K6 stable_tile_rank": (dk - dp).abs().max().item()}
    for k, e in errs.items():
        check(e == 0, f"{what}: {k} differs from its plain version by {e}")
    call = lambda: sort_tiles.counting_sort_kernel(tile, gauss, n_live, nt, n)
    fused = call()
    plain = sort_tiles.counting_sort_plain(tile, gauss, n_live, nt, n)
    for field, k, p in zip(fused._fields, fused, plain):
        check(torch.equal(k, p), f"{what}: the counting sort's {field} "
              f"differs from its plain version")
    ms = cuda_ms(call, 50)
    nodes = graph_kernels(call)
    check(set(nodes) == set(SORT_FUNCTIONS),
          f"{what}: the counting sort ran {nodes}")
    ops = sum(nodes.values())
    check(ops <= 4, f"{what}: {ops} device kernels from K4's output to the "
          f"Binning")
    prof = device_profile(call, expect=SORT_FUNCTIONS)
    live = int(fused.counts.sum())
    # live ids and their Gaussians read, dest and the lists written once,
    # counts and offsets written
    nbytes = min(int(n_live), cap) * 4 + live * 4 + cap * 8 + nt * 8
    bound, _ = bound_ms(nbytes, (0, 0))
    device = sum(v[0] for v in prof.values())
    print(f"{what}: counting sort (K5 + K6 fused, the tile lists) equal to its "
          f"plain version; {ms:.4f} ms per call (CUDA events), device "
          f"{device * 1e3:.2f} us per call by the profiler ("
          + ", ".join(f"{f} {prof[f][0] * 1e3:.2f}" if f in prof else
                      f"{f} not seen" for f in SORT_FUNCTIONS)
          + f"), {ops} device kernels from K4's output to the Binning (its "
          f"CUDA graph); bound {bound * 1e3:.2f} us (bytes)")
    return errs


def check_binning(what, bk, bp):
    """The kernel path's Binning equal to the all-plain one."""
    import torch

    for field in ("inst_gauss", "tile_offsets", "tile_counts", "dest",
                  "overflow", "offsets", "order"):
        check(torch.equal(getattr(bk, field), getattr(bp, field)),
              f"{what}: the binning's {field} differs from the plain path's")


def bits_differ(a, b) -> int:
    """How far two tensors of one shape differ: 0 where they are equal bit
    for bit, else the most units in the last place between two float32
    values (2**31 where a sign or a NaN differs), 1 for other types."""
    import torch

    if a.dtype != torch.float32:
        return int(not torch.equal(a, b))
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    if torch.equal(ia, ib):
        return 0
    same = (torch.sign(a) == torch.sign(b)) & ~torch.isnan(a) & ~torch.isnan(b)
    if not bool(same[ia != ib].all()):
        return 2 ** 31
    return int((ia - ib).abs().max())


def preprocess_check(what, act, dc, rest, cams, cmask=None, backward=False,
                     tap=False):
    """The forward preprocess kernel against its plain version over the
    views ``cams`` (one launch for all), on the activated Gaussians ``act``
    and the feature leaves ``dc``, ``rest`` (SH degree 3) with the mask
    ``cmask``, asked for the packed rows as the render and the train step
    ask (with ``tap``, the step's zero [N, 2] mean2d tap on the first
    view): each view's mean2d, depth, conic, radius, valid, colours and
    packed rows bit-equal, and the rows bit-equal to ``pack_features`` of
    the kernel's own outputs.  With ``backward``, the backward kernel on
    seeded upstream
    gradients, strided as the rasterizer hands them over (slices of an [N,
    9] tensor per view): the gradients of the means, scales and rotations
    within 2e-4 of their max, the two leaves' bit for bit, and all
    bit-identical when run twice.  Prints each kernel's registers and
    resident blocks per SM.  Returns a namespace: ``proj`` and ``colors``
    (the kernel's, of the first view), ``errs``, ``calls`` {kernel: (its
    call, its plain version's)}, ``unpacked`` (the forward's call without
    the packed rows), ``bounds`` {kernel: (bytes, operations)} over the
    views, ``occupancy`` {kernel: (registers, blocks per SM)}."""
    import types

    import torch

    from event3dgs_tpu_torch.ops import kernels
    from event3dgs_tpu_torch.ops import preprocess as pre
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.tools.kernel_timing import (
        preprocess_bytes,
        preprocess_ops,
    )

    n, k, views = act.means3d.shape[0], 1 + rest.shape[1], len(cams)
    args = (act.means3d, act.scales, act.rotations, cams, 1.0, act.opacities,
            dc, rest, cmask, 3)
    kw = dict(mean2d_tap=torch.zeros(n, 2, device=act.means3d.device)
              if tap else None, packed=True)
    with torch.no_grad():
        got = pre.preprocess_forward_kernel(*args, **kw)
        want = pre.preprocess_forward_plain(*args, **kw)
    ulps = {f"{f}[{v}]": bits_differ(a, b)
            for v, ((pk, ck, fk), (pp, cp, fp)) in enumerate(zip(got, want))
            for f, a, b in zip((*pk._fields, "colors", "packed rows"),
                               (*pk, ck, fk), (*pp, cp, fp))}
    ulps.update({f"pack_features[{v}]": bits_differ(fk, rt.pack_features(
        pk.mean2d, pk.conic, ck, act.opacities))
        for v, (pk, ck, fk) in enumerate(got)})
    check(not any(ulps.values()), f"{what}: the forward preprocess kernel "
          f"differs from its plain version (ulps by output: {ulps})")
    del want
    n_valid = [int(pk.valid.sum()) for pk, _, _ in got]
    errs = {"preprocess_forward": 0.0}
    calls = {"preprocess_forward": (
        lambda: pre.preprocess_forward_kernel(*args, **kw),
        lambda: pre.preprocess_forward_plain(*args, **kw))}
    bounds = {"preprocess_forward": (
        preprocess_bytes(n, k, 3, views=views, tap=tap),
        preprocess_ops(n, 3, views=views))}
    occupancy = {"preprocess_forward": kernels.occupancy(
        "preprocess", "e3d_preprocess_occupancy", 0, 3, k)}
    text = (f"forward preprocess over {views} view{'s' * (views > 1)} "
            f"{'with the tap ' * tap}bit-equal to its plain version, its "
            f"packed rows to pack_features too ({n_valid} of {n} valid)")
    if backward:
        g = torch.Generator().manual_seed(11)
        rows = [(torch.rand(n, 9, generator=g) - 0.5).to(act.means3d.device)
                for _ in cams]
        bargs = (act.means3d, act.scales, act.rotations, cams,
                 [pk.valid for pk, _, _ in got], [r[:, 0:2] for r in rows],
                 [r[:, 2:5] for r in rows], [r[:, 6:9] for r in rows], 1.0,
                 dc, rest, cmask, 3)
        gk = pre.preprocess_backward_kernel(*bargs)
        gp = pre.preprocess_backward_plain(*bargs)
        worst, err = 0.0, 0.0
        for name, a, b in zip(("means", "scales", "rotations", "features_dc",
                               "features_rest"), gk, gp):
            top = b.abs().max().item()
            e = (a - b).abs().max().item()
            if name.startswith("features"):
                check(bits_differ(a, b.contiguous()) == 0, f"{what}: the "
                      f"backward preprocess kernel's {name} gradient differs "
                      f"from its plain version by {e:.3g} (max {top:.3g})")
            check(bool(torch.isfinite(a).all()) and e <= 2e-4 * top,
                  f"{what}: the backward preprocess kernel's {name} gradient "
                  f"differs from its plain version by {e:.3g} (max {top:.3g})")
            worst, err = max(worst, e / max(top, 1e-30)), max(err, e)
        del gp
        again = pre.preprocess_backward_kernel(*bargs)
        check(all(torch.equal(a, b) for a, b in zip(gk, again)),
              f"{what}: the backward preprocess kernel run twice differs")
        errs["preprocess_backward"] = err
        calls["preprocess_backward"] = (
            lambda: pre.preprocess_backward_kernel(*bargs),
            lambda: pre.preprocess_backward_plain(*bargs))
        bounds["preprocess_backward"] = (
            preprocess_bytes(n, k, 3, backward=True, views=views),
            preprocess_ops(n, 3, backward=True, views=views))
        occupancy["preprocess_backward"] = kernels.occupancy(
            "preprocess", "e3d_preprocess_occupancy", 1, 3, k)
        text += (f"; backward within {worst:.3g} of each gradient's max, the "
                 "feature gradients bit-equal, bit-identical run twice")
    text += "; " + ", ".join(f"{name} {r} registers, {b} blocks per SM"
                             for name, (r, b) in occupancy.items())
    print(f"{what}: {text}")
    return types.SimpleNamespace(
        proj=got[0][0], colors=got[0][1], errs=errs, calls=calls,
        unpacked=lambda: pre.preprocess_forward_kernel(
            *args, mean2d_tap=kw["mean2d_tap"]),
        bounds=bounds, occupancy=occupancy)


def step_preprocess_check(what, state, data, idx):
    """``preprocess_check`` (backward too) as the event step calls the
    kernels: its three views (main ``idx[0]``, event pair ``idx[1]`` →
    ``idx[2]``), the state's feature leaves, the mask as a device tensor
    with all 16 coefficients on (the degree the step reaches after 3,000
    iterations), the zero tap, the packed rows."""
    import torch

    from event3dgs_tpu_torch.models import activated

    params = state.params
    cams = [data.cameras[idx[0]], data.event_cameras[idx[1]],
            data.event_cameras[idx[2]]]
    cmask = torch.ones(params.sh_coeffs, device=params.device)
    return preprocess_check(what, activated(params, features=False),
                            params.features_dc, params.features_rest, cams,
                            cmask, backward=True, tap=True)


def occupancy_rows(rows, occupancy):
    """Add each preprocess kernel's registers and resident blocks per SM
    to its JSON row."""
    for name, (regs, blocks) in occupancy.items():
        if name in rows:
            rows[name]["registers"] = regs
            rows[name]["blocks_per_sm"] = blocks


def view_kernels(what, proj, colors, opac, cap, dev, backward=False):
    """Every kernel of one 1080p view's path against its plain version at
    the instance cap ``cap`` (phases 4, 7 and 14): the table kernel, the
    depth offsets kernel, K4, K5 and K6 bit-equal, the Binning equal to
    the all-plain one without overflow, K1 (rgb within 1e-5, T within
    1e-6, the stop index equal) and, with ``backward``, K2 on seeded
    upstream gradients (rows within 1e-5 of their max, bit-identical when
    run twice) and K3 (bit-equal).  Returns a namespace: ``errs``,
    ``calls`` {kernel: (its call, its plain version's)}, ``bounds``
    {kernel: (bytes, operations)} (``kernel_timing.path_bounds``), and the
    inputs the phases time: ``bk`` (the Binning), ``tk``, ``n_live``,
    ``nt``, ``live``, ``pairs``, ``k2_args`` and ``rows_k``."""
    import types

    import torch

    from event3dgs_tpu_torch.ops import binning, expand, sort_tiles
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.tools.kernel_timing import path_bounds

    n = proj.mean2d.shape[0]
    tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT)
    nt = tiles_x * tiles_y
    bin_args = (proj.mean2d, proj.depth, proj.radius, proj.valid, WIDTH,
                HEIGHT)
    bin_kw = dict(opacities=opac, conic=proj.conic)
    tables, ranks, inst, errs = expansion_check(what, bin_args, bin_kw, cap)
    # the sort and the offsets kernel alone, held to the call (the
    # segments' first ranks are written for the live segments only)
    order, depth_counts = binning.depth_sort_kernel(tables)
    offsets, seg_rank = binning.depth_offsets_kernel(tables, depth_counts,
                                                     cap)
    segs = -(-min(int(ranks.offsets[-1]), cap) // sort_tiles.SEGMENT)
    check(torch.equal(order, ranks.order)
          and torch.equal(depth_counts, tables.rect[:, 3][order.long()])
          and torch.equal(offsets, ranks.offsets)
          and torch.equal(seg_rank[:segs], ranks.seg_rank[:segs]),
          f"{what}: the radix sort or the depth offsets kernel alone differs "
          "from the depth order's call")
    tk, gk, n_live = inst.tile, inst.gauss, ranks.offsets[-1:]
    errs.update(counting_sort_check(what, tk, gk, n_live, nt, n))
    counts = sort_tiles.tile_histogram_plain(tk, nt, n_live)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)  # K6's input
    bk = binning.bin_gaussians(*bin_args, cap, **bin_kw)
    check_binning(what, bk, binning.bin_gaussians(*bin_args, cap, plain=True,
                                                  **bin_kw))
    check(int(bk.overflow) == 0, f"{what}: the instance cap {cap} overflowed")
    live, n_inst = int(bk.tile_counts.sum()), int(n_live)

    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    k1_args = (bk.inst_gauss, bk.tile_offsets, bk.tile_counts, feat, tiles_x,
               WIDTH, HEIGHT)
    rk, lk, sk = rt.composite_forward_kernel(*k1_args)
    rp, lp, sp, pairs = rt._composite_plain(*k1_args)
    pairs = pairs.tolist()
    errs["K1 composite_forward"] = (rk - rp).abs().max().item()
    t_err = (torch.exp(lk) - torch.exp(lp)).abs().max().item()
    check(errs["K1 composite_forward"] <= 1e-5 and t_err <= 1e-6
          and torch.equal(sk, sp), f"{what}: K1 differs from its plain "
          f"version (rgb {errs['K1 composite_forward']:.3g}, T {t_err:.3g})")
    del rp, lp, sp
    k4_args = (tables.rect, tables.cull, *ranks, cap, tiles_x, nt, True)
    calls = {
        "K4 gaussian_tables": (
            lambda: binning.gaussian_tables_kernel(*bin_args, **bin_kw),
            lambda: binning.gaussian_tables_plain(*bin_args, **bin_kw)),
        "K4 depth_sort": (lambda: binning.depth_sort_kernel(tables),
                          lambda: binning.radix_order_plain(tables, cap)),
        "K4 depth_offsets": (
            lambda: binning.depth_offsets_kernel(tables, depth_counts, cap),
            lambda: binning.offsets_plain(depth_counts, cap)),
        "K4 expand_instances": (
            lambda: expand.expand_instances_kernel(*k4_args),
            lambda: expand.expand_instances_plain(*k4_args)),
        "K5 tile_histogram": (
            lambda: sort_tiles.tile_histogram_kernel(tk, nt, n_live),
            lambda: sort_tiles.tile_histogram_plain(tk, nt, n_live)),
        "K6 stable_tile_rank": (
            lambda: sort_tiles.stable_tile_rank_kernel(tk, n_live, nt, starts,
                                                       cap),
            lambda: sort_tiles.stable_tile_rank_plain(tk, n_live, nt, starts,
                                                      cap)),
        "K1 composite_forward": (
            lambda: rt.composite_forward_kernel(*k1_args),
            lambda: rt.composite_forward_plain(*k1_args)),
    }
    text = (f"K1 rgb {errs['K1 composite_forward']:.3g}, T {t_err:.3g}, "
            "stop index equal")
    k2_args = rows_k = None
    if backward:
        g = torch.Generator().manual_seed(7)
        g_rgb = (torch.rand(HEIGHT, WIDTH, 3, generator=g) - 0.5).to(dev)
        g_logt = (torch.rand(HEIGHT, WIDTH, generator=g) - 0.5).to(dev)
        k2_args = k1_args + (g_rgb, g_logt, lk, sk, cap)
        rows_k = rt.composite_backward_kernel(*k2_args)
        rows_p = rt.composite_backward_plain(*k2_args)
        top = rows_p[:live].abs().max().item()
        errs["K2 composite_backward"] = (
            rows_k[:live] - rows_p[:live]).abs().max().item()
        del rows_p
        check(errs["K2 composite_backward"] <= 1e-5 * top,
              f"{what}: K2 rows differ by {errs['K2 composite_backward']:.3g} "
              f"(max {top:.3g})")
        check(torch.equal(rows_k[:live],
                          rt.composite_backward_kernel(*k2_args)[:live]),
              f"{what}: K2 run twice: rows differ")
        errs["K3 segment_sums"] = (
            rt.gaussian_grads(bk, rows_k)
            - rt.gaussian_grads(bk, rows_k, plain=True)).abs().max().item()
        check(errs["K3 segment_sums"] == 0, f"{what}: K3 differs from its "
              "plain version")
        calls["K2 composite_backward"] = (
            lambda: rt.composite_backward_kernel(*k2_args),
            lambda: rt.composite_backward_plain(*k2_args))
        calls["K3 segment_sums"] = (
            lambda: rt.gaussian_grads(bk, rows_k),
            lambda: rt.gaussian_grads(bk, rows_k, plain=True))
        text += (f"; K2 rows {errs['K2 composite_backward']:.3g} of max "
                 f"{top:.3g}, bit-identical run twice; K3 bit-equal")
    print(f"{what}: {n_inst} rect instances, {live} after the ellipse cull, "
          f"cap {cap}, max per tile {int(bk.tile_counts.max())}; the Binning "
          f"equal to the plain path's; {text}; {pairs_text(pairs)}")
    return types.SimpleNamespace(
        errs=errs, calls=calls,
        bounds=path_bounds(n, cap, ranks.offsets, live, pairs, nt, WIDTH,
                           HEIGHT),
        bk=bk, tk=tk, n_live=n_live, nt=nt, live=live, pairs=pairs,
        k2_args=k2_args, rows_k=rows_k, tables=tables,
        depth_counts=depth_counts)


def depth_libraries(v):
    """The PyTorch yardsticks of the depth order's kernels on the inputs
    of ``view_kernels``' namespace ``v``: the stable ``torch.argsort`` of
    the keys (the call the port made before its own sort) and
    ``torch.cumsum`` of the counts in depth order."""
    import torch

    return {
        "K4 depth_sort": lambda: torch.argsort(v.tables.key, stable=True),
        "K4 depth_offsets": lambda: torch.cumsum(v.depth_counts, 0),
    }


def depth_order_timing(what, v, cap):
    """The whole depth order's graph ms at a view (``view_kernels``'
    namespace ``v``) against its bound, the yardstick of an order from an
    ``argsort`` (``path_bounds``' "K4 depth_order, argsort's") and the
    stable ``torch.argsort`` of the same keys; its scratch bytes per
    Gaussian beside ``argsort``'s.  Returns the columns."""
    from event3dgs_tpu_torch.ops import binning
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools.kernel_timing import bound_ms, graph_ms

    n = v.tables.key.shape[0]
    call = lambda: binning.depth_order_kernel(v.tables, cap)
    argsort = depth_libraries(v)["K4 depth_sort"]
    row = {"graph_ms": graph_ms(call), "argsort_graph_ms": graph_ms(argsort),
           "bound_ms": bound_ms(*v.bounds["K4 depth_order"])[0],
           "bound_argsort_ms": bound_ms(
               *v.bounds["K4 depth_order, argsort's"])[0],
           "scratch_bytes_per_gaussian": kp.peak_bytes(call) / n,
           "argsort_bytes_per_gaussian": kp.peak_bytes(argsort) / n}
    print(f"{what}: the depth order (radix sort + offsets) "
          f"{row['graph_ms']:.4f} graph ms, bound {row['bound_ms']:.4f} ms "
          f"(bytes), {row['graph_ms'] / row['bound_ms']:.2f}x (the argsort's "
          f"bound {row['bound_argsort_ms']:.4f}: "
          f"{row['graph_ms'] / row['bound_argsort_ms']:.2f}x); torch.argsort of "
          f"the keys alone {row['argsort_graph_ms']:.4f} graph ms; scratch "
          f"{row['scratch_bytes_per_gaussian']:.1f} B a Gaussian, outputs "
          f"included (argsort {row['argsort_bytes_per_gaussian']:.1f})")
    return row


def k3_in_order(what, bk, rows_k):
    """K3 over the rows put into expansion order beforehand and read
    through an identity ``dest`` (zero rows where an instance was
    dropped), and K3 through ``dest`` in each of its two orders of work
    (``ops/segscan.py``), each held bit-equal to K3 as the path calls it:
    their graph ms (the gap between the first and the path's call is what
    the gather costs), and ``torch.segment_reduce``'s ms over the ordered
    rows."""
    import torch

    from event3dgs_tpu_torch.ops import segscan
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.tools.kernel_timing import (
        cuda_ms,
        graph_ms,
        k3_inputs,
    )

    via_dest, args, (head, lengths) = k3_inputs(bk, rows_k)
    want = rt.gaussian_grads(bk, rows_k)
    calls = {"in_order": lambda: segscan.segment_sums_kernel(*args),
             "rank_order": lambda: segscan.segment_sums_kernel(
                 *via_dest, by_output=False),
             "output_order": lambda: segscan.segment_sums_kernel(
                 *via_dest, by_output=True)}
    out = {}
    for key, call in calls.items():
        check(torch.equal(call(), want),
              f"{what}: K3 ({key.replace('_', ' ')}) differs from K3 as the "
              "path calls it")
        out[f"graph_ms_{key}"] = graph_ms(call)
    out["library_ms_in_order"] = cuda_ms(
        lambda: torch.segment_reduce(head, "sum", lengths=lengths), 20)
    print(f"{what}: K3 bit-equal over rows already in expansion order "
          f"(identity dest) {out['graph_ms_in_order']:.4f} graph ms, in rank "
          f"order {out['graph_ms_rank_order']:.4f}, in output order "
          f"{out['graph_ms_output_order']:.4f}; torch.segment_reduce over "
          f"the ordered rows {out['library_ms_in_order']:.4f} ms")
    return out


def adam_groups(state, data, idx, bg, icap, step, lr_on_device=False):
    """The two Adam groups of an event step of ``state`` (the six leaves,
    the contrast) with the kernel path's gradients at views ``idx`` and
    the learning rates of iteration ``step``; with ``lr_on_device`` the
    position rate a one-element tensor on the card, as the graphed step
    reads it from its row table."""
    import torch

    from event3dgs_tpu_torch.models import trainable_dict
    from event3dgs_tpu_torch.models.optimizer import AdamGroup
    from event3dgs_tpu_torch.train.step import _lr_tree, make_loss_and_grads
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    ev = EventConfig()
    fn = make_loss_and_grads("event", ev, ev.event_lambda_dssim,
                             rasterizer="tiled", instance_cap=icap)
    _, _, grads = fn(state, data, *idx, bg)
    lrs = _lr_tree(OptimizationConfig(), step, state.spatial_lr_scale)
    if lr_on_device:
        lrs["xyz"] = torch.tensor([lrs["xyz"]], device=bg.device)
    return [AdamGroup(trainable_dict(state.params), grads["params"],
                      state.opt_state, lrs),
            AdamGroup(state.contrast, grads["contrast"], state.contrast_opt,
                      ev.contrast_lr)]


def adam_tensors(results) -> list:
    """Every tensor of [(params, AdamState)], in order."""
    from event3dgs_tpu_torch.models.optimizer import leaves

    return [t for params, st in results
            for tree in (params, st.mu, st.nu, st.count)
            for t in leaves(tree)]


def adam_copy(groups) -> list:
    """The groups with their parameters and states copied (gradients and
    rates shared), and the (params, AdamState) to write into them."""
    from event3dgs_tpu_torch.models.optimizer import AdamGroup, AdamState

    clone = lambda t: ({k: v.clone() for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    copies = [AdamGroup(clone(g.params), g.grads, AdamState(
        clone(g.state.mu), clone(g.state.nu), g.state.count.clone()), g.lr)
        for g in groups]
    return copies, [(g.params, g.state) for g in copies]


def adam_check(what, groups, graphed=False):
    """The Adam kernel (``csrc/adam.cu``) against its plain version on a
    train step's ``groups``, bit for bit: two chained updates out of place,
    and two in place on copies of the state, replays of a CUDA graph of
    the in-place call with ``graphed``.  Returns (the largest difference,
    the in-place call on copies, the plain version's call)."""
    import torch

    from event3dgs_tpu_torch.models import optimizer as opt

    def chained(update, gs):
        for _ in range(2):
            res = update(gs)
            gs = [opt.AdamGroup(p, g.grads, s, g.lr)
                  for (p, s), g in zip(res, gs)]
        return res

    want = chained(lambda gs: [opt.adam_update_plain(*g) for g in gs], groups)
    got = {"out of place": chained(opt.adam_update_kernel, groups)}
    live, out = adam_copy(groups)
    if graphed:
        warm, warm_out = adam_copy(groups)
        opt.adam_update_kernel(warm, out=warm_out)  # any lazy set-up
        del warm, warm_out
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            opt.adam_update_kernel(live, out=out)
        for _ in range(2):
            graph.replay()
        got["in a CUDA graph"] = out
    else:
        for _ in range(2):
            opt.adam_update_kernel(live, out=out)
        got["in place"] = out
    torch.cuda.synchronize()
    err = 0.0
    for how, res in got.items():
        for a, b in zip(adam_tensors(res), adam_tensors(want), strict=True):
            ulps = bits_differ(a, b)
            check(ulps == 0, f"{what}: the Adam kernel ({how}) differs from "
                  f"its plain version by {ulps} ulps")
            err = max(err, (a.double() - b.double()).abs().max().item())
    floats = adam_floats(groups)
    print(f"{what}: Adam kernel {', '.join(got)} bit-equal to its plain "
          f"version over two chained updates ({floats} floats, counts "
          f"{int(groups[0].state.count)} -> {int(want[0][1].count)})")
    timed, timed_out = adam_copy(groups)
    return (err, lambda: opt.adam_update_kernel(timed, out=timed_out),
            lambda: [opt.adam_update_plain(*g) for g in groups])


def adam_floats(groups) -> int:
    """The floats the Adam update of ``groups`` updates."""
    from event3dgs_tpu_torch.models.optimizer import leaves

    return sum(t.numel() for g in groups for t in leaves(g.params))


def loss_views(state, data, idx, icap):
    """What an event step at views ``idx`` (main, now, next) gives its
    loss, as the graphed step gives it: the three 1080p renders of
    ``state`` through the kernel path as their partials (rgb, log T), now,
    next, main, no gradient; the GT images as frames of their stacks at
    [1] int64 device indices (the event pair's of ``event_images``, the
    main view's of ``images``); then the contrast [] (effective as
    identity) and a blurry operand for event_deblur (the frame of
    ``images`` after the main view)."""
    import torch

    from event3dgs_tpu_torch.losses.event import Frame, Partials
    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops.render import render_partials

    act = activated(state.params)
    cams = (data.event_cameras[idx[1]], data.event_cameras[idx[2]],
            data.cameras[idx[0]])
    with torch.no_grad():
        renders = [Partials(*render_partials(
            act.means3d, act.features, act.opacities, act.scales,
            act.rotations, cam, sh_degree=3, rasterizer="tiled",
            instance_cap=icap)[:2]) for cam in cams]
    dev = state.contrast.device
    frame = lambda stack, i: Frame(stack, torch.tensor([i], device=dev))
    gts = (frame(data.event_images, idx[1]), frame(data.event_images, idx[2]),
           frame(data.images, idx[0]))
    blurry = frame(data.images, (idx[0] + 1) % data.images.shape[0])
    return (*renders, *gts), state.contrast, blurry


def flat_tensors(xs) -> list:
    """The tensors of loss operands or gradients: a ``Partials``' rgb and
    log T, else the tensor."""
    from event3dgs_tpu_torch.losses.event import Partials

    return [t for x in xs for t in (x if isinstance(x, Partials) else (x,))]


def loss_check(what, operands, contrast, blurry, graphed=False):
    """Both loss kernels (``csrc/loss.cu``) against their plain versions on
    an event step's partials and GT frames (``loss_views``): in event and
    event_deblur mode (with ``blurry``) on the partials over a seeded
    background and the frames at device indices, as the step gives them,
    and in event mode on images (the partials composed, the frames
    picked), as the sharded step and the probes give them: the coverage
    and the renders' gradients (d rgb and d log T, or d image) bit for
    bit, the loss, its parts and the contrast's gradient within rtol 1e-5;
    the plain backward against autograd of the plain forward bit for bit;
    the kernels called twice (or, with ``graphed``, captured once in a
    CUDA graph and replayed twice) giving the same bits.  The background
    is seeded (the bench step's is zero, which would leave d log T zero).
    Returns ({kernel: largest |kernel - plain|},
    {kernel: (the kernel's call, its plain version's)} on the step's
    operands in event mode, {kernel: its bound's (bytes, operations)})."""
    import torch

    from event3dgs_tpu_torch.losses import event as ev
    from event3dgs_tpu_torch.tools.kernel_timing import loss_bound
    from event3dgs_tpu_torch.utils.config import EventConfig

    cfg = EventConfig()
    grad = torch.ones((), device=contrast.device)
    gen = torch.Generator().manual_seed(18)
    background = torch.rand(3, generator=gen).to(contrast.device)
    images = [ev.render_image(r, background) for r in operands[:3]]
    images += [ev.frame_image(g) for g in operands[3:]]
    errs = dict.fromkeys(LOSS, 0.0)
    worst = lambda a, b: (a.double() - b.double()).abs().max().item()
    close = lambda a, b: abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    cases = (("event", operands, None), ("event_deblur", operands, blurry),
             ("event, on images", images, None))
    for mode, ops, blur in cases:
        kw = dict(gt_contrast=cfg.gt_contrast, event_weight=cfg.event_weight,
                  blurry_main=blur, blur_alpha=cfg.blur_alpha,
                  background=background)

        def both():
            loss, aux = ev.event_loss_forward_kernel(*ops, contrast, **kw)
            return (loss, aux, *ev.event_loss_backward_kernel(
                grad, *ops, contrast, aux[2], **kw))

        if graphed:
            both()  # any lazy set-up
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = both()
            runs = []
            for _ in range(2):
                graph.replay()
                runs.append([t.clone() for t in flat_tensors(out)])
        else:
            runs = [flat_tensors(both()) for _ in range(2)]
        torch.cuda.synchronize()
        loss, aux, *got = runs[0]
        for a, b in zip(runs[0], runs[1]):
            check(bits_differ(a, b) == 0, f"{what} ({mode}): a loss kernel "
                  "gave other bits the second time")
        want_loss, want_aux = ev.event_mixture_loss_plain(*ops, contrast,
                                                          **kw)
        check(bits_differ(aux[2], want_aux["coverage"]) == 0,
              f"{what} ({mode}): coverage {float(aux[2])} vs "
              f"{float(want_aux['coverage'])}")
        for i, k in enumerate(ev.AUX):
            if k in want_aux:
                check(close(aux[i], want_aux[k]), f"{what} ({mode}): {k} "
                      f"{float(aux[i])} vs {float(want_aux[k])}")
        check(close(loss, want_loss), f"{what} ({mode}): loss {float(loss)} "
              f"vs {float(want_loss)}")
        want = flat_tensors(ev.event_loss_backward_plain(
            grad, *ops, contrast, want_aux["coverage"], **kw))
        leaves = [t.clone().requires_grad_(True)
                  for t in flat_tensors(ops[:3])]
        c = contrast.clone().requires_grad_(True)
        it = iter(leaves)
        renders = [type(r)(next(it), next(it)) if isinstance(r, ev.Partials)
                   else next(it) for r in ops[:3]]
        auto_loss, _ = ev.event_mixture_loss_plain(*renders, *ops[3:], c,
                                                   **kw)
        auto = torch.autograd.grad(auto_loss, leaves + [c])
        names = [f"{r} {x}" if isinstance(o, ev.Partials) else r
                 for r, o in zip(("now", "next", "main"), ops[:3])
                 for x in (("rgb", "log T") if isinstance(o, ev.Partials)
                           else ("",))]
        for k, a, b, c_ in zip(names, got, want, auto):
            ulps = bits_differ(a, b)
            check(ulps == 0, f"{what} ({mode}): d {k} differs from "
                  f"the plain backward by {ulps} ulps")
            ulps = bits_differ(b, c_)
            check(ulps == 0, f"{what} ({mode}): the plain backward's d "
                  f"{k} differs from autograd's by {ulps} ulps")
        check(close(got[-1], want[-1]) and close(want[-1], auto[-1]),
              f"{what} ({mode}): d contrast {float(got[-1])}, plain "
              f"{float(want[-1])}, autograd {float(auto[-1])}")
        errs[LOSS[0]] = max(errs[LOSS[0]], worst(loss, want_loss),
                            worst(aux[:3], torch.stack(
                                [want_aux[k] for k in ev.AUX[:3]])))
        errs[LOSS[1]] = max([errs[LOSS[1]]] + [worst(a, b)
                                               for a, b in zip(got, want)])
        print(f"{what} ({mode}): loss kernels vs plain: loss "
              f"{float(loss):.7f} / {float(want_loss):.7f}, coverage "
              f"{float(aux[2]):.6f} bit-equal, {', '.join(names)} "
              f"gradients bit-equal (and the plain backward to autograd's), "
              f"d contrast {float(got[-1]):.7g} / {float(want[-1]):.7g}; "
              f"{'two replays of a CUDA graph' if graphed else 'two runs'} "
              "bit-identical")
    kw = dict(gt_contrast=cfg.gt_contrast, event_weight=cfg.event_weight,
              background=background)
    _, aux = ev.event_loss_forward_kernel(*operands, contrast, **kw)
    coverage = aux[2]
    calls = {
        LOSS[0]: (lambda: ev.event_loss_forward_kernel(*operands, contrast,
                                                       **kw),
                  lambda: ev.event_mixture_loss_plain(*operands, contrast,
                                                      **kw)),
        LOSS[1]: (lambda: ev.event_loss_backward_kernel(
            grad, *operands, contrast, coverage, **kw),
            lambda: ev.event_loss_backward_plain(grad, *operands, contrast,
                                                 coverage, **kw)),
    }
    pixels = images[0].numel() // 3
    channels = [t.shape[-1] for t in images[3:]]
    bounds = {k: loss_bound(pixels, channels, backward=k == LOSS[1],
                            partials=3) for k in LOSS}
    return errs, calls, bounds


def photometric_views(state, data, idx, icap):
    """What an rgb or gray step at main view ``idx`` gives its loss, as the
    graphed step gives it: the 1080p render of ``state`` through the
    kernel path as its partials (rgb, log T), no gradient, and the GT as
    the frame of ``images`` at a [1] int64 device index."""
    import torch

    from event3dgs_tpu_torch.losses.event import Frame, Partials
    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops.render import render_partials

    act = activated(state.params)
    with torch.no_grad():
        render = Partials(*render_partials(
            act.means3d, act.features, act.opacities, act.scales,
            act.rotations, data.cameras[idx], sh_degree=3,
            rasterizer="tiled", instance_cap=icap)[:2])
    dev = state.contrast.device
    return render, Frame(data.images, torch.tensor([idx], device=dev))


def photometric_check(what, render, gt, graphed=False):
    """Both SSIM loss kernels (``csrc/ssim.cu``) against their plain
    versions on a step's main-view partials and GT frame
    (``photometric_views``): in rgb and gray mode on the partials over a
    seeded background and the frame at a device index, as the step gives
    them, and in rgb mode on the composed image and the picked frame, as
    the sharded step gives them: the derivative maps and the render's
    gradients (d rgb and d log T, or d image) bit for bit, the loss and l1
    within rtol 1e-5; the kernels called twice (or, with ``graphed``,
    captured once in a CUDA graph and replayed twice) giving the same bits.
    Returns ({kernel: largest |kernel - plain|}, and per mode, rgb then
    gray, ({kernel: (the kernel's call, its plain version's)} on the step's
    operands, {kernel: its bound's (bytes, operations)}))."""
    import torch

    from event3dgs_tpu_torch.losses import event as ev
    from event3dgs_tpu_torch.losses import modes
    from event3dgs_tpu_torch.tools.kernel_timing import photometric_bound

    lam = 0.2  # OptimizationConfig's lambda_dssim
    dev = render.rgb.device
    grad = torch.ones((), device=dev)
    gen = torch.Generator().manual_seed(19)
    bg = torch.rand(3, generator=gen).to(dev)
    errs = dict.fromkeys(PHOTO, 0.0)
    worst = lambda a, b: (a.double() - b.double()).abs().max().item()
    close = lambda a, b: abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    cases = (("rgb", render, gt, False), ("gray", render, gt, True),
             ("rgb, on images", ev.render_image(render, bg).contiguous(),
              ev.frame_image(gt), False))
    for mode, r, g, gray in cases:
        def both():
            loss, l1, maps = modes.photometric_loss_forward_kernel(
                r, g, lam, gray, bg)
            return [loss, l1, maps, *flat_tensors([
                modes.photometric_loss_backward_kernel(grad, r, g, maps, lam,
                                                       gray, bg)])]

        if graphed:
            both()  # any lazy set-up
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = both()
            runs = []
            for _ in range(2):
                graph.replay()
                runs.append([t.clone() for t in out])
        else:
            runs = [both() for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(runs[0], runs[1]):
            check(bits_differ(a, b) == 0, f"{what} ({mode}): an SSIM loss "
                  "kernel gave other bits the second time")
        loss, l1, maps, *got = runs[0]
        want_loss, want_l1, want_maps = modes.photometric_loss_plain(
            r, g, lam, gray, bg)
        check(close(loss, want_loss) and close(l1, want_l1),
              f"{what} ({mode}): loss {float(loss)}, l1 {float(l1)} vs "
              f"{float(want_loss)}, {float(want_l1)}")
        ulps = bits_differ(maps, want_maps)
        check(ulps == 0, f"{what} ({mode}): the derivative maps differ from "
              f"the plain version's by {ulps} ulps")
        want = flat_tensors([modes.photometric_loss_backward_plain(
            grad, r, g, want_maps, lam, gray, bg)])
        names = ("d rgb", "d log T") if len(want) == 2 else ("d image",)
        for k, a, b in zip(names, got, want):
            ulps = bits_differ(a, b)
            check(ulps == 0, f"{what} ({mode}): {k} differs from the plain "
                  f"backward by {ulps} ulps")
        errs[PHOTO[0]] = max(errs[PHOTO[0]], worst(loss, want_loss),
                             worst(l1, want_l1), worst(maps, want_maps))
        errs[PHOTO[1]] = max([errs[PHOTO[1]]] + [worst(a, b)
                                                 for a, b in zip(got, want)])
        print(f"{what} ({mode}): SSIM loss kernels vs plain: loss "
              f"{float(loss):.7f} / {float(want_loss):.7f}, l1 "
              f"{float(l1):.7f} / {float(want_l1):.7f}, the derivative maps "
              f"and {', '.join(names)} bit-equal; "
              f"{'two replays of a CUDA graph' if graphed else 'two runs'} "
              "bit-identical")
    pixels = render.rgb.numel() // 3
    gt_channels = ev.frame_image(gt).shape[-1]
    per_mode = []
    for gray in (False, True):
        _, _, maps = modes.photometric_loss_forward_kernel(render, gt, lam,
                                                           gray, bg)
        calls = {
            PHOTO[0]: (lambda gray=gray: modes.photometric_loss_forward_kernel(
                render, gt, lam, gray, bg),
                lambda gray=gray: modes.photometric_loss_plain(
                    render, gt, lam, gray, bg)),
            PHOTO[1]: (lambda gray=gray, maps=maps:
                       modes.photometric_loss_backward_kernel(
                           grad, render, gt, maps, lam, gray, bg),
                       lambda gray=gray, maps=maps:
                       modes.photometric_loss_backward_plain(
                           grad, render, gt, maps, lam, gray, bg)),
        }
        bounds = {k: photometric_bound(pixels, 1 if gray else 3,
                                       k == PHOTO[1], gt_channels)
                  for k in PHOTO}
        per_mode.append((calls, bounds))
    return errs, *per_mode


def wrappers():
    """Every kernel's launch wrapper, by name."""
    from event3dgs_tpu_torch.losses import event as ev
    from event3dgs_tpu_torch.losses import modes
    from event3dgs_tpu_torch.models import optimizer as opt
    from event3dgs_tpu_torch.ops import binning, expand, segscan, sort_tiles
    from event3dgs_tpu_torch.ops import preprocess as pre
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt

    return {
        "preprocess_forward": pre.preprocess_forward_kernel,
        "preprocess_backward": pre.preprocess_backward_kernel,
        "K1 composite_forward": rt.composite_forward_kernel,
        "K2 composite_backward": rt.composite_backward_kernel,
        "K3 segment_sums": segscan.segment_sums_kernel,
        "K4 gaussian_tables": binning.gaussian_tables_kernel,
        "K4 depth_sort": binning.depth_sort_kernel,
        "K4 depth_offsets": binning.depth_offsets_kernel,
        "K4 expand_instances": expand.expand_instances_kernel,
        "K5 tile_histogram": sort_tiles.tile_histogram_kernel,
        "K6 stable_tile_rank": sort_tiles.stable_tile_rank_kernel,
        ADAM: opt.adam_update_kernel,
        LOSS[0]: ev.event_loss_forward_kernel,
        LOSS[1]: ev.event_loss_backward_kernel,
        PHOTO[0]: modes.photometric_loss_forward_kernel,
        PHOTO[1]: modes.photometric_loss_backward_kernel,
    }


# the count beside the kernels' of the instance-cap probes
# (train/loop.probe_instance_count), each one forward preprocess launch
PROBES = "instance-cap probes"
# the kernels that run only in a backward pass
BACKWARD = ("preprocess_backward", "K2 composite_backward", "K3 segment_sums")
# the kernel that runs once per train step (both Adam groups in one launch)
ADAM = "adam_update"
# the kernels that run once per event-mode train step (forward, backward)
LOSS = ("event_loss_forward", "event_loss_backward")
# the kernels that run once per rgb- or gray-mode train step
PHOTO = ("photometric_loss_forward", "photometric_loss_backward")


@contextlib.contextmanager
def counting(name, *modules):
    """While open, each call of the function ``name`` of ``modules`` (one
    function, which each module defines or imported) appends 1 to the list
    it yields."""
    calls, fn = [], getattr(modules[0], name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    for m in modules:
        setattr(m, name, counted)
    try:
        yield calls
    finally:
        for m in modules:
            setattr(m, name, fn)


def counting_packs():
    """``counting`` of ``pack_features`` (the tiled rasterizer's packing
    and the plain preprocess's): the event step and the colour render
    take the packed rows from the preprocess forward kernel and call it
    nowhere."""
    from event3dgs_tpu_torch.ops import preprocess as pre
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt

    return counting("pack_features", rt, pre)


def counting_composes():
    """``counting`` of ``ops/render.composed`` (and of the name the loss's
    plain versions imported): the train step hands its renders' partials
    to the loss kernels, which compose them, and calls it nowhere."""
    import importlib

    from event3dgs_tpu_torch.losses import event as ev

    # the module: the package's name ``render`` is the function
    render = importlib.import_module("event3dgs_tpu_torch.ops.render")
    return counting("composed", render, ev)


def counting_convs():
    """``counting`` of ``torch.nn.functional.conv2d``: the rgb and gray
    steps' SSIM runs in its kernels, and the step calls it nowhere."""
    import torch.nn.functional as F

    return counting("conv2d", F)


def count_launches(fn):
    """Run ``fn`` with every launch count set to 0; return (its result, the
    counts it left, and under ``PROBES`` the instance-cap probes it ran)."""
    import torch

    from event3dgs_tpu_torch.train import loop

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    loop.probe_instance_count.calls = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {**{k: w.launches for k, w in ws.items()},
                 PROBES: loop.probe_instance_count.calls}


def check_launches(what, launches, renders, backward, projections=0,
                   steps=0, event=True, shared=True):
    """Each kernel launched once per render, the backward kernels once per
    differentiated render (``backward``), the Adam kernel once per train
    step (``steps``), the event loss kernels once per train step of an
    event mode (``event``: the steps' mode is one), the SSIM loss kernels
    once per train step of rgb or gray mode, and the forward preprocess once
    more per instance-cap probe and per projection outside a render
    (``projections``).  A train step's renders (3 in an event mode, 1
    else) share one launch of each preprocess kernel, 2 a step (with
    ``shared``; the sharded step projects each render on its own)."""
    shared = (3 - 1 if event and shared else 0) * steps
    for k, n in launches.items():
        if k == PROBES:
            continue
        want = (steps if k == ADAM else (steps if event else 0) if k in LOSS
                else (0 if event else steps) if k in PHOTO
                else backward if k in BACKWARD else renders)
        if k.startswith("preprocess"):
            want -= shared
        if k == "preprocess_forward":
            want += launches[PROBES] + projections
        check(n == want, f"{what}: {k} launched {n} times, not {want} "
              f"({renders} renders, {backward} backward, {steps} steps, "
              f"{launches[PROBES]} instance-cap probes)")


def run_cli(main, args):
    """Run an entry point with every launch count set to 0, its standard
    output captured and echoed.  Returns (exit code, counts, output)."""
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            rc, launches = count_launches(lambda: main(args))
    finally:
        print(log.getvalue().strip())
    return rc, launches, log.getvalue()


def check_render_launches(what, launches, renders, projections=0):
    """Each render kernel launched once per render (the forward preprocess
    once more per projection outside a render); the backward kernels and
    Adam never."""
    check_launches(what, launches, renders, 0, projections)


def render_path(root: str, dev):
    """Phases 2-5: cli.render on bench.py's model; the render kernels against
    their plain versions and timed.  Returns (launches, errors, rows)."""
    import torch

    from event3dgs_tpu_torch.cli.render import main as render_main
    from event3dgs_tpu_torch.data.ply import load_gaussian_ply
    from event3dgs_tpu_torch.data.scene import build_camera_batch, read_blender_scene
    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.ops.projection import project_gaussians
    from event3dgs_tpu_torch.ops.rasterize_reference import rasterize_reference
    from event3dgs_tpu_torch.ops.render import render

    # 2. generate ----------------------------------------------------------
    t0 = time.perf_counter()
    model, src = generate(root)
    print(f"generate: {time.perf_counter() - t0:.1f} s")

    # 3. the render path: cli.render on the card ----------------------------
    t0 = time.perf_counter()
    with counting_packs() as packs:
        rc, launches = count_launches(lambda: render_main(
            ["-m", model, "--skip_test", "--device", DEVICE]))
    check(rc == 0, "cli.render failed")
    check(not packs, f"cli.render called pack_features {len(packs)} times")
    cli_s = time.perf_counter() - t0
    print(f"cli.render: {VIEWS} views in {cli_s:.2f} s (PNG IO included); "
          f"launches {launches}; pack_features called 0 times")
    check_render_launches("cli.render", launches, VIEWS)
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
    # a render reads its [N, K, 3] features as two strided views of them
    pre = preprocess_check("view 0", act, act.features[:, :1],
                           act.features[:, 1:], [cam])
    proj, colors = pre.proj, pre.colors
    v = view_kernels("view 0", proj, colors, act.opacities,
                     rt.default_instance_cap(N_GAUSSIANS), dev)
    v.errs.update(pre.errs)
    v.calls.update(pre.calls)
    v.bounds.update(pre.bounds)

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

    ids_long = v.tk.long()
    libraries = depth_libraries(v)
    libraries.update({
        "K5 tile_histogram": lambda: torch.bincount(ids_long,
                                                    minlength=v.nt + 1),
        "K6 stable_tile_rank": lambda: torch.sort(v.tk, stable=True),
    })
    timings = {name: (*v.calls[name], libraries.get(name),
                      20 if name.startswith("K1") else 50)
               for name in v.calls}
    meta = {
        # XLA's fusions of the JAX projection and SH colours (no Pallas
        # kernel there)
        "preprocess_forward": ("preprocess.cu", PREPROCESS_REPLACES),
        "K1 composite_forward": ("rasterize_fwd.cu", "event3dgs_tpu/ops/rasterize_tiled.py:296"),
        # the table and depth offsets kernels replace the XLA code that
        # feeds K4 in the JAX binning
        "K4 gaussian_tables": ("expand.cu", "event3dgs_tpu/ops/binning.py:273"),
        # the sort and the scan that the JAX binning leaves to XLA
        "K4 depth_sort": ("depth_sort.cu", "event3dgs_tpu/ops/binning.py:306"),
        "K4 depth_offsets": ("depth_sort.cu",
                             "event3dgs_tpu/ops/binning.py:326"),
        "K4 expand_instances": ("expand.cu", "event3dgs_tpu/ops/expand.py:65"),
        "K5 tile_histogram": ("sort_tiles.cu", "event3dgs_tpu/ops/sort_tiles.py:62"),
        "K6 stable_tile_rank": ("sort_tiles.cu", "event3dgs_tpu/ops/sort_tiles.py:88"),
    }
    rows = kernel_rows(timings, v.bounds, meta, v.errs)
    rows["K4 depth_sort"]["depth_order"] = depth_order_timing(
        "view 0", v, rt.default_instance_cap(N_GAUSSIANS))
    occupancy_rows(rows, pre.occupancy)
    composite_report("K1 composite_forward", rows["K1 composite_forward"],
                     v.pairs, v.bounds["K1 composite_forward"][0],
                     "rasterize_fwd", "e3d_composite_forward_occupancy")
    return launches, v.errs, rows


def kernel_device_ms(name, fn) -> tuple[float, float]:
    """The profiler's self device time per call of ``fn`` in the CUDA
    functions of kernel ``name`` (KERNEL_FUNCTIONS, each launched once per
    call, or LAUNCHES_PER_CALL times), matched by exact name, each
    function's time taken over the launches the profiler saw of it; and
    the fewest calls' worth of launches it saw of one of them.  Fails if
    the profiler saw none of one of them in
    ``kernel_timing.PROFILE_SESSIONS`` sessions."""
    from event3dgs_tpu_torch.tools.kernel_timing import (
        device_profile,
        per_launch_ms,
    )

    functions = KERNEL_FUNCTIONS[name]
    prof = device_profile(fn, expect=functions)
    missing = [f for f in functions if f not in prof]
    check(not missing, f"{name}: the profiler saw no device time in {missing}")
    per_call = {f: LAUNCHES_PER_CALL.get(f, 1) for f in functions}
    return (sum(per_launch_ms(prof, (f,)) * per_call[f] for f in functions),
            min(prof[f][1] / per_call[f] for f in functions))


def kernel_rows(timings, bounds, meta, errs):
    """Time each kernel (CUDA events per call, the profiler's device time
    in the kernel's own CUDA functions, and the time per call of 20 calls
    captured in a CUDA graph, which no host work enters), its plain version
    and its yardstick; one JSON row each (``launches`` is filled in by the
    caller)."""
    from event3dgs_tpu_torch.tools.kernel_timing import (
        bound_ms,
        cuda_ms,
        graph_ms,
    )

    rows = {}
    for name, (kern, plain, lib, iters) in timings.items():
        ms = cuda_ms(kern, iters)
        device_ms, seen = kernel_device_ms(name, kern)
        in_graph = graph_ms(kern)
        plain_ms = cuda_ms(plain, max(iters // 10, 2), warmup=1)
        lib_ms = cuda_ms(lib, iters) if lib is not None else None
        bound, bound_by = bound_ms(*bounds[name])
        src_file, replaces = meta[name]
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": f"event3dgs_tpu_torch/csrc/{src_file}",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": errs[name],
            "ms": ms,
            "device_ms": device_ms,
            "graph_ms": in_graph,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        }
        lib_txt = "-" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"{name}: kernel {ms:.4f} ms per call ({device_ms:.4f} ms device "
              f"over {seen:.2f} launches seen per call, {in_graph:.4f} ms in a "
              "graph), "
              f"plain {plain_ms:.4f} ms, library {lib_txt} ms, bound "
              f"{bound:.4f} ms ({bound_by})")
    return rows


def train_path(root: str):
    """Phase 6: cli.train --gray --event on a 1080p COLMAP scene, then
    cli.render on its PLY (the train and the held-out test views); then
    cli.train in rgb mode (no flag) and in gray mode (--gray) for
    ``PHOTO_ITERS`` iterations each on the same scene.  Returns the event
    run's launch counts, its model folder and the launch counts of the rgb
    and gray runs together."""
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
    t0 = time.perf_counter()
    rc, launches, log = run_cli(train_main, args)
    train_s = time.perf_counter() - t0
    check(rc == 0, "cli.train failed")
    print(f"cli.train: {TRAIN_ITERS} iterations in {train_s:.2f} s (scene "
          f"load, init and PLY/checkpoint IO included); launches {launches}")
    check_launches(f"cli.train, {TRAIN_ITERS} event steps", launches,
                   3 * TRAIN_ITERS, 3 * TRAIN_ITERS, steps=TRAIN_ITERS)
    last = re.search(r"last loss (\S+)", log)
    check(last is not None and math.isfinite(float(last.group(1))),
          "no finite loss reported")
    alive = [int(n) for n in re.findall(r"num_alive=(\d+)", log)]
    check(len(alive) == 2, "densify did not run at iterations 3 and 6")
    check(N_GAUSSIANS < alive[0] < alive[1],
          f"densify did not add Gaussians: {N_GAUSSIANS} -> {alive}")
    caps = re.findall(r"instance_cap=(\d+)", log)
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
    views = 2 * TRAIN_VIEWS  # the train and the test set
    print(f"cli.render of the trained model: {views} views in "
          f"{time.perf_counter() - t0:.2f} s; launches {rlaunches}")
    check_render_launches("cli.render of the trained model", rlaunches, views)
    for split in ("train", "test"):
        renders = os.path.join(model, split, f"ours_{TRAIN_ITERS}", "renders")
        check(len(os.listdir(renders)) == TRAIN_VIEWS,
              f"missing trained {split} renders")

    # the rgb and gray modes: one render a step, the SSIM loss kernels
    photo = {}
    for flags in ([], ["--gray"]):
        mode = "gray" if flags else "rgb"
        args = ["-s", src, "-m", os.path.join(root, f"trained_{mode}"), *flags,
                "-r", "1", "--iterations", str(PHOTO_ITERS), "--device",
                DEVICE]
        t0 = time.perf_counter()
        with counting_composes() as composes, counting_convs() as convs:
            rc, runs, log = run_cli(train_main, args)
        check(rc == 0, f"cli.train ({mode} mode) failed")
        check(not composes and not convs, f"cli.train ({mode} mode) called "
              f"ops.render.composed {len(composes)} and F.conv2d "
              f"{len(convs)} times")
        last = re.search(r"last loss (\S+)", log)
        check(last is not None and math.isfinite(float(last.group(1))),
              f"cli.train ({mode} mode): no finite loss reported")
        check_launches(f"cli.train, {PHOTO_ITERS} {mode} steps", runs,
                       PHOTO_ITERS, PHOTO_ITERS, steps=PHOTO_ITERS,
                       event=False)
        print(f"cli.train {' '.join(args)}: {PHOTO_ITERS} {mode} steps in "
              f"{time.perf_counter() - t0:.2f} s, last loss "
              f"{float(last.group(1)):.6f}, no composed or F.conv2d call; "
              f"launches {runs}")
        photo = {k: photo.get(k, 0) + n for k, n in runs.items()}
    return launches, model, photo


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    from event3dgs_tpu_torch.tools import kernel_timing

    return kernel_timing.card()


def random_lpips_weights(net: str, seed: int = 0) -> dict:
    """LPIPS weights of ``net``'s shapes from ``seed``: He-normal kernels
    (HWIO), small biases, non-negative heads."""
    from event3dgs_tpu_torch.losses.lpips import weight_shapes

    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in weight_shapes(net).items():
        if len(shape) == 4:
            out[key] = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:3])), shape)
        elif key.startswith("lin"):
            out[key] = np.abs(rng.normal(0, 1, shape))
        else:
            out[key] = rng.normal(0, 0.05, shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def evaluation_path(root: str, model: str, dev):
    """Phase 9 on phase 6's trained model (1080p, ~400k alive):
    ``cli.evaluate`` with LPIPS, LPIPS on the card against the CPU for the
    three backbones, ``cli.metrics``, the rest of ``cli.render`` (depth,
    point, blurry, transforms) and an SH degree 4 render."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from event3dgs_tpu_torch.cli.common import load_trained_model
    from event3dgs_tpu_torch.cli.evaluate import main as evaluate_main
    from event3dgs_tpu_torch.cli.metrics import main as metrics_main
    from event3dgs_tpu_torch.cli.render import main as render_main
    from event3dgs_tpu_torch.core import make_camera
    from event3dgs_tpu_torch.data.scene import read_colmap_scene
    from event3dgs_tpu_torch.losses.lpips import LPIPS, params_from_arrays
    from event3dgs_tpu_torch.tools.kernel_timing import cuda_ms
    from event3dgs_tpu_torch.tools.render_products import (
        point_depth_map,
        render_blurry_set,
    )
    from event3dgs_tpu_torch.train.loop import TEST_VIEW_INDICES
    from event3dgs_tpu_torch.utils.image_io import load_image_f32

    smi = card()
    weights = os.path.join(root, "lpips_alex.npz")
    np.savez(weights, **random_lpips_weights("alex"))

    # cli.evaluate: the holdout views below TRAIN_VIEWS (index 5)
    views = [i for i in TEST_VIEW_INDICES if i < TRAIN_VIEWS]
    t0 = time.perf_counter()
    rc, launches, out = run_cli(evaluate_main, [
        "-m", model, "--save_images", "--lpips_weights", weights,
        "--device", DEVICE])
    eval_s = time.perf_counter() - t0
    check(rc == 0, "cli.evaluate failed")
    check_render_launches("cli.evaluate", launches, len(views))
    m = re.search(r"\[SSIM (\S+) PSNR (\S+) LPiPS ([^\]\s]+)\]", out)
    check(m is not None, "cli.evaluate printed no SSIM/PSNR/LPiPS line")
    scores = [float(x) for x in m.groups()]
    check(all(math.isfinite(v) for v in scores), f"non-finite scores {scores}")
    images = os.path.join(model, "images")
    for i in views:
        for kind in ("sim", "real"):
            path = os.path.join(images, f"{kind}_{i:05d}.png")
            check(os.path.exists(path), f"missing {path}")
    print(f"cli.evaluate: holdout views {views} at {WIDTH}x{HEIGHT} in "
          f"{eval_s:.2f} s wall (scene load and PNG IO included); SSIM "
          f"{scores[0]} PSNR {scores[1]} LPIPS {scores[2]}; launches "
          f"{launches}; {smi}")

    # LPIPS on the card against the CPU, one 1080p pair per backbone; its
    # bound: the convolutions' FLOPs (PyTorch's flop counter) at the FP32
    # peak
    pair = [torch.tensor(load_image_f32(os.path.join(images, f"{kind}_{views[0]:05d}.png")))
            for kind in ("sim", "real")]
    on_card = [x.to(dev) for x in pair]
    for net in ("alex", "vgg", "squeeze"):
        params = params_from_arrays(random_lpips_weights(net))
        cpu = float(LPIPS(params, net)(*pair))
        module = LPIPS(params, net).to(dev)
        with FlopCounterMode(display=False) as flops:
            got = float(module(*on_card))
        rel = abs(got - cpu) / abs(cpu)
        check(math.isfinite(got) and rel <= 1e-4,
              f"LPIPS {net}: card {got} vs CPU {cpu} (rel {rel:.3g})")
        ms = cuda_ms(lambda: module(*on_card), 5, warmup=1)
        gflop = flops.get_total_flops() / 1e9
        bound = gflop / PEAK_FP32_FLOPS * 1e12
        print(f"LPIPS {net}, one {WIDTH}x{HEIGHT} pair: {ms:.2f} ms on the card "
              f"(CUDA events, 5 pairs); {gflop:.1f} GFLOP of convolutions, "
              f"{gflop / ms:.2f} TFLOP/s, bound {bound:.2f} ms at the FP32 "
              f"peak ({ms / bound:.1f}x); card {got:.8f} vs CPU {cpu:.8f} "
              f"(rel {rel:.2e}); {smi}")
        del module

    # cli.metrics over test/ours_<it>/{renders,gt} of phase 6's cli.render
    t0 = time.perf_counter()
    rc, _, _ = run_cli(metrics_main, ["-m", model, "--lpips_weights", weights,
                                      "--device", DEVICE])
    check(rc == 0, "cli.metrics failed")
    for name in ("results.json", "per_view.json"):
        check(os.path.exists(os.path.join(model, name)), f"cli.metrics wrote no {name}")
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    check(sorted(results) == ["LPIPS", "PSNR", "SSIM"]
          and all(math.isfinite(v) for v in results.values()),
          f"cli.metrics results {results}")
    print(f"cli.metrics: {TRAIN_VIEWS} test views at {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.2f} s wall (PNG IO included); {results}; "
          f"{smi}")

    # the rest of cli.render: depth, point, blurry (18 renders per frame),
    # transforms
    t0 = time.perf_counter()
    rc, launches, _ = run_cli(render_main, [
        "-m", model, "--depth", "--point", "--blurrySpeed", "1",
        "--export_transforms", "--skip_test", "--device", DEVICE])
    products_s = time.perf_counter() - t0
    check(rc == 0, "cli.render --depth --point --blurrySpeed 1 failed")
    blurry = (TRAIN_VIEWS - 1) * BLUR_STEPS
    check_render_launches("cli.render products", launches,
                          TRAIN_VIEWS + TRAIN_VIEWS + blurry,
                          projections=TRAIN_VIEWS)  # the point maps
    base = os.path.join(model, "train", f"ours_{TRAIN_ITERS}")
    for sub, want in (("depth", TRAIN_VIEWS), ("point", TRAIN_VIEWS),
                      ("blurry", TRAIN_VIEWS - 1)):
        n = len(os.listdir(os.path.join(base, sub)))
        check(n == want, f"cli.render wrote {n} {sub} images, not {want}")
    check(os.path.exists(os.path.join(model, "transforms_train.json")),
          "cli.render wrote no transforms_train.json")
    print(f"cli.render --depth --point --blurrySpeed 1 --export_transforms: "
          f"{TRAIN_VIEWS} train + {TRAIN_VIEWS} depth + {blurry} blur renders "
          f"and {TRAIN_VIEWS} point maps in {products_s:.2f} s wall; launches "
          f"{launches}; {smi}")

    # the point path alone launches the forward preprocess and no other
    # kernel (on phase 2's model: the trained one has no Gaussian above the
    # 0.8 opacity threshold yet)
    _, _, bench_params = load_trained_model(os.path.join(root, "model"), -1, dev)
    view0 = make_camera(np.eye(3), np.zeros(3), 1.2, 0.75, WIDTH, HEIGHT,
                        device=dev)
    depth, launches = count_launches(lambda: point_depth_map(bench_params, view0))
    check_render_launches("point_depth_map", launches, 0, projections=1)
    check(bool(torch.isfinite(depth).any()), "point_depth_map found no point")
    # a blurry frame timed alone, on the trained model
    _, _, params = load_trained_model(model, -1, dev)
    info = read_colmap_scene(os.path.join(root, "colmap"))
    bg = torch.zeros(3, device=dev)
    frames = 2
    t0 = time.perf_counter()
    render_blurry_set(params, info.train_cameras[:frames + 1],
                      os.path.join(root, "blurry_timed"), WIDTH, HEIGHT, 3,
                      bg=bg, rasterizer="tiled")
    torch.cuda.synchronize()
    blur_ms = (time.perf_counter() - t0) / frames * 1e3
    print(f"blurry set: {blur_ms:.1f} ms per {WIDTH}x{HEIGHT} frame "
          f"({BLUR_STEPS} renders, camera set-up and PNG write; host clock, "
          f"{frames} frames); point_depth_map of bench.py's view 0: one "
          f"forward preprocess launch, {int(torch.isfinite(depth).sum())} "
          f"pixels hit; {smi}")
    sh_degree_4(dev)


def timed(fn):
    """(fn's result, its host-clock ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def event_model(root: str, model: str) -> tuple[str, str]:
    """Phase 6's trained model behind a copy of its source whose cameras
    are ``EVENT_SPREAD`` times farther apart along x.  Phase 6's views move
    0.01 apart (bench.py's poses), about a pixel at the scene's depth: the
    chain between them changes no pixel's log intensity by a contrast
    threshold and the DVS fires nothing.  Returns (model, source)."""
    from event3dgs_tpu_torch.cli.common import load_run_config
    from event3dgs_tpu_torch.data.colmap import read_model, write_model

    src, wide = os.path.join(root, "colmap"), os.path.join(root, "colmap_wide")
    cams, images, points = read_model(os.path.join(src, "sparse", "0"))
    images = {k: im._replace(tvec=im.tvec * [EVENT_SPREAD, 1.0, 1.0])
              for k, im in images.items()}
    write_model(cams, images, points, os.path.join(wide, "sparse", "0"))
    for folder in ("images", "images_event", "renders"):
        os.symlink(os.path.join(src, folder), os.path.join(wide, folder))
    out = os.path.join(root, "trained_wide")
    os.makedirs(out)
    os.symlink(os.path.join(model, "point_cloud"), os.path.join(out, "point_cloud"))
    cfg = load_run_config(model)
    cfg.model.source_path = wide
    with open(os.path.join(out, "cfg.json"), "w") as f:
        f.write(cfg.to_json())
    return out, wide


def event_path(root: str, model: str, dev):
    """Phase 10 on phase 6's trained model (1080p, ~400k alive), seen from
    cameras spread wider (:func:`event_model`): ``cli.render --event``, the
    event frames on the card against the CPU, the native DVS simulator
    against the numpy model, ``cli.generate_dataset`` in both modes, and
    each part of the event synthesis timed."""
    import torch

    from event3dgs_tpu_torch.cli.common import load_trained_model
    from event3dgs_tpu_torch.cli.generate_dataset import main as generate_main
    from event3dgs_tpu_torch.cli.render import main as render_main
    from event3dgs_tpu_torch.data.scene import read_colmap_scene
    from event3dgs_tpu_torch.events import accumulate, native
    from event3dgs_tpu_torch.events.buffer import EventBuffer
    from event3dgs_tpu_torch.events.dvs_model import DvsParams, DvsSimulator
    from event3dgs_tpu_torch.events.io import load_dat_events, window_events
    from event3dgs_tpu_torch.events.simulate import (
        generate_event_frames,
        rgb_to_luminance,
        save_event_result,
    )
    from event3dgs_tpu_torch.tools.render_products import (
        _render_view,
        interpolated_cameras,
    )
    from event3dgs_tpu_torch.utils.image_io import load_image_f32, save_image

    smi = card()
    renders = (TRAIN_VIEWS - 1) * EVENT_STEPS + 1
    window = int(EVENT_DT * EVENT_STEPS)  # render_event_set's frame window
    wide_model, wide_src = event_model(root, model)

    # cli.render --event: the interpolated chain alone (--skip_train and
    # --skip_test), so each render kernel launches once per chain view
    t0 = time.perf_counter()
    rc, launches, _ = run_cli(render_main, [
        "-m", wide_model, "--event", "--interpolationN", str(EVENT_STEPS), "--dt",
        str(EVENT_DT), "--skip_train", "--skip_test", "--device", DEVICE])
    cli_s = time.perf_counter() - t0
    check(rc == 0, "cli.render --event failed")
    check_render_launches("cli.render --event", launches, renders)
    out = os.path.join(wide_model, "train", f"ours_{TRAIN_ITERS}", "event")
    names = sorted(os.listdir(out))
    want = [f"render_{i:05d}.png" for i in range(renders)]
    check(names == sorted(want + ["frames", "raw.dat"]),
          f"cli.render --event wrote {names[:5]}... ({len(names)} entries)")
    t, x, y, p = load_dat_events(os.path.join(out, "raw.dat"))
    check(len(t) > 0, "raw.dat holds no event")
    check(bool((np.diff(t.astype(np.int64)) >= 0).all()), "raw.dat: unsorted timestamps")
    check(int(x.max()) < WIDTH and int(y.max()) < HEIGHT,
          f"raw.dat: x max {x.max()}, y max {y.max()}")
    windows = window_events(t, x, y, p, window).events
    n_frames = len(os.listdir(os.path.join(out, "frames")))
    check(n_frames == len(windows) > 0,
          f"frames/ holds {n_frames} PNGs for {len(windows)} windows")
    print(f"cli.render --event --interpolationN {EVENT_STEPS} --dt {EVENT_DT}: "
          f"{renders} renders, {len(t)} events, {n_frames} frames in "
          f"{cli_s:.2f} s wall; launches {launches}; {smi}")

    # the event frames on the card against the CPU, exactly: the busiest
    # window (it repeats pixels), and that window with every other x moved
    # one row width on (past the row: wraps, or dropped past the image)
    busiest = max(windows, key=len)
    bx, by = busiest["x"].astype(np.int32), busiest["y"].astype(np.int32)
    check(len(np.unique(by * WIDTH + bx)) < len(bx),
          "the busiest window repeats no pixel")
    shifted = bx.copy()
    shifted[::2] += WIDTH
    for what, wx in (("busiest window", bx), ("x past the row", shifted)):
        for fn in ("event_count_image", "accumulation_frame",
                   "color_polarity_frame", "polarity_frame"):
            card_img = getattr(accumulate, fn)(wx, by, busiest["p"], WIDTH,
                                               HEIGHT, device=dev).cpu()
            cpu_img = getattr(accumulate, fn)(wx, by, busiest["p"], WIDTH,
                                              HEIGHT, device="cpu")
            check(torch.equal(card_img, cpu_img),
                  f"{fn} on the card differs from the CPU ({what})")
    print(f"event frames, card vs CPU: equal for the four frame functions on "
          f"{len(bx)} events of one window (repeated pixels; and half of "
          f"them past the row)")

    # the native simulator (built with g++ here) against the numpy model,
    # deterministic, along the chain from its first frame until a frame
    # fires events
    _, build_ms = timed(native.build)
    lum = [rgb_to_luminance(load_image_f32(os.path.join(out, f)).astype(np.float64))
           for f in want]
    k = 0
    det = DvsParams(th_noise=0, jitter=0)
    sims = [cls(WIDTH, HEIGHT, det) for cls in (native.NativeDvsSimulator,
                                                 DvsSimulator)]
    for sim in sims:
        sim.disable_noise()
        sim.init_image(lum[k])
    n_events, last = 0, k
    while n_events == 0 and last + 1 < len(lum):
        last += 1
        a, b = (np.sort(sim.update(lum[last], EVENT_DT).to_structured(),
                        order=["t", "x", "y", "p"]) for sim in sims)
        check(np.array_equal(a, b), f"native DVS stream ({len(a)} events) "
              f"differs from the numpy model's ({len(b)}) at frame {last}")
        n_events = len(a)
    check(n_events > 0, f"no DVS event from frame {k} on")
    print(f"native DVS simulator: g++ build {build_ms:.0f} ms; its stream "
          f"equals the numpy model's on frames {k}-{last} ({n_events} events "
          f"at the last, deterministic)")

    # each part timed on the host clock, on the same model and chain
    _, _, params = load_trained_model(model, -1, dev)
    info = read_colmap_scene(wide_src)
    cams, _ = interpolated_cameras(info.train_cameras, EVENT_STEPS, WIDTH,
                                   HEIGHT, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        _render_view(params, cams[0], 3, bg, "tiled")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = [_render_view(params, c, 3, bg, "tiled") for c in cams]
        torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    host, copy_ms = timed(lambda: [np.clip(i.cpu().numpy(), 0, 1) for i in imgs])
    pngs = os.path.join(root, "png_timed")
    os.makedirs(pngs)
    _, png_ms = timed(lambda: [save_image(os.path.join(pngs, f"{i:05d}.png"), f)
                               for i, f in enumerate(host)])
    lums, lum_ms = timed(lambda: [rgb_to_luminance(f) for f in host])
    update_ms, update_events = {}, {}
    for name, cls in (("numpy", DvsSimulator), ("native", native.NativeDvsSimulator)):
        sim = cls(WIDTH, HEIGHT, DvsParams(), seed=0)
        sim.disable_noise()
        sim.init_image(lums[0])
        runs = [timed(lambda f=f: len(sim.update(f, EVENT_DT))) for f in lums[1:]]
        update_ms[name] = float(np.median([ms for _, ms in runs]))
        update_events[name] = sum(n for n, _ in runs)
    check(update_events["numpy"] == len(t), f"the numpy model on the same "
          f"frames gave {update_events['numpy']} events, cli.render {len(t)}")
    buf = EventBuffer.from_arrays(t, x, y, p)
    _, dat_ms = timed(lambda: save_event_result(buf, os.path.join(root, "dat_timed"),
                                                WIDTH, HEIGHT))

    def frames_on_card():
        frames = generate_event_frames(buf, WIDTH, HEIGHT, window, device=dev)
        torch.cuda.synchronize()
        return frames

    frames, frames_ms = timed(frames_on_card)
    check(len(frames) == n_frames, "generate_event_frames frame count")
    n = len(cams)
    print(f"event synthesis parts, host clock, {WIDTH}x{HEIGHT}: render "
          f"{render_ms:.2f} ms per view ({n} views); host copy "
          f"{copy_ms / n:.2f} ms per frame; PNG write {png_ms / n:.1f} ms per "
          f"frame; luminance {lum_ms / n:.2f} ms per "
          f"frame; DVS update median {update_ms['numpy']:.1f} ms per frame "
          f"(numpy model, {update_events['numpy']} events) and "
          f"{update_ms['native']:.1f} ms (native, {update_events['native']} "
          f"events), {n - 1} frames each; {len(frames)} frames on the card "
          f"{frames_ms:.1f} ms ({len(t)} events, PNGs not written); raw.dat "
          f"write {dat_ms:.1f} ms; {smi}")

    # cli.generate_dataset: the stream to frames, and the chain's renders
    # (the PNGs of cli.render --event) to a simulated stream and its frames
    gen = os.path.join(root, "generated")
    rc, _, log = run_cli(generate_main, [
        "--events", os.path.join(out, "raw.dat"), "--delta_t", str(window),
        "-o", os.path.join(gen, "from_events"), "--device", DEVICE])
    check(rc == 0, "cli.generate_dataset --events failed")
    n_gen = len(os.listdir(os.path.join(gen, "from_events")))
    check(n_gen == n_frames, f"generate_dataset --events wrote {n_gen} frames, "
          f"not {n_frames}")
    t0 = time.perf_counter()
    rc, _, log = run_cli(generate_main, [
        "--images", out, "--dt", str(int(EVENT_DT)), "-o",
        os.path.join(gen, "from_images"), "--device", DEVICE])
    images_s = time.perf_counter() - t0
    check(rc == 0, "cli.generate_dataset --images failed")
    tg, xg, yg, _ = load_dat_events(os.path.join(gen, "from_images", "raw.dat"))
    n_img = len(os.listdir(os.path.join(gen, "from_images", "images_event")))
    check(len(tg) > 0 and int(xg.max()) < WIDTH and int(yg.max()) < HEIGHT
          and n_img > 0, "cli.generate_dataset --images: empty or bad stream")
    print(f"cli.generate_dataset: --events {n_gen} frames; --images "
          f"{renders} renders -> {len(tg)} events, {n_img} frames in "
          f"{images_s:.2f} s wall; {smi}")


def loop_run(loop, state, data, cfg, mode, extent, *extra):
    """One training loop run with every launch count at 0 before it:
    (result, launch counts, host-clock ms of each step, peak device bytes).
    A step's time runs from the previous step's metrics to its own, so
    the densify after step 3 falls into step 4's."""
    import torch

    from event3dgs_tpu_torch.train.loop import TrainCallbacks

    stamps = []

    def on_metrics(it, metrics):
        if "loss" in metrics:
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = count_launches(lambda: loop(
        state, data, cfg, mode, extent, *extra,
        callbacks=TrainCallbacks(on_metrics=on_metrics, log_every=1)))
    step_ms = np.diff([t0] + stamps) * 1e3
    return res, launches, step_ms, torch.cuda.max_memory_allocated()


def sharded_path(root: str, dev):
    """Phase 11 on phase 6's 1080p COLMAP scene: ``train_loop_sharded`` at
    mesh 1 × 1 (exact) through ``init_distributed`` at world size 1 with
    NCCL, against ``train_loop`` on the same state and views; then
    ``synthesize_scene`` at 1080p through the kernels.  Returns the sharded
    run's launch counts."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from event3dgs_tpu_torch.cli.common import (
        config_from_args,
        load_scene_and_state,
        mode_from_config,
    )
    from event3dgs_tpu_torch.cli.train import build_parser
    from event3dgs_tpu_torch.data.colmap import read_model
    from event3dgs_tpu_torch.parallel.distributed import init_distributed, make_global_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from event3dgs_tpu_torch.tools.make_scene import synthesize_scene
    from event3dgs_tpu_torch.train.loop import measure_instance_cap, train_loop
    from event3dgs_tpu_torch.train.loop_sharded import train_loop_sharded
    from event3dgs_tpu_torch.train.step import make_train_step

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    info = init_distributed(f"localhost:{port}", 1, 0, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and info.world_size == 1,
              f"phase 11: backend {dist.get_backend()}, world {info.world_size}")
        mesh = make_global_mesh(1, 1)
        args = build_parser().parse_args([
            "-s", os.path.join(root, "colmap"), "--gray", "--event", "-r", "1",
            "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "2",
            "--densification_interval", "3", "--densify_grad_threshold", "0",
            "--device", DEVICE])
        cfg = config_from_args(args)
        mode = mode_from_config(cfg)
        _, data, state, extent = load_scene_and_state(cfg, dev)

        plain, p_launches, p_ms, p_peak = loop_run(
            train_loop, state, data, cfg, mode, extent)
        sharded, s_launches, s_ms, s_peak = loop_run(
            train_loop_sharded, state, data, cfg, mode, extent, mesh)
        for what, launches in (("train_loop", p_launches),
                               ("train_loop_sharded", s_launches)):
            check_launches(f"{what}, {TRAIN_ITERS} event steps", launches,
                           3 * TRAIN_ITERS, 3 * TRAIN_ITERS,
                           steps=TRAIN_ITERS, shared=what == "train_loop")
        hp, hs = plain.history, sharded.history
        check(len(hs) == len(hp) == TRAIN_ITERS and all(
            math.isfinite(b) and abs(a - b) <= 1e-5 * abs(b) for a, b in zip(hs, hp)),
            f"the sharded loop's losses {hs} differ from train_loop's {hp}")
        check(int(sharded.state.params.alive.sum())
              == int(plain.state.params.alive.sum()) > N_GAUSSIANS,
              "the sharded loop's densify differs from train_loop's")
        print(f"phase 11, mesh {mesh.shape} on NCCL: losses {hs} (train_loop "
              f"{hp}); max rel diff "
              f"{max(abs(a - b) / abs(b) for a, b in zip(hs, hp)):.3e}")
        for what, ms, peak in (("train_loop", p_ms, p_peak),
                               ("train_loop_sharded", s_ms, s_peak)):
            print(f"  {what}: host ms per step {[round(float(x), 3) for x in ms]} "
                  f"(median {float(np.median(ms)):.3f}, steps 2-{TRAIN_ITERS}"
                  f" median {float(np.median(ms[1:])):.3f}); peak "
                  f"{peak / 2**20:.1f} MiB")
        print(f"  launches: train_loop {p_launches}; train_loop_sharded "
              f"{s_launches}")

        # one event step of each at the trained state, in turns (plain,
        # sharded, sharded, plain), STEP_TURN steps timed one by one each
        st = plain.state
        icap = measure_instance_cap(st.params, data.cameras)
        kw = dict(max_sh_degree=st.max_sh_degree, rasterizer="tiled",
                  spatial_lr_scale=st.spatial_lr_scale, instance_cap=icap)
        steps = {
            "train_step": (make_train_step(mode, cfg.optimization, cfg.event,
                                           **kw), st, (1, 1, 2)),
            "sharded step": (make_sharded_train_step(
                mode, cfg.optimization, cfg.event, mesh, **kw),
                shard_train_state(st, mesh), ([1], [1], [2])),
        }
        bg = torch.zeros(3, device=dev)
        times = {k: [] for k in steps}
        peaks = {}
        for name in ("train_step", "sharded step", "sharded step", "train_step"):
            fn, state_in, idx = steps[name]
            fn(state_in, data, *idx, bg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(STEP_TURN):
                t0 = time.perf_counter()
                fn(state_in, data, *idx, bg)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = torch.cuda.max_memory_allocated()
        for name, ts in times.items():
            p10, p50, p90 = np.percentile(ts, [10, 50, 90])
            print(f"  {name} at {int(st.params.alive.sum())} alive (capacity "
                  f"{st.params.capacity}): host ms median {p50:.3f} (p10 "
                  f"{p10:.3f}, p90 {p90:.3f}) over {len(ts)} steps; peak "
                  f"{peaks[name] / 2**20:.1f} MiB")

        # NCCL's device time inside one more sharded run (profiler on),
        # and the host time spent inside its collectives' calls
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_loop_sharded(state, data, cfg, mode, extent, mesh)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        nccl, total, n_kernels, host = {}, 0.0, 0, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                total += us / 1e3
                n_kernels += e.count
                if "nccl" in e.key.lower():
                    nccl[e.key[:60]] = (us / 1e3, e.count)
            elif (e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith(("c10d::", "nccl:"))):
                host[e.key[:40]] = (e.cpu_time_total / 1e3, e.count)
        nccl_ms = sum(v[0] for v in nccl.values())
        print(f"  profiled sharded run: {wall_ms:.1f} ms host clock, device "
              f"busy {total:.3f} ms over {n_kernels} device kernels; NCCL "
              f"{nccl_ms:.4f} ms over {sum(v[1] for v in nccl.values())} "
              f"kernels ({100 * nccl_ms / max(total, 1e-9):.2f}%): "
              + ", ".join(f"{k} {v[0]:.4f} ms x{v[1]}" for k, v in nccl.items()))
        print("  host ms inside the collectives' calls (profiler on): "
              + ", ".join(f"{k} {v[0]:.3f} x{v[1]}" for k, v in
                          sorted(host.items(), key=lambda kv: -kv[1][0])))
    finally:
        dist.destroy_process_group()

    out = os.path.join(root, "synth1080")
    t0 = time.perf_counter()
    meta, launches = count_launches(lambda: synthesize_scene(
        out, n_views=TRAIN_VIEWS, width=WIDTH, height=HEIGHT,
        n_gaussians=N_GAUSSIANS, scale_min=0.004, scale_max=0.015,
        rasterizer="tiled", device=DEVICE))
    check_render_launches("synthesize_scene", launches, TRAIN_VIEWS)
    for folder in ("images", "images_event", "renders"):
        check(len(os.listdir(os.path.join(out, folder))) == TRAIN_VIEWS,
              f"synthesize_scene: missing {folder}/")
    _, images, (xyz, _, _) = read_model(os.path.join(out, "sparse", "0"))
    check(len(images) == TRAIN_VIEWS and xyz.shape == (N_GAUSSIANS, 3),
          "synthesize_scene: COLMAP model")
    print(f"synthesize_scene: {TRAIN_VIEWS} views at {WIDTH}x{HEIGHT}, "
          f"{N_GAUSSIANS} Gaussians, in {time.perf_counter() - t0:.2f} s; "
          f"launches {launches}; {card()}")
    return s_launches


def sh_degree_4(dev):
    """An SH degree 4 render of bench.py's scene (view 0, small random
    degree-4 coefficients from the seed): the kernel path against the
    all-plain path, at phase 4's tolerance."""
    import torch

    from event3dgs_tpu_torch.core import make_camera
    from event3dgs_tpu_torch.core.sh import rgb_to_sh
    from event3dgs_tpu_torch.models import activated, params_from_numpy
    from event3dgs_tpu_torch.ops.render import render

    rng = np.random.default_rng(0)
    means, scales, rots, opac, colors = bench_scene(rng)
    params = params_from_numpy(dict(
        xyz=means, features_dc=rgb_to_sh(colors)[:, None, :],
        features_rest=rng.normal(0.0, 0.05, (N_GAUSSIANS, 24, 3)),
        scaling=np.log(scales), rotation=rots,
        opacity=np.log(opac / (1 - opac))[:, None],
        alive=np.ones(N_GAUSSIANS, bool)), device=dev)
    act = activated(params)
    cam = make_camera(np.eye(3), np.zeros(3), 1.2, 0.75, WIDTH, HEIGHT, device=dev)
    view = (act.means3d, act.features, act.opacities, act.scales, act.rotations,
            cam, torch.zeros(3, device=dev))
    with torch.no_grad():
        kern, launches = count_launches(
            lambda: render(*view, sh_degree=4, rasterizer="tiled"))
        plain = render(*view, sh_degree=4, rasterizer="tiled", plain=True).image
        deg3 = render(*view, sh_degree=3, rasterizer="tiled").image
    err = (kern.image - plain).abs().max().item()
    check(bool(torch.isfinite(kern.image).all()), "SH degree 4: non-finite image")
    check_render_launches("SH degree 4 render", launches, 1)
    check(err <= 1e-5, f"SH degree 4: kernel path vs plain path {err}")
    moved = (kern.image - deg3).abs().max().item()
    check(moved > 1e-3, f"SH degree 4 render equals degree 3 ({moved})")
    print(f"SH degree 4, view 0 of bench.py's scene: kernel path vs all-plain "
          f"path max |diff| {err:.3g}; degree 4 vs degree 3 max |diff| "
          f"{moved:.3g}")


def bench_state(dev):
    """bench.py's `bench_train_step` set-up: state, data, instance cap."""
    from event3dgs_tpu_torch.tools import kernel_timing

    return kernel_timing.bench_state(dev, N_GAUSSIANS, WIDTH, HEIGHT)


def train_kernels(dev):
    """Phases 7-8 at bench.py's training configuration.  Returns (errors,
    rows of the backward kernels, Adam's and the loss kernels', launches
    per step)."""
    import torch

    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.tools.kernel_timing import (
        adam_bound,
        fused_adam_call,
        k3_inputs,
    )
    from event3dgs_tpu_torch.train.step import make_loss_and_grads, make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    state, data, icap = bench_state(dev)
    opt, ev = OptimizationConfig(), EventConfig()
    bg = torch.zeros(3, device=dev)
    idx = (1, 1, 2)  # bench.py's views: main 1, event pair 1 → 2
    print(f"bench training state: {N_GAUSSIANS} Gaussians, 4 views at "
          f"{WIDTH}x{HEIGHT}, measured instance cap {icap}")

    # 7. every kernel of the main view's path against its plain version;
    # the preprocess over the step's three views, all 16 coefficients on
    pre = step_preprocess_check("phase 7, the step's three views", state,
                                data, idx)
    v = view_kernels("main view", pre.proj, pre.colors,
                     activated(state.params).opacities, icap, dev,
                     backward=True)
    v.errs.update(pre.errs)
    v.calls.update(pre.calls)
    v.bounds.update(pre.bounds)

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
    # the Adam kernel at the next step's update of that state (count 1,
    # moments set)
    adam = adam_groups(s1, data, idx, bg, icap, 2)
    adam_err, *adam_calls = adam_check("phase 7, the step after one", adam)
    # the loss kernels on the step's three 1080p renders
    loss_errs, loss_calls, loss_bounds = loss_check(
        "phase 7, the step's renders", *loss_views(state, data, idx, icap))
    # the SSIM loss kernels on the rgb and gray steps' 1080p render
    photo_errs, (photo_calls, photo_bounds), gray = photometric_check(
        "phase 7, the main view's render",
        *photometric_views(state, data, idx[0], icap))

    # 8. timing: bench.py's event step ---------------------------------------
    with counting_packs() as packs, counting_composes() as composes:
        (st, _), per_step = count_launches(lambda: step(state, data, *idx,
                                                        bg))
    check_launches("one event step", per_step, 3, 3, steps=1)
    check(not packs, f"one event step called pack_features {len(packs)} "
          "times")
    check(not composes, f"one event step called ops.render.composed "
          f"{len(composes)} times")
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
    graphed_step("phase 8, bench.py's state", st, data, icap)
    # the rgb and gray steps, eager and graphed: the SSIM loss kernels on
    # the render's partials, no composition and no convolution
    for mode in ("rgb", "gray"):
        mstep = make_train_step(mode, opt, ev, spatial_lr_scale=3.0,
                                rasterizer="tiled", instance_cap=icap)
        with counting_composes() as composes, counting_convs() as convs:
            (_, m), launches = count_launches(lambda: mstep(st, data, *idx,
                                                            bg))
        check_launches(f"one {mode} step", launches, 1, 1, steps=1,
                       event=False)
        check(not composes and not convs, f"one {mode} step called "
              f"ops.render.composed {len(composes)} and F.conv2d "
              f"{len(convs)} times")
        check(math.isfinite(float(m["loss"])), f"non-finite {mode} loss")
        print(f"one {mode} step (bench.py's state, view {idx[0]}): loss "
              f"{float(m['loss']):.6f}, l1 {float(m['l1']):.6f}, no "
              f"composed or F.conv2d call; launches {launches}")
        graphed_step(f"phase 8, bench.py's state, {mode} mode", st, data,
                     icap, mode)

    b, rows_k = v.bk, v.rows_k
    _, _, (gathered, lengths) = k3_inputs(b, rows_k)
    v.errs[ADAM] = adam_err
    v.bounds[ADAM] = adam_bound(adam_floats(adam))
    v.errs.update(loss_errs)
    v.bounds.update(loss_bounds)
    v.errs.update(photo_errs)
    v.bounds.update(photo_bounds)
    timings = {
        # over the step's three views: the rows of both preprocess kernels
        "preprocess_forward": (*v.calls["preprocess_forward"], None, 50),
        "preprocess_backward": (*v.calls["preprocess_backward"], None, 50),
        "K2 composite_backward": (*v.calls["K2 composite_backward"], None, 20),
        "K3 segment_sums": (
            *v.calls["K3 segment_sums"],
            lambda: torch.segment_reduce(gathered, "sum", lengths=lengths), 50),
        ADAM: (*adam_calls, fused_adam_call(adam), 50),
        # no single PyTorch call computes a loss: no yardstick
        **{k: (*loss_calls[k], None, 50) for k in LOSS},
        **{k: (*photo_calls[k], None, 50) for k in PHOTO},
    }
    meta = {
        "preprocess_forward": ("preprocess.cu", PREPROCESS_REPLACES),
        "preprocess_backward": ("preprocess.cu", PREPROCESS_REPLACES),
        "K2 composite_backward": ("rasterize_bwd.cu",
                                  "event3dgs_tpu/ops/rasterize_tiled.py:386"),
        "K3 segment_sums": ("segsum.cu", "event3dgs_tpu/ops/segscan.py:46"),
        ADAM: ("adam.cu", ADAM_REPLACES),
        **{k: ("loss.cu", LOSS_REPLACES) for k in LOSS},
        **{k: ("ssim.cu", PHOTO_REPLACES) for k in PHOTO},
    }
    errs = {k: v.errs[k] for k in timings}
    rows = kernel_rows(timings, v.bounds, meta, errs)
    occupancy_rows(rows, pre.occupancy)
    photometric_rows("phase 8", rows, gray)
    packed_cost("phase 8", rows["preprocess_forward"], pre)
    rows["K3 segment_sums"].update(k3_in_order("main view", b, rows_k))
    composite_report("K2 composite_backward", rows["K2 composite_backward"],
                     v.pairs, v.bounds["K2 composite_backward"][0],
                     "rasterize_bwd", "e3d_composite_backward_occupancy")
    densify_growth(st, data, idx, bg)
    return errs, rows, per_step


def densify_growth(state, data, idx, bg, mode="event", extent=3.0):
    """Densify the timed state with capacity growth (its 100k slots are all
    alive, so any candidate grows them), then one step of ``mode`` at a
    re-measured instance cap: every kernel launches once per render (3 in
    the event modes), the preprocess kernels and Adam once, and the loss is
    finite.  Threshold 0
    makes every alive Gaussian a candidate: the event pair's coverage is 1 on bench.py's
    random images, so the main view's gradient, the densify statistic, is
    exactly 0.  ``extent``: the scene extent and ``spatial_lr_scale``
    (bench.py's 3.0)."""
    import torch

    from event3dgs_tpu_torch.train.loop import densify_with_growth, measure_instance_cap
    from event3dgs_tpu_torch.train.step import make_densify_step, make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    dev = state.params.device
    capacity, alive = state.params.capacity, int(state.params.alive.sum())
    gen = torch.Generator().manual_seed(0)
    normals = lambda c: torch.randn((2, c, 3), generator=gen).to(dev)
    densify = make_densify_step(OptimizationConfig(densify_grad_threshold=0.0),
                                extent)
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
    step = make_train_step(mode, OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=extent, rasterizer="tiled",
                           instance_cap=icap)
    (after, metrics), launches = count_launches(
        lambda: step(grown, data, *idx, bg))
    renders = 3 if mode.startswith("event") else 1
    check_launches("the step after densify", launches, renders, renders,
                   steps=1, event=mode.startswith("event"))
    check(math.isfinite(float(metrics["loss"])), "non-finite loss after densify")
    for f in ("xyz", "scaling", "opacity"):
        check(bool(torch.isfinite(getattr(after.params, f)).all()),
              f"non-finite {f} after densify")
    print(f"densify with growth ({mode}): {alive} -> {alive_after} alive, capacity "
          f"{capacity} -> {grown.params.capacity}, {densify_ms:.1f} ms host "
          f"clock; next step at instance cap {icap}: launches {launches}, "
          f"loss {float(metrics['loss']):.6f}")


PROBE_REPLACES = {
    "K1": "experiments/tools_exp_kernel.py:59",
    "K4": "experiments/tools_r5_expandprobe.py:249",
    "dyngrid": "experiments/tools_exp_dyngrid.py:18",
}


def probe_path(dev):
    """Phase 12: ``tools/kernel_probes.py`` ``all`` at full size, with every
    probe build's launch count set to 0 before and read after; the checks
    on its outputs; one JSON row per K1 and K4 build and for the
    dynamic-grid kernel (``launches`` from the probes' run)."""
    import torch

    from event3dgs_tpu_torch.ops import expand, kernels
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools.kernel_timing import (
        K1_PAIR_OPS,
        bound_ms,
        composite_bytes,
        cuda_ms,
        expansion_bytes,
        pair_ops,
    )
    from event3dgs_tpu_torch.train.step import make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    builds = kp.variants()
    for v in builds:
        v.launches = 0
    for v in kp.SSIM_VARIANTS.values():
        v.launches = dict.fromkeys(v.launches, 0)
    kp.dyngrid_kernel.launches = 0
    for name in kp.OFFSETS_LAUNCHES:
        kp.OFFSETS_LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probes = kp.run_probes(kp.MODES, dev, N_GAUSSIANS, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = {v.label: v.launches for v in builds}
    launches["dyngrid"] = kp.dyngrid_kernel.launches
    for v in kp.SSIM_VARIANTS.values():
        for kernel, n in v.launches.items():
            launches[f"{v.label} {kernel}"] = n
    for name, n in kp.OFFSETS_LAUNCHES.items():
        launches[f"depth order {name}"] = n
    print(f"kernel_probes all: {probe_s:.1f} s; launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"phase 12: {k} was not launched")
    rec = probes.records

    # K1's base is the shipping library, and it and clock equal K1
    base = kp.K1_VARIANTS["base"]
    check(kernels.library_path(base.source, base.defines)
          == kernels.library_path("rasterize_fwd"),
          "the probes' K1 base is not the shipping library")
    out = probes.outputs["k1"]
    for name in ("base", "clock"):
        for what, got, want in zip(("rgb", "log T", "stop"), out[name],
                                   out["shipping"]):
            check(torch.equal(got, want),
                  f"the probes' K1 {name}: {what} differs from the shipping K1")
    # K2's base is the shipping library and equals it; it and the
    # log-space build match the plain version at both views, bit for bit
    # from run to run
    base = kp.K2_VARIANTS["base"]
    check(kernels.library_path(base.source, base.defines)
          == kernels.library_path("rasterize_bwd"),
          "the probes' K2 base is not the shipping library")
    for r in rec["k2"]["variants"]:
        if r["variant"] == "base":
            check(r["max_err_vs_shipping"] == 0.0, f"the probes' K2 base "
                  f"differs from the shipping K2 at the {r['view']} view")
        if "max_err_vs_plain" in r:
            check(r["max_err_vs_plain"] <= 1e-5 and r["rerun_equal"],
                  f"the probes' K2 {r['variant']} at the {r['view']} view: "
                  f"{r['max_err_vs_plain']:.3g} of the plain rows' max, "
                  f"rerun equal {r['rerun_equal']}")
    # the SSIM builds' base is the shipping library and equals it
    base = kp.SSIM_VARIANTS["base"]
    check(kernels.library_path(base.source, base.defines)
          == kernels.library_path("ssim"),
          "the probes' SSIM base is not the shipping library")
    for mode, out in probes.outputs["ssim"].items():
        (fwd, grads), (fwd_b, grads_b) = out["shipping"], out["base"]
        for got, want in zip([*fwd_b, *grads_b], [*fwd, *grads]):
            check(bits_differ(got, want) == 0, f"the probes' SSIM base "
                  f"({mode}) differs from the shipping SSIM kernels")
    # the depth order's base build is the shipping library and equals the
    # shipping call; the call equals its plain versions at both sizes
    check(kernels.library_path("depth_sort", kp.OFFSETS_VARIANTS["base"][0])
          == kernels.library_path("depth_sort"),
          "the probes' depth order base is not the shipping library")
    for r in rec["offsets"]["rows"]:
        if r["call"] == "depth_order":
            check(r["equal_to_plain"], f"phase 12: the depth order at "
                  f"{r['gaussians']} Gaussians differs from its plain version")
        if r["call"] == "build base":
            check(r["equal_to_shipping"], f"phase 12: the depth order's base "
                  f"build at {r['gaussians']} differs from the shipping call")
    # the dynamic grid in a CUDA graph
    dg = rec["dyngrid"]
    for n, want in dg["expected"].items():
        check(dg["replays"][n] == want and dg["equal_to_plain"][n],
              f"dyngrid: the replay at n = {n} gave {dg['replays'][n]}, "
              f"not {want} and the plain version's")
        check(dg["order_sensitive"][n], f"dyngrid: the seeded sum of {n} "
              "blocks does not depend on their order")
    for n, equal in dg["seeded_equal_to_plain"].items():
        check(equal, f"dyngrid: the replay at n = {n} over the seeded input "
              "differs from the plain version")
    check(dg["max_abs_err"] == 0.0, f"dyngrid: {dg['max_abs_err']} from the "
          "plain version")
    # stop statistics of K1's stop against the plain K1's at view 0
    rv = probes.render_view()
    _, _, stop_p, pairs = rt._composite_plain(*rv.k1_args)
    stop_k = probes.outputs["stops"]["render_stop"]
    check(torch.equal(stop_k, stop_p), "phase 12: K1's stop differs from the "
          "plain K1's at view 0")
    plain_stats = kp.stop_statistics(stop_p, rv.k1_args[2], WIDTH, HEIGHT)
    check(plain_stats == rec["stops"]["render"], "stop_statistics of K1's "
          "stop differ from those of the plain K1's")
    # stage 7 is the train step
    tv = probes.train_view()
    bg = torch.zeros(3, device=dev)
    stage7 = kp.event_step_stages(tv.state, tv.data, kp.TRAIN_IDX, bg,
                                  tv.cap)[-1][1]
    step = make_train_step("event", OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=3.0, rasterizer="tiled",
                           instance_cap=tv.cap)
    torch.use_deterministic_algorithms(True)
    try:
        s7, m7 = stage7()
        st, _ = step(tv.state, tv.data, *kp.TRAIN_IDX, bg)
    finally:
        torch.use_deterministic_algorithms(False)
    check(math.isfinite(float(m7["loss"])), "stage 7: non-finite loss")
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        check(bool(torch.isfinite(getattr(s7.params, f)).all()),
              f"stage 7: non-finite {f}")
        check(torch.equal(getattr(s7.params, f), getattr(st.params, f)),
              f"stage 7: {f} differs from train_step's")
    print("phase 12: K1 base (the shipping library) and clock bit-equal to the "
          "shipping K1; SSIM base bit-equal to the shipping SSIM kernels "
          "in rgb and gray mode; dyngrid replays 3072 and 7168, and over the seeded "
          f"input at counts {list(dg['seeded_equal_to_plain'])}, bit-equal "
          "to the plain version; stop statistics equal on the plain K1's stop; stage 7's "
          f"parameters equal train_step's; {card()}")
    print_probe_tables(rec)

    # one JSON row per build: plain and bound are those of the function
    # the build replaces (K1 or K4 at the render view)
    nt = rv.k1_args[2].shape[0]
    k1_bound = bound_ms(composite_bytes(rv.live, N_GAUSSIANS, nt, WIDTH,
                                        HEIGHT),
                        pair_ops(pairs.tolist(), K1_PAIR_OPS))
    plain_ms = {"K1": cuda_ms(lambda: rt.composite_forward_plain(*rv.k1_args),
                              2, warmup=1),
                "K4": cuda_ms(lambda: expand.expand_instances_plain(
                    *rv.k4_args, True), 2, warmup=1)}
    rows = {}
    for kernel, table in (("K1", kp.K1_VARIANTS), ("K4", kp.K4_VARIANTS)):
        for row in rec[kernel.lower()]["variants"]:
            v = table[row["variant"]]
            bound = k1_bound if kernel == "K1" else bound_ms(
                expansion_bytes(rv.k4_args[2], rv.k4_args[5], nt,
                                v.count_rows), (0, 0))
            name = f"{kernel} probe {v.name}"
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"event3dgs_tpu_torch/csrc/{v.source}.cu",
                "replaces": PROBE_REPLACES[kernel],
                "launches": v.launches,
                # against the shipping kernel on the same inputs (an
                # ablated build has no plain version and differs by design)
                "max_abs_err": row["max_abs_err_vs_shipping"],
                "ms": row["event_ms"], "device_ms": row["device_ms"],
                "graph_ms": row["graph_ms"],
                "plain_ms": plain_ms[kernel], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "defines": row["defines"], "timing_only": v.timing_only,
            }
    rows.update(ssim_probe_rows(rec["ssim"]["variants"]))
    rows.update(depth_probe_rows(probes))
    rows["dyngrid probe"] = {
        "name": "dyngrid probe", "route": "cuda",
        "source": "event3dgs_tpu_torch/csrc/probes.cu",
        "replaces": PROBE_REPLACES["dyngrid"],
        "launches": kp.dyngrid_kernel.launches,
        "max_abs_err": dg["max_abs_err"],
        "ms": dg["replay_ms"], "plain_ms": dg["plain_ms"],
        "bound_ms": dg["bound_ms"], "bound_by": "bytes",
        "library_ms": dg["library_ms"],
    }
    return rows


def depth_probe_rows(probes):
    """Phase 12's JSON row per depth order build at the render view (the
    2M view's graph ms under ``large``): plain, bound and library are
    those of the shipping depth order there (``radix_order_plain``, its
    bytes, ``torch.argsort`` of the keys)."""
    from event3dgs_tpu_torch.ops import binning
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools.kernel_timing import cuda_ms

    table = probes.records["offsets"]["rows"]
    tables, cap, _ = probes.depth_tables(N_GAUSSIANS)
    plain_ms = cuda_ms(lambda: binning.radix_order_plain(tables, cap), 2,
                       warmup=1)
    binning.depth_order(tables, cap)  # clear: the plain version ran none
    rows = {}
    for name, (defines, _) in kp.OFFSETS_VARIANTS.items():
        r, large = (next(x for x in table if x["call"] == f"build {name}"
                         and x["gaussians"] == n)
                    for n in (N_GAUSSIANS, kp.OFFSETS_LARGE))
        call, lib = (next(x for x in table if x["call"] == c
                          and x["gaussians"] == N_GAUSSIANS)
                     for c in ("depth_order", "argsort"))
        rows[f"depth order probe {name}"] = {
            "name": f"depth order probe {name}", "route": "cuda",
            "source": "event3dgs_tpu_torch/csrc/depth_sort.cu",
            "replaces": "event3dgs_tpu/ops/binning.py:306",
            "launches": kp.OFFSETS_LAUNCHES[name],
            # against the shipping call on the same keys (an ablated build
            # has no plain version and differs by design)
            "max_abs_err": r["max_abs_err_vs_shipping"],
            "ms": r["event_ms"], "graph_ms": r["graph_ms"],
            "plain_ms": plain_ms, "bound_ms": call["bound_ms"],
            "bound_by": "bytes", "library_ms": lib["graph_ms"],
            "defines": list(defines), "timing_only": r["timing_only"],
            "large": {"gaussians": large["gaussians"],
                      "graph_ms": large["graph_ms"]},
        }
    return rows


def ssim_probe_rows(table):
    """Phase 12's JSON row per SSIM build and kernel (rgb mode, gray mode
    under ``gray``): plain and bound are those of the shipping kernel at
    the probe's 1080p operands."""
    import torch

    from event3dgs_tpu_torch.losses import modes
    from event3dgs_tpu_torch.tools import kernel_probes as kp
    from event3dgs_tpu_torch.tools.kernel_timing import (
        bound_ms,
        cuda_ms,
        photometric_bound,
    )

    render, gt, bg = kp.ssim_operands(HEIGHT, WIDTH, DEVICE)
    grad = torch.ones((), device=DEVICE)
    plain, bounds = {}, {}
    for gray in (False, True):
        maps = modes.photometric_loss_plain(render, gt, 0.2, gray, bg)[2]
        plain[gray] = {
            "forward": cuda_ms(lambda: modes.photometric_loss_plain(
                render, gt, 0.2, gray, bg), 2, warmup=1),
            "backward": cuda_ms(lambda: modes.photometric_loss_backward_plain(
                grad, render, gt, maps, 0.2, gray, bg), 2, warmup=1)}
        for kernel in ("forward", "backward"):
            bounds[gray, kernel] = bound_ms(*photometric_bound(
                WIDTH * HEIGHT, 1 if gray else 3, kernel == "backward"))
    rows = {}
    for r in table:
        if r["mode"] != "rgb":
            continue
        v, kernel = kp.SSIM_VARIANTS[r["variant"]], r["kernel"]
        gray = next(g for g in table if g["mode"] == "gray" and
                    (g["variant"], g["kernel"]) == (v.name, kernel))
        name = f"SSIM probe {v.name} {kernel}"
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "event3dgs_tpu_torch/csrc/ssim.cu",
            "replaces": PHOTO_REPLACES, "launches": v.launches[kernel],
            "max_abs_err": max(r["max_abs_err_vs_shipping"],
                               gray["max_abs_err_vs_shipping"]),
            "ms": r["event_ms"], "graph_ms": r["graph_ms"],
            "plain_ms": plain[False][kernel],
            "bound_ms": bounds[False, kernel][0],
            "bound_by": bounds[False, kernel][1], "library_ms": None,
            "defines": r["defines"], "timing_only": v.timing_only,
            "gray": {"graph_ms": gray["graph_ms"],
                     "plain_ms": plain[True][kernel],
                     "bound_ms": bounds[True, kernel][0],
                     "bound_by": bounds[True, kernel][1]},
        }
    return rows


def print_probe_tables(rec):
    """Phase 12's tables: the stages, the K1 and K4 builds, K1's stop
    statistics, the relaunched kernels."""
    print("stage                                device us  kernels  other  "
          "event ms   host ms | added: device us  kernels  host ms")
    for r in rec["stages"]["stages"]:
        a = r.get("added", {})
        print(f"{r['stage']} {r['name']:34s} {r['device_us']:10.1f} "
              f"{r['kernels']:8.0f} {r['memsets_copies']:6.0f} "
              f"{r['event_ms']:9.3f} {r['host_ms']:9.3f} | "
              f"{a.get('device_us', r['device_us']):10.1f} "
              f"{a.get('kernels', r['kernels']):8.0f} "
              f"{a.get('host_ms', r['host_ms']):8.3f}")
    for kernel in ("k1", "k4"):
        print(f"{kernel.upper()} build  device ms (seen)  event ms  graph ms  "
              "regs  spill st/ld  blocks/SM  vs base (graph)   pairs evaluated")
        for r in rec[kernel]["variants"]:
            vs = (f"{r['vs_base_ms']:+.4f} ({100 * r['vs_base_share']:.1f}%)"
                  if "vs_base_ms" in r else "-")
            print(f"{r['variant']:9s} {r['device_ms']:9.4f} "
                  f"({r['profiled_per_call']:.2f}) {r['event_ms']:9.4f} "
                  f"{r['graph_ms']:9.4f} {r['registers']:5d} "
                  f"{r['spill_stores']:5d}/{r['spill_loads']:<5d} "
                  f"{r['blocks_per_sm']:9d}  {vs:18s} "
                  f"{r.get('evaluated_pairs', '-')}")
            if "imbalance" in r:
                print(f"  clock: {json.dumps(r['imbalance'])}")
    print("K2 build  view   graph ms  event ms  regs  spill st/ld  blocks/SM  "
          "vs base (graph)   of the plain rows' max")
    for r in rec["k2"]["variants"]:
        vs = (f"{r['vs_base_ms']:+.4f} ({100 * r['vs_base_share']:.1f}%)"
              if "vs_base_ms" in r else "-")
        print(f"{r['variant']:9s} {r['view']:5s} {r['graph_ms']:9.4f} "
              f"{r['event_ms']:9.4f} {r['registers']:5d} "
              f"{r['spill_stores']:5d}/{r['spill_loads']:<5d} "
              f"{r['blocks_per_sm']:9d}  {vs:18s} "
              f"{r.get('max_err_vs_plain', '-')}")
    print("K2 in turns: " + ", ".join(f"{t['view']} {t['variant']} "
                                      f"{t['graph_ms']:.4f}"
                                      for t in rec["k2"]["turns"]))
    for view in ("render", "train"):
        print(f"K1 stops, {view} view: {json.dumps(rec['stops'][view])}")
    print(f"stop_statistics at the render view: "
          f"{rec['stops']['statistics_ms']:.3f} ms (CUDA events)")
    print("SSIM build  mode kernel    graph ms  event ms  regs  spill  "
          "smem B  blocks/SM  vs base (graph)")
    for r in rec["ssim"]["variants"]:
        vs = (f"{r['vs_base_ms']:+.4f} ({100 * r['vs_base_share']:.1f}%)"
              if "vs_base_ms" in r else "-")
        print(f"{r['variant']:10s} {r['mode']:4s} {r['kernel']:8s} "
              f"{r['graph_ms']:9.4f} {r['event_ms']:9.4f} "
              f"{r['registers']:5d} {r['spill_stores']:6d} "
              f"{r['shared_bytes']:7d} "
              f"{r['blocks_per_sm']:9d}  {vs}")
    print("depth order call  gaussians  graph ms  event ms  bound ms  "
          "x bound  vs base (graph)  passes")
    for r in rec["offsets"]["rows"]:
        bound = f"{r['bound_ms']:9.4f} {r['over_bound']:8.2f}" \
            if "bound_ms" in r else f"{'-':>9s} {'-':>8s}"
        vs = f"{r['vs_base_ms']:+.4f}" if "vs_base_ms" in r else "-"
        print(f"{r['call']:20s} {r['gaussians']:9d} {r['graph_ms']:9.4f} "
              f"{r.get('event_ms', float('nan')):9.4f} {bound}  {vs:15s} "
              f"{r.get('passes', '')}")
    print(f"depth order kernels (-Xptxas -v): "
          f"{json.dumps(rec['offsets']['registers'])}")
    for r in rec["relaunch"]["kernels"]:
        print(f"relaunch {r['kernel']}: device {r['device_ms']:.4f} ms "
              f"({r['profiled_per_call']:.2f} launches seen per call), event "
              f"{r['event_ms']:.4f} ms, graph {r['graph_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['over_bound']:.2f}x "
              "in graph time")


@contextlib.contextmanager
def fused_runs():
    """Every ``FusedSteps`` the training loops inside make, in order: their
    capture times and graph replays (the kernels' launch counts see only
    the warm-up steps and the captures)."""
    from event3dgs_tpu_torch.train.fused import GraphCache

    made, get = [], GraphCache.get

    def watched(self, *args):
        entry = get(self, *args)
        if not made or made[-1] is not entry:
            made.append(entry)
        return entry

    GraphCache.get = watched
    try:
        yield made
    finally:
        GraphCache.get = get


def fused_loop(state, data, cfg, iters):
    """``train_loop`` in event mode (extent 3.0, bench.py's
    spatial_lr_scale) with every launch count at 0 before it: (result,
    launches, host clock at each log tick, on_metrics events, peak device
    bytes, the fused steps it made)."""
    import torch

    from event3dgs_tpu_torch.train.loop import TrainCallbacks, train_loop

    stamps, events = {}, []

    def on_metrics(it, metrics):
        events.append((it, metrics))
        if "loss" in metrics:
            stamps[it] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fused_runs() as made:
        res, launches = count_launches(lambda: train_loop(
            state, data, cfg, "event", 3.0, iterations=iters,
            callbacks=TrainCallbacks(on_metrics=on_metrics,
                                     log_every=FUSED_LOG)))
    return (res, launches, stamps, events, torch.cuda.max_memory_allocated(),
            made)


def check_same_run(what, eager, fused):
    """The fused loop's losses against the eager loop's (the JAX fused-loop
    test's rtol 2e-5 / atol 1e-6) and its parameters (atol 3e-3): the
    largest differences."""
    h1, hf = np.asarray(eager.history), np.asarray(fused.history)
    check(len(h1) == len(hf) and np.isfinite(h1).all()
          and np.isfinite(hf).all(), f"{what}: losses missing or not finite")
    loss_err = float(np.abs(hf - h1).max())
    check(np.allclose(hf, h1, rtol=2e-5, atol=1e-6),
          f"{what}: losses differ by {loss_err:.3g}")
    check(fused.state.params.capacity == eager.state.params.capacity,
          f"{what}: capacities differ")
    param_err = max(
        (getattr(fused.state.params, f) - getattr(eager.state.params, f))
        .abs().max().item()
        for f in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity"))
    check(param_err <= 3e-3, f"{what}: parameters differ by {param_err:.3g}")
    return loss_err, param_err


def fused_path(root: str, dev):
    """Phase 13: ``pipeline.fused_steps`` (a CUDA graph of the event step,
    replayed once per step) against the per-step loop, at bench.py's
    training state with 8 views, through a densify with capacity growth,
    and through ``cli.train --fused_steps 3`` on phase 6's scene."""
    import torch

    from event3dgs_tpu_torch.cli.train import main as train_main
    from event3dgs_tpu_torch.tools import kernel_timing
    from event3dgs_tpu_torch.train.fused import WARMUP_STEPS, FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import OptimizationConfig, TrainConfig

    smi = card()
    per_capture = 3 * (WARMUP_STEPS + 1)  # launches of each kernel
    state, data, icap = kernel_timing.bench_state(dev, N_GAUSSIANS, WIDTH,
                                                  HEIGHT, views=FUSED_VIEWS)
    print(f"phase 13: bench.py's training state with {FUSED_VIEWS} views "
          f"({N_GAUSSIANS} Gaussians, {WIDTH}x{HEIGHT}, instance cap {icap}), "
          f"{FUSED_ITERS} event iterations, log every {FUSED_LOG}")
    runs = {}
    for fused in (1, FUSED_STEPS):
        cfg = TrainConfig()
        cfg.pipeline.fused_steps = fused
        runs[fused] = fused_loop(state, data, cfg, FUSED_ITERS)
    (r1, n1, t1, _, peak1, _), (rf, nf, tf, ef, peakf, made) = (
        runs[1], runs[FUSED_STEPS])
    loss_err, param_err = check_same_run("fused_steps 10", r1, rf)
    check_launches("eager loop", n1, 3 * FUSED_ITERS, 3 * FUSED_ITERS,
                   steps=FUSED_ITERS)
    captures = [m["graph_capture_ms"] for _, m in ef if "graph_capture_ms" in m]
    check(len(captures) == len(made) == 1, f"{len(captures)} graphs captured")
    # warm-up and capture only
    check_launches("fused loop", nf, per_capture, per_capture,
                   steps=WARMUP_STEPS + 1)
    replays = sum(e.replays for e in made)
    check(replays == FUSED_ITERS, f"{replays} replays for {FUSED_ITERS} steps")
    print(f"phase 13: losses of fused_steps {FUSED_STEPS} vs 1 max |diff| "
          f"{loss_err:.3g} (0 expected), final parameters max |diff| "
          f"{param_err:.3g}; launches eager {n1}; fused {nf} (warm-up and "
          f"capture), {replays} graph replays")

    # host clock per step over iterations 11-60 (the first window holds the
    # capture and, in both loops, the first steps' warm-up)
    window = FUSED_ITERS - FUSED_LOG
    ms = {f: (t[FUSED_ITERS] - t[FUSED_LOG]) / window * 1e3
          for f, t in ((1, t1), (FUSED_STEPS, tf))}
    pix = {f: 3 * WIDTH * HEIGHT / (v / 1e3) for f, v in ms.items()}
    print(f"phase 13: graph capture {captures[0]:.1f} ms (warm-up "
          f"{WARMUP_STEPS} steps + capture); host clock per step over "
          f"iterations {FUSED_LOG + 1}-{FUSED_ITERS}: eager {ms[1]:.3f} ms "
          f"({pix[1]:.1f} pixels/s), fused_steps {FUSED_STEPS} "
          f"{ms[FUSED_STEPS]:.3f} ms ({pix[FUSED_STEPS]:.1f} pixels/s), "
          f"{ms[1] / ms[FUSED_STEPS]:.2f}x; peak memory eager "
          f"{peak1 / 2**20:.1f} MiB, fused {peakf / 2**20:.1f} MiB; {smi}")

    # device time per replayed step: CUDA events around 10 replays, 5 times
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    cfg = TrainConfig()
    step = GraphTrainStep("event", cfg.optimization, cfg.event,
                          spatial_lr_scale=3.0, rasterizer="tiled",
                          instance_cap=icap)
    runner = FusedSteps(step, rf.state, data, FUSED_STEPS)
    reserved = torch.cuda.memory_reserved() - reserved
    runner.table.copy_(torch.from_numpy(np.stack([
        step.row(FUSED_ITERS + 1 + j, (2 + j % 3, 2 + j % 3, 3 + j % 3),
                 np.zeros(3)) for j in range(FUSED_STEPS)])))
    replay_ms = []
    for _ in range(5):
        runner.cursor.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FUSED_STEPS):
            runner.graph.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end) / FUSED_STEPS)
    check(bool(torch.isfinite(runner.slots.history).all()),
          "non-finite loss in a timed replay")
    # what one captured step holds: the Adam kernel, each loss kernel and
    # each preprocess kernel (the three views in one launch) once, and no
    # copy of a parameter or moment back into the state after it (only the
    # densify stats and the metrics are copied)
    nodes = kernel_timing.graph_kernels(
        lambda: (runner.cursor.zero_(), runner._call()))
    for fn in ("adam_update_kernel", *(KERNEL_FUNCTIONS[k][0] for k in LOSS),
               "preprocess_forward_kernel", "preprocess_backward_kernel"):
        check(nodes.get(fn) == 1, f"phase 13: {nodes.get(fn)} {fn} in one "
              "captured step")
    print(f"phase 13: one captured step holds {sum(nodes.values())} nodes: "
          f"{nodes.get('adam_update_kernel')} Adam kernel, "
          f"{nodes.get('event_loss_forward_kernel')} + "
          f"{nodes.get('event_loss_backward_kernel')} loss kernels, "
          f"{nodes.get('preprocess_forward_kernel')} + "
          f"{nodes.get('preprocess_backward_kernel')} preprocess kernels, "
          f"{nodes.get('memcpy', 0)} copies, {nodes.get('memset', 0)} memsets")
    runner.release()
    # the Adam kernel in a CUDA graph at the trained state (count 60)
    adam_check("phase 13, after the fused loop", adam_groups(
        rf.state, data, (2, 2, 3), torch.zeros(3, device=dev), icap,
        FUSED_ITERS + 1, lr_on_device=True), graphed=True)
    # the loss kernels in a CUDA graph at the trained state
    loss_check("phase 13, after the fused loop", *loss_views(
        rf.state, data, (2, 2, 3), icap), graphed=True)
    q = np.percentile(replay_ms, [0, 50, 100])
    print(f"phase 13: device time per replayed step (CUDA events around "
          f"{FUSED_STEPS} replays, 5 windows): median {q[1]:.4f} ms, min "
          f"{q[0]:.4f}, max {q[2]:.4f} ({3 * WIDTH * HEIGHT / (q[1] / 1e3):.1f}"
          f" pixels/s); capture {runner.capture_ms:.1f} ms; reserved by the "
          f"fused steps (static buffers and graph pool) {reserved / 2**20:.1f}"
          f" MiB against the eager step's 1,058 MiB peak (PERF.md); {smi}")
    del runner

    # graph swap: densify with capacity growth at 5 and 10, the instance
    # cap re-measured upward after each: captured at 0, 5 and 10
    opt = OptimizationConfig(densify_from_iter=2, densification_interval=5,
                             densify_until_iter=11, densify_grad_threshold=0.0)
    swaps = {}
    for fused in (1, 5):
        cfg = TrainConfig(optimization=opt)
        cfg.pipeline.fused_steps = fused
        swaps[fused] = fused_loop(state, data, cfg, 12)
    (s1, _, _, se1, _, _), (s5, sn5, _, se5, _, made) = swaps[1], swaps[5]
    grown = [it for it, m in se1 if "capacity" in m]
    rebuilt = [it for it, m in se1 if "instance_cap" in m]
    recaptured = [it for it, m in se5 if "graph_capture_ms" in m]
    check(grown == [5, 10] and rebuilt,
          f"capacity grown at {grown} (not 5 and 10), cap rebuilt at {rebuilt}")
    want = [0] + sorted(set(grown) | set(rebuilt))
    check(recaptured == want and len(made) == len(want),
          f"graphs captured at {recaptured}, not {want}")
    check_launches("graph swap", sn5, len(want) * per_capture,
                   len(want) * per_capture,
                   steps=len(want) * (WARMUP_STEPS + 1))
    swap_err, _ = check_same_run("graph swap", s1, s5)
    print(f"phase 13: graph swap, capacity {N_GAUSSIANS} -> "
          f"{s5.state.params.capacity} (grown at {grown}), instance cap "
          f"rebuilt at {rebuilt}, graphs captured at {recaptured} in "
          f"{', '.join(f'{e.capture_ms:.1f}' for e in made)} ms; losses vs "
          f"the eager loop max |diff| {swap_err:.3g}; {smi}")

    # cli.train --fused_steps 3 on phase 6's scene, as phase 6 runs it
    model = os.path.join(root, "trained_fused")
    args = ["-s", os.path.join(root, "colmap"), "-m", model, "--gray",
            "--event", "-r", "1", "--iterations", str(TRAIN_ITERS),
            "--densify_from_iter", "2", "--densification_interval", "3",
            "--densify_grad_threshold", "0", "--save_iterations",
            str(TRAIN_ITERS), "--checkpoint_iterations", str(TRAIN_ITERS),
            "--fused_steps", "3", "--device", DEVICE]
    print("cli.train " + " ".join(args))
    t0 = time.perf_counter()
    rc, launches, log = run_cli(train_main, args)
    check(rc == 0, "cli.train --fused_steps 3 failed")
    last = re.search(r"last loss (\S+)", log)
    check(last is not None and math.isfinite(float(last.group(1))),
          "cli.train --fused_steps 3: no finite loss")
    # a capture at the start, and again after each iteration before the
    # last that grew the capacity or rebuilt the step at a new cap
    n_graphs = len(re.findall(r"graph_capture_ms=", log))
    swapped = {int(it) for it in re.findall(
        r"\[ *(\d+)\] (?:capacity|instance_cap)=", log)
        if int(it) < TRAIN_ITERS}
    check(n_graphs == 1 + len(swapped),
          f"cli.train --fused_steps 3: {n_graphs} captures, capacity or cap "
          f"changed after {sorted(swapped)}")
    check_launches("cli.train --fused_steps 3", launches,
                   per_capture * n_graphs, per_capture * n_graphs,
                   steps=(WARMUP_STEPS + 1) * n_graphs)
    alive = [int(n) for n in re.findall(r"num_alive=(\d+)", log)]
    ck = lambda m: np.load(os.path.join(m, f"chkpnt{TRAIN_ITERS}.npz"))
    eager_alive = int(ck(os.path.join(root, "trained"))["params/alive"].sum())
    check(len(alive) == 2 and alive[1] == eager_alive
          and int(ck(model)["params/alive"].sum()) == eager_alive,
          f"cli.train --fused_steps 3: alive {alive}, phase 6 {eager_alive}")
    print(f"phase 13: cli.train --fused_steps 3 in "
          f"{time.perf_counter() - t0:.2f} s: {n_graphs} graphs captured, "
          f"launches {launches}, alive {alive} (phase 6: {eager_alive}), "
          f"last loss {float(last.group(1)):.6f}; {smi}")


def photometric_rows(what, rows, gray):
    """The SSIM loss kernels' JSON rows (rgb mode) get their registers and
    spills as ``-Xptxas -v`` reported them, their shared memory (static
    and dynamic) and resident blocks per SM as the library reports them,
    and under ``gray`` gray mode's graph ms, bound, plain ms, shared
    memory and blocks per SM (``gray``: the calls and bounds of
    ``photometric_check`` in gray mode)."""
    from event3dgs_tpu_torch.ops import kernels
    from event3dgs_tpu_torch.tools.kernel_probes import (
        ssim_shared_bytes,
        ssim_template,
    )
    from event3dgs_tpu_torch.tools.kernel_timing import (
        bound_ms,
        cuda_ms,
        graph_ms,
        ptxas_report,
    )

    log = kernels.build(["ssim"])["ssim"]
    calls, bounds = gray
    for k in PHOTO:
        rows[k].update(ptxas_report(log, f"{k}_kernel",
                                    ssim_template(False)))
        backward = k == PHOTO[1]
        rows[k]["smem"] = ssim_shared_bytes(backward, False)
        rows[k]["blocks_per_sm"] = kernels.occupancy(
            "ssim", "e3d_photometric_occupancy", int(backward), 0)[1]
        bound, by = bound_ms(*bounds[k])
        rows[k]["gray"] = {"graph_ms": graph_ms(calls[k][0]),
                           "bound_ms": bound, "bound_by": by,
                           "plain_ms": cuda_ms(calls[k][1], 5, warmup=1),
                           **ptxas_report(log, f"{k}_kernel",
                                          ssim_template(True)),
                           "smem": ssim_shared_bytes(backward, True),
                           "blocks_per_sm": kernels.occupancy(
                               "ssim", "e3d_photometric_occupancy",
                               int(backward), 1)[1]}
        print(f"{what}: {k}: {rows[k]['registers']} registers, "
              f"{rows[k]['spill_stores']} bytes spilled, {rows[k]['smem']} "
              f"bytes of shared memory, {rows[k]['blocks_per_sm']} blocks "
              f"an SM (gray {rows[k]['gray']['registers']}, "
              f"{rows[k]['gray']['smem']}, "
              f"{rows[k]['gray']['blocks_per_sm']}); gray mode "
              f"{rows[k]['gray']['graph_ms']:.4f} graph ms, bound "
              f"{bound:.4f} ms ({by}), plain "
              f"{rows[k]['gray']['plain_ms']:.4f} ms")


def packed_cost(what, row, pre):
    """The forward preprocess as the step calls it, with the packed rows,
    and without them (``pre.unpacked``), graph ms each, into its JSON row
    (``graph_ms_packed``, ``graph_ms_unpacked``): what writing the rows
    costs the kernel."""
    from event3dgs_tpu_torch.tools.kernel_timing import graph_ms

    row["graph_ms_packed"] = graph_ms(pre.calls["preprocess_forward"][0])
    row["graph_ms_unpacked"] = graph_ms(pre.unpacked)
    print(f"{what}: preprocess_forward with the packed rows "
          f"{row['graph_ms_packed']:.4f} graph ms, without them "
          f"{row['graph_ms_unpacked']:.4f}")


def graphed_step(what, state, data, icap, mode="event"):
    """The step of ``mode`` of ``state`` (views 1, 1 → 2; rgb and gray
    render view 1 alone) as ``--fused_steps`` runs it
    (``train/fused.FusedSteps``: two eager warm-up steps and the capture),
    ``pack_features``, ``ops/render.composed`` and ``F.conv2d`` called in
    none of them; the device work that one step enqueues, read from its
    CUDA graph (``graph_kernels``): its ``indexSelect`` nodes the table
    row and each camera's 5 fields, no GT frame copied; no library sort
    (the radix sort's kernels once per render); the device ms of a
    replay (CUDA events around 10 replays, the median of 3 windows).
    Printed beside the card's name and power limit."""
    import torch

    from event3dgs_tpu_torch.tools import kernel_timing
    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig()
    step = GraphTrainStep(mode, cfg.optimization, cfg.event,
                          spatial_lr_scale=3.0, rasterizer="tiled",
                          instance_cap=icap)
    replays = 10
    with counting_packs() as packs, counting_composes() as composes, \
            counting_convs() as convs:
        runner = FusedSteps(step, state, data, replays)
        runner.table.copy_(torch.from_numpy(np.stack([
            step.row(int(state.step) + 1 + j, (1, 1, 2), np.zeros(3))
            for j in range(replays)])))
        nodes = kernel_timing.graph_kernels(
            lambda: (runner.cursor.zero_(), runner._call()))
    check(not packs, f"{what}: the graphed {mode} step called pack_features "
          f"{len(packs)} times")
    check(not composes and not convs, f"{what}: the graphed {mode} step "
          f"called ops.render.composed {len(composes)} and F.conv2d "
          f"{len(convs)} times")
    # the depth order is the port's radix sort, once per render: no
    # library sort in the step
    cams = 3 if mode.startswith("event") else 1
    sorts = {k: c for k, c in nodes.items()
             if "sort" in k.lower() and not k.startswith("radix_")}
    check(not sorts and nodes.get("radix_histogram_kernel") == cams
          and nodes.get("radix_pass_kernel") == 4 * cams
          and nodes.get("depth_offsets_kernel") == cams,
          f"{what}: the graphed {mode} step's sort nodes: library {sorts}, "
          f"radix histogram {nodes.get('radix_histogram_kernel')}, passes "
          f"{nodes.get('radix_pass_kernel')}, offsets "
          f"{nodes.get('depth_offsets_kernel')} for {cams} renders")
    # the picks left: the table row and each camera's 5 fields; the GT
    # frames are read by the loss kernels where they lie
    picks = sum(c for k, c in nodes.items() if k.startswith("indexSelect"))
    check(picks == 1 + cams * 5, f"{what}: {picks} indexSelect nodes in the "
          f"graphed {mode} step, not {1 + cams * 5} (the table row, "
          f"{cams * 5} camera fields)")
    ms = []
    for _ in range(3):
        runner.cursor.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            runner.graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / replays)
    check(bool(torch.isfinite(runner.slots.history).all()),
          f"{what}: non-finite loss in a timed replay")
    runner.release()
    kernels = sum(c for k, c in nodes.items()
                  if k not in ("memset", "memcpy", "other"))
    print(f"{what}: one graphed {mode} step enqueues {sum(nodes.values())} "
          f"device nodes ({kernels} kernels, {nodes.get('memcpy', 0)} "
          f"copies, {nodes.get('memset', 0)} memsets); "
          f"{float(np.median(ms)):.4f} device ms per replay (median of "
          f"{', '.join(f'{m:.4f}' for m in ms)}); {picks} indexSelect "
          f"nodes (the table row, {cams * 5} camera fields; no GT frame "
          f"copied); pack_features, ops.render.composed and F.conv2d "
          f"called 0 times in its warm-up steps and capture; {card()}")


def scale_kernel_rows(state, data, icap, dev):
    """Phase 14b: at the 2M-slot maxcap state, every kernel of the path
    against its plain version at the step's main view (camera 1), at the
    tolerances phases 4 and 7 hold them to, and each kernel's graph ms and
    bound there (the preprocess kernels' plain ms too, by CUDA events);
    the Adam kernel on the step's update there (bit for bit, also in a
    CUDA graph), its plain version's ms and ``torch._fused_adam_``'s; the
    loss kernels on the step's renders there (``loss_check`` in a CUDA
    graph), with their graph ms, bounds and plain versions' ms.
    Returns {kernel: the scale columns of its JSON row}."""
    import torch

    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.tools.kernel_timing import (
        adam_bound,
        bound_ms,
        cuda_ms,
        fused_adam_call,
        graph_ms,
    )

    what = f"phase 14, {SCALE_CAPACITY} slots, main view"
    pre = step_preprocess_check(f"phase 14, {SCALE_CAPACITY} slots, the "
                                "step's three views", state, data, (1, 1, 2))
    v = view_kernels(what, pre.proj, pre.colors,
                     activated(state.params).opacities, icap, dev,
                     backward=True)
    v.errs.update(pre.errs)
    v.calls.update(pre.calls)
    v.bounds.update(pre.bounds)
    out = {}
    for name, (call, plain) in v.calls.items():
        ms = graph_ms(call)
        bound, by = bound_ms(*v.bounds[name])
        out[name] = {"gaussians": state.params.capacity,
                     "instance_cap": icap, "max_abs_err": v.errs[name],
                     "graph_ms": ms, "bound_ms": bound, "bound_by": by}
        plain_txt = ""
        if name in pre.calls:
            out[name]["plain_ms"] = cuda_ms(plain, 2, warmup=1)
            out[name]["views"] = 3
            plain_txt = f", plain {out[name]['plain_ms']:.4f} ms"
        print(f"{what}: {name} {ms:.4f} graph ms, bound {bound:.4f} ms "
              f"({by}), {ms / bound:.2f}x{plain_txt}")
    out["K3 segment_sums"].update(k3_in_order(what, v.bk, v.rows_k))
    out["K4 depth_sort"]["depth_order"] = depth_order_timing(what, v, icap)
    packed_cost(what, out["preprocess_forward"], pre)
    adam = adam_groups(state, data, (1, 1, 2),
                       torch.zeros(3, device=dev), icap, 1)
    err, kern, plain = adam_check(what, adam, graphed=True)
    ms = graph_ms(kern)
    bound, by = bound_ms(*adam_bound(adam_floats(adam)))
    out[ADAM] = {"gaussians": state.params.capacity, "instance_cap": icap,
                 "max_abs_err": err, "graph_ms": ms, "bound_ms": bound,
                 "bound_by": by, "plain_ms": cuda_ms(plain, 2, warmup=1),
                 "library_ms": cuda_ms(fused_adam_call(adam), 20)}
    print(f"{what}: {ADAM} {ms:.4f} graph ms, bound {bound:.4f} ms ({by}), "
          f"{ms / bound:.2f}x, plain {out[ADAM]['plain_ms']:.4f} ms, "
          f"torch._fused_adam_ {out[ADAM]['library_ms']:.4f} ms")
    errs, calls, bounds = loss_check(what, *loss_views(
        state, data, (1, 1, 2), icap), graphed=True)
    for k in LOSS:
        ms = graph_ms(calls[k][0])
        bound, by = bound_ms(*bounds[k])
        out[k] = {"gaussians": state.params.capacity, "instance_cap": icap,
                  "max_abs_err": errs[k], "graph_ms": ms, "bound_ms": bound,
                  "bound_by": by, "plain_ms": cuda_ms(calls[k][1], 2,
                                                      warmup=1)}
        print(f"{what}: {k} {ms:.4f} graph ms, bound {bound:.4f} ms ({by}), "
              f"{ms / bound:.2f}x, plain {out[k]['plain_ms']:.4f} ms")
    errs, *per_mode = photometric_check(what, *photometric_views(
        state, data, 1, icap), graphed=True)
    for k in PHOTO:
        for mode, (calls, bounds) in zip(("rgb", "gray"), per_mode):
            ms = graph_ms(calls[k][0])
            bound, by = bound_ms(*bounds[k])
            row = {"gaussians": state.params.capacity, "instance_cap": icap,
                   "max_abs_err": errs[k], "graph_ms": ms, "bound_ms": bound,
                   "bound_by": by, "plain_ms": cuda_ms(calls[k][1], 2,
                                                       warmup=1)}
            if mode == "rgb":
                out[k] = row
            else:
                out[k]["gray"] = row
            print(f"{what}: {k} ({mode}) {ms:.4f} graph ms, bound "
                  f"{bound:.4f} ms ({by}), {ms / bound:.2f}x, plain "
                  f"{row['plain_ms']:.4f} ms")
    return out


def scale_path(dev):
    """Phase 14: the port at the JAX package's scale through
    ``tools/scale.py``.  Returns (the scale columns of each kernel's JSON
    row, the launches of the 2M run)."""
    import torch

    from event3dgs_tpu_torch.ops import binning, sort_tiles
    from event3dgs_tpu_torch.tools import scale
    from event3dgs_tpu_torch.tools.kernel_timing import graph_ms
    from event3dgs_tpu_torch.train.fused import WARMUP_STEPS

    smi = card()
    # 14a: scale.maxcap at 2M, eager then graphed, each on its own scene
    iters = scale.MAXCAP_ITERS
    with counting_composes() as composes:
        rec, launches = count_launches(lambda: scale.run_scene(
            "maxcap", SCALE_CAPACITY, iters, SCALE_FUSED, False, WIDTH,
            HEIGHT, dev))
    check(rec["status"] == "ok", f"phase 14: maxcap at {SCALE_CAPACITY}: {rec}")
    check(not composes, f"phase 14: the eager and graphed event steps called "
          f"ops.render.composed {len(composes)} times")
    want = 3 * (1 + iters) + 3 * (WARMUP_STEPS + 1)
    # eager 1 + iters steps, graphed warm-up and capture
    check_launches("phase 14", launches, want, want,
                   steps=1 + iters + WARMUP_STEPS + 1)
    e, gr = rec["eager"], rec["graphed"]
    check(math.isfinite(e["loss"]) and rec["same_loss"],
          f"phase 14: eager loss {e['loss']} vs graphed {gr['loss']}")
    check(gr["replays"] == 1 + iters, f"phase 14: {gr['replays']} replays")
    print(f"phase 14: maxcap {SCALE_CAPACITY} slots, state "
          f"{rec['state_gib']:.3f} GiB, instance cap {rec['instance_cap']} "
          f"({rec['instances_per_splat']:.3f}/splat); eager "
          f"{e['ms_per_step']:.3f} ms per step (first {e['first_step_s']:.2f} "
          f"s), peak {e['peak_mib']:.1f} MiB; graphed {gr['ms_per_step']:.3f} "
          f"ms per step host, {gr['device_ms_per_replay']:.4f} device ms per "
          f"replay, capture {gr['capture_ms']:.1f} ms, peak "
          f"{gr['peak_mib']:.1f} MiB, reserved by the fused steps "
          f"{gr['reserved_mib']:.1f} MiB; loss {e['loss']:.6f} in both; "
          f"launches {launches}; {smi}")

    # 14b: each kernel of the path at 2M against its plain version
    state, data = scale.maxcap_scene(SCALE_CAPACITY, WIDTH, HEIGHT, dev)
    graphed_step(f"phase 14, {SCALE_CAPACITY} slots", state, data,
                 rec["instance_cap"])
    rows = scale_kernel_rows(state, data, rec["instance_cap"], dev)
    for name, row in rows.items():
        row["launches"] = launches[name]
    del state, data
    scale.release(dev)

    # 14c: the depth order and the counting sort at the ceiling's sizes
    n = CEILING_BLOCKS * binning.OFFSETS_TILE + 1000
    tables = scale.depth_offsets_case(n, device=dev)
    cap = 1 << 26
    want = binning.depth_order_plain(tables, cap)
    live = -(-min(int(want.offsets[-1]), cap) // sort_tiles.SEGMENT)
    for _ in range(2):
        got = binning.depth_order_kernel(tables, cap)
        check(torch.equal(got.order, want.order)
              and torch.equal(got.offsets, want.offsets)
              and torch.equal(got.seg_rank[:live], want.seg_rank[:live]),
              f"phase 14: the depth order over {n} ranks differs from its "
              "plain version")
        check(not tables.lookback.any(), "phase 14: the depth order's "
              "state was left set")
    offsets_ms = graph_ms(lambda: binning.depth_order_kernel(tables, cap))
    argsort_ms = graph_ms(lambda: torch.argsort(tables.key, stable=True))
    del tables, want, got
    tiles_x, tiles_y = binning.tile_grid(WIDTH, HEIGHT)
    nt = tiles_x * tiles_y
    m = CEILING_SLOTS + 5
    ids, gauss, n_live = scale.counting_sort_case(m, nt, device=dev)
    want = sort_tiles.counting_sort_plain(ids, gauss, n_live, nt, 1 << 24)
    got = sort_tiles.counting_sort_kernel(ids, gauss, n_live, nt, 1 << 24)
    for field, k, p in zip(got._fields, got, want):
        check(torch.equal(k, p), f"phase 14: the counting sort over {m} "
              f"slots: {field} differs from its plain version")
    check(torch.equal(sort_tiles.tile_histogram_kernel(ids, nt, n_live),
                      want.counts)
          and torch.equal(sort_tiles.stable_tile_rank_kernel(
              ids, n_live, nt, want.offsets, m), want.dest),
          f"phase 14: K5 or K6 alone over {m} slots differs")
    sort_ms = graph_ms(lambda: sort_tiles.counting_sort_kernel(
        ids, gauss, n_live, nt, 1 << 24))
    del ids, gauss, want, got
    scale.release(dev)
    print(f"phase 14: the depth order (radix sort, "
          f"{-(-n // binning.SORT_TILE)} tiles a pass, and the offsets over "
          f"{-(-n // binning.OFFSETS_TILE)} look-back blocks) over {n} ranks bit-equal to its plain version "
          f"twice, state left cleared, {offsets_ms:.4f} graph ms "
          f"(torch.argsort of the keys {argsort_ms:.4f}); counting sort (K5 "
          f"+ K6) over {m} slots "
          f"bit-equal, K5 and K6 alone too, {sort_ms:.4f} graph ms; {smi}")

    # 14d: scale.train --densify --fused_steps 10 at 1,048,576 slots
    t0 = time.perf_counter()
    scene = scale.train_scene(SCALE_TRAIN_CAPACITY, True, SCALE_TRUE_POINTS,
                              scale.TRAIN_VIEWS, WIDTH, HEIGHT, dev)
    scene_s = time.perf_counter() - t0
    (trec, res), tl = count_launches(lambda: scale.run_train(
        SCALE_TRAIN_ITERS, True, SCALE_FUSED, scene=scene, device=dev))
    check(trec["status"] == "ok", f"phase 14: train: losses finite "
          f"{trec['finite']}, decreasing {trec['decreasing']}")
    check(trec["instance_overflow"] == 0, f"phase 14: train: instance cap "
          f"{trec['instance_cap']} overflows by {trec['instance_overflow']}")
    check([it for it, _ in trec["alive"]] == [100, 150],
          f"phase 14: train densified at {trec['alive']}")
    per_capture = WARMUP_STEPS + 1  # one render per rgb-mode step
    check_launches(f"phase 14: train, {trec['captures']} captures", tl,
                   per_capture * trec["captures"],
                   per_capture * trec["captures"],
                   steps=per_capture * trec["captures"], event=False)
    eager, eres = scale.run_train(SCALE_TRAIN_EAGER, True, 1, scene=scene,
                                  device=dev)
    h, he = np.asarray(res.history), np.asarray(eres.history)
    check(np.array_equal(h[:SCALE_TRAIN_EAGER], he), "phase 14: train: the "
          f"first {SCALE_TRAIN_EAGER} losses differ from the eager loop's by "
          f"{np.abs(h[:SCALE_TRAIN_EAGER] - he).max():.3g}")
    print(f"phase 14: train --densify --fused_steps {SCALE_FUSED}, "
          f"{SCALE_TRAIN_ITERS} iterations at {trec['capacity_start']} slots "
          f"(scene {scene_s:.1f} s): alive {trec['alive_start']} -> "
          f"{trec['alive']} -> {trec['alive_end']}, capacity "
          f"{trec['capacity_end']}, {trec['it_s']:.3f} it/s "
          f"({trec['pixels_s']:.1f} pixels/s), {trec['captures']} captures "
          f"({', '.join(f'{c:.1f}' for c in trec['capture_ms'])} ms), loss "
          f"curve {[round(v, 5) for v in trec['loss_curve']]}, instance cap "
          f"{trec['instance_cap']} without overflow; the first "
          f"{SCALE_TRAIN_EAGER} losses equal to the eager loop's bit for "
          f"bit ({eager['it_s']:.3f} it/s eager); launches {tl}; {smi}")
    del eres
    for k in PHOTO:  # the 2M run is in event mode: the SSIM kernels' 14d's
        rows[k]["launches"] = tl[k]
    # densify with capacity growth at ~1M: the trained state, threshold 0
    densify_growth(res.state, scene[1], (3, 3, 4),
                   torch.zeros(3, device=dev), mode="rgb",
                   extent=scale.TRAIN_EXTENT)
    del scene, res
    scale.release(dev)
    return rows, launches


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

    # 1. build: every source, and the probes' K1, K2 and K4 builds ---------
    from event3dgs_tpu_torch.tools.kernel_probes import (
        offsets_builds,
        ssim_builds,
        variant_builds,
    )

    t0 = time.perf_counter()
    for name, log in kernels.build([*kernels.SIGNATURES, *variant_builds(),
                                    *ssim_builds(),
                                    *offsets_builds()]).items():
        print(f"--- nvcc {name} (sm_90a) ---\n{log.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as root:
        render_launches, _, rows = render_path(root, dev)
        train_launches, model, photo_launches = train_path(root)
        evaluation_path(root, model, dev)
        event_path(root, model, dev)
        _, train_rows, per_step = train_kernels(dev)
        probe_rows = probe_path(dev)
        fused_path(root, dev)
        scale_rows, scale_launches = scale_path(dev)
        # last: after its NCCL job and profiled run, the profiler's
        # device times of K2 and K3 (phases 7-8) came out too low
        sharded_launches = sharded_path(root, dev)
    rows.update(train_rows)
    print(f"launches: cli.render {render_launches}; cli.train "
          f"{train_launches}; cli.train rgb and gray {photo_launches}; "
          f"train_loop_sharded {sharded_launches}; one "
          f"event step {per_step}; phase 14's {SCALE_CAPACITY}-slot run "
          f"{scale_launches}")
    for name, row in rows.items():
        row["launches"] = (photo_launches if name in PHOTO
                           else train_launches)[name]
        row["scale"] = scale_rows[name]
    rows.update(probe_rows)

    print(card())
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
