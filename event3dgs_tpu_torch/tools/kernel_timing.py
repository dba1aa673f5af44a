"""Timing of the port's kernels on a CUDA card: the helpers and the
bound arithmetic that ``chip_smoke.py`` and ``tools/kernel_probes.py``
use, ``bench.py``'s scene and training state, and the tile binning from the
projection's outputs, one source tree against another, in turns:

    python3 event3dgs_tpu_torch/tools/kernel_timing.py --trees OLD . . OLD

Each tree (a checkout of this repository) runs in a fresh process, in the
order given, with the tree first on ``sys.path``: it builds the tree's
kernels, projects ``bench.py``'s scene (100k Gaussians from seed 0,
cameras at ``bench.py``'s poses, 1920×1080) and bins it with the tree's
``binning.bin_gaussians`` at the render view (camera 0, instance cap
800,768) and at the train step's main view (camera 1, cap 428,032): every
device kernel from the projection's outputs to the finished ``Binning``.
Per view it prints one JSON line: the device time per call of each device
kernel and in all (``torch.profiler``, 20 calls), the device kernels per
call, the event time per call (CUDA events over 50 calls, the host's
enqueue included) and a digest of the ``Binning``, which must agree
between trees; before them, what ``-Xptxas -v`` reported for the tree's
K1, K2 and K4 (registers, spill bytes, shared memory).  After them, one
line for ``bench.py``'s event train step on the reference rasterizer at a
small size (8,192 Gaussians, 64×48): ms per step (CUDA events over 10
steps of one state) and peak memory, with the loss's bits as its digest.
Then K3 (``segment_sums_kernel``) at the train step's main view and at
``tools/scale.py``'s 2,097,152-slot maxcap view (camera 1, its measured
cap): graph ms over seeded rows read through the binning's ``dest``, as
the rasterizer hands them over, and over the same rows put into expansion
order beforehand with an identity ``dest`` (the gap is what the gather
costs), ``torch.segment_reduce`` over the ordered rows, and a digest of
the sums; on a tree whose K3 has two orders of work, also each order
forced, and its timing-only build balanced by instances.  Last,
``GRAPHED_STEPS`` replays of the graphed event step
(``train/fused.FusedSteps``) at ``bench.py``'s state and at the 2M state:
the device ms per replay and a digest of the losses, parameters and
contrast, which must agree between trees.  The last lines are the card's
name and power limit and tables of the runs.

    python3 event3dgs_tpu_torch/tools/kernel_timing.py --k3

times this tree's K3 in both orders of work (``ops/segscan.py``): alone
over seeded segments at ``K3_SWEEP`` sizes, from 100k to 4M Gaussians
(the basis of ``segscan.BY_OUTPUT_L2``), and inside the graphed event
step at ``bench.py``'s state and at the 2M state, the step captured once
with each order and the two graphs replayed in turns.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np

VIEWS = (("render", 0, 800_768), ("train", 1, 428_032))
# the reference rasterizer's step: Gaussians, width, height
REFERENCE_STEP = (8_192, 64, 48)
N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1920, 1080

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
# SFU operation and nothing more, and an explicit FMA as one FP32
# instruction, so the bound stays a lower bound.  The bound charges the
# composited pairs only (the work the function needs).
K1_PAIR_OPS = ((10, 0), (12, 1), (23, 3))
K2_PAIR_OPS = ((10, 0), (12, 1), (38, 4))
COMPOSITED = 2  # index of the composited pairs in the tables and counts
# the kernels whose -Xptxas -v report the tree comparison prints
PTXAS_KERNELS = (("rasterize_fwd", "composite_forward_kernel"),
                 ("rasterize_bwd", "composite_backward_kernel"),
                 ("expand", "expand_kernel"))
# K3's timing-only build with one owner per segment in rank order and warps
# balanced by instances, and the segments + instances of one of its warps
# (csrc/segsum.cu)
K3_BALANCED = ("E3D_K3_BALANCED",)
K3_BALANCED_ITEMS = 64
# Gaussians (segments) of the K3 sweep
K3_SWEEP = (100_000, 250_000, 300_000, 350_000, 400_000, 450_000, 500_000,
            750_000, 1_000_000, 1_500_000, 2_097_152, 4_194_304)
K3_STEP_ROUNDS = 10  # replays of each capture in the K3 step comparison
# the 2M-slot maxcap state of tools/scale.py (chip_smoke phase 14)
SCALE_SLOTS = 2_097_152
K3_SEED = 5  # K3's timing rows (its time does not depend on their values)
GRAPHED_STEPS = 3  # graphed event steps the trees compare, after one


def pair_ops(pairs, table, kinds=(COMPOSITED,)):
    """(FP32, SFU) operations of the pairs of ``kinds`` (counts by kind, as
    ``rasterize_tiled._composite_plain`` returns them)."""
    return (sum(pairs[k] * table[k][0] for k in kinds),
            sum(pairs[k] * table[k][1] for k in kinds))


def bound_ms(nbytes, ops):
    """The least time for ``nbytes`` moved and (FP32, SFU) ``ops``, and
    which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    # the FP32 lanes and the SFUs work side by side
    t_ops = max(ops[0] / PEAK_FP32_PER_S, ops[1] / PEAK_SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def composite_bytes(live: int, n: int, num_tiles: int, width: int,
                    height: int, backward: bool = False) -> int:
    """Bytes K1 (or K2) must move: the live instance ids, the packed
    feature rows, the tile offsets and counts; K1 writes rgb, log T and the
    stop index, K2 reads those and the two upstream gradients and writes
    nine floats per live instance."""
    common = live * 4 + n * 48 + num_tiles * 8
    if not backward:
        return common + width * height * 20
    return common + width * height * 24 + live * 9 * 4


def expansion_bytes(offsets, cap: int, num_tiles: int,
                    count_rows: bool = True) -> int:
    """Bytes K4 must move at its depth offsets ``offsets`` [N+1]: per live
    rank (one with slots under the cap) its 48-byte table row, order entry
    and offset; 8 bytes per slot; with ``count_rows`` each live segment's
    row of tile counts."""
    from event3dgs_tpu_torch.ops.sort_tiles import SEGMENT

    off = offsets.long()
    capped = min(int(off[-1]), cap)
    live_ranks = int(((off[:-1] < capped) & (off[1:] > off[:-1])).sum())
    rows = -(-capped // SEGMENT) * num_tiles * 4 if count_rows else 0
    return live_ranks * (48 + 4 + 4) + cap * 8 + rows


def segment_sums_bytes(live: int, slots: int, n: int) -> int:
    """Bytes K3 must move: the live rows, the slots' destinations, the
    offsets and order, the [N, 9] sums."""
    return live * 9 * 4 + slots * 4 + (n + 1) * 4 + n * 4 + n * 9 * 4


def preprocess_bytes(n: int, coeffs: int, sh_degree: int,
                     backward: bool = False, views: int = 1,
                     tap: bool = False) -> int:
    """Bytes the preprocess forward (or backward) kernel must move for
    ``n`` Gaussians whose features are [N, coeffs, 3] at ``sh_degree``,
    projected into ``views`` views in one launch.  Each input is read once
    for all the views: the means, scales and quaternions, and of the two
    feature leaves the rows the degree uses (features_dc's 12-byte row and
    the first (degree + 1)² - 1 coefficients of features_rest's row, each
    leaf read at its own row stride); the forward also the opacities and,
    with ``tap``, the first view's [N, 2] mean2d tap.  Per view the forward
    writes mean2d, depth, conic, radius, valid (one byte), the colours and
    the 48-byte packed row of the compositing kernels (the train step and
    the colour render ask for it); the backward reads
    valid and the gradients of mean2d, conic and colours.  The backward
    writes the gradients of the means, scales, quaternions and of both
    leaves whole (all ``coeffs``), once.  The mask's and the cameras' bytes
    are left out."""
    used = (sh_degree + 1) ** 2 * 12
    if not backward:
        return n * (12 + 12 + 16 + 4 + used + (8 if tap else 0)
                    + views * (8 + 4 + 12 + 4 + 1 + 12 + 48))
    return n * (12 + 12 + 16 + used + views * (1 + 8 + 12 + 12)
                + 12 + 12 + 16 + coeffs * 12)


def preprocess_ops(n: int, sh_degree: int, backward: bool = False,
                   views: int = 1):
    """(FP32, SFU) operations the preprocess forward (or backward) kernel
    does at least for ``n`` Gaussians in each of ``views`` views, counted
    from ``csrc/preprocess.cu`` and rounded down: the projection about 170
    FP32 and 12 SFU operations (6 divisions, 4 square roots, 2
    reciprocals), the colours 6 per used coefficient and 4 SFU (a square
    root, 3 divisions); the backward about twice the projection's FP32
    operations and 12 per coefficient, and 12 SFU (its recompute of the
    projection takes reciprocals: 4 of them, 2 divisions and a square root;
    a reciprocal of the conic's determinant; the SH direction's square
    root, 3 divisions and a reciprocal)."""
    coeffs = (sh_degree + 1) ** 2
    if not backward:
        return (views * n * (170 + 6 * coeffs), views * n * 16)
    return (views * n * (2 * 170 + 12 * coeffs), views * n * 12)


# the Adam update (csrc/adam.cu) per float: p, g, m and v read, p, m and
# v written (1,652 bytes a slot at SH degree 3, 59 floats); 6 products, 3
# sums and a difference on the FP32 lanes, 3 divisions and a square root
# counted as one SFU operation each
ADAM_BYTES_PER_FLOAT = (4 + 3) * 4
ADAM_OPS_PER_FLOAT = (10, 4)


def adam_bound(floats: int):
    """(bytes, (FP32, SFU) operations) that the Adam update of ``floats``
    floats must move and do, for :func:`bound_ms`."""
    return (floats * ADAM_BYTES_PER_FLOAT,
            (floats * ADAM_OPS_PER_FLOAT[0], floats * ADAM_OPS_PER_FLOAT[1]))


# the event loss (csrc/loss.cu) per pixel, (FP32, SFU) operations counted
# from the source, a logf, an expf or a division as one SFU operation and
# nothing more (so the bound stays a lower bound), by kernel (backward or
# not); each three-channel image of the GT pair adds its L channel,
# event_deblur the blurry image's L1, each render given as partials its
# composition (3 products, 3 sums and an expf) and in the backward its
# log T gradient (4 products and 2 sums)
LOSS_PIXEL_OPS = {False: (25, 5), True: (33, 9)}
LOSS_GT_L_OPS = 5
LOSS_DEBLUR_OPS = {False: 6, True: 9}
LOSS_PARTIALS_OPS = {False: (6, 1), True: (12, 1)}


def loss_bound(pixels: int, channels, backward: bool = False,
               partials: int = 0):
    """(bytes, (FP32, SFU) operations) that one event loss kernel must move
    and do at ``pixels`` pixels, for :func:`bound_ms`: the three renders (3
    floats a pixel, and log T's one for the ``partials`` of them given as
    rgb and log T) and the GT images of ``channels`` (gt_now, gt_next,
    gt_main[, blurry]: 1 or 3 each) read once, the scalars read and
    written, and in the backward the three renders' gradients written
    (log T's too)."""
    deblur = len(channels) > 3
    floats = 9 + partials + sum(channels)
    if backward:
        floats += 9 + partials
    scalars = 4 * (4 if backward else 6)  # c, grad, coverage, dc / c, 5 out
    fp32, sfu = LOSS_PIXEL_OPS[backward]
    fp32 += LOSS_GT_L_OPS * sum(c == 3 for c in channels[:2])
    fp32 += LOSS_DEBLUR_OPS[backward] if deblur else 0
    fp32 += LOSS_PARTIALS_OPS[backward][0] * partials
    sfu += LOSS_PARTIALS_OPS[backward][1] * partials
    return 4 * floats * pixels + scalars, (fp32 * pixels, sfu * pixels)


# the rgb and gray loss (csrc/ssim.cu) per compared value (a pixel of a
# channel: 3 in rgb mode, its luma in gray mode), (FP32, SFU) operations
# counted from the source, a division as one SFU operation, without the
# vertical pass the kernels repeat over each tile's halo (so the bound stays
# a lower bound): forward the five moments' two 11-tap passes (5 · 2 · 21),
# the three products blurred, the map and its derivatives (28, 4
# divisions), |x - y| and the two sums; backward the three maps' two passes
# (3 · 2 · 21), their sum (5) and dx (5).  Per pixel: a luma (8) of the
# render and of a three-channel GT in gray mode and, in the backward, the
# spread over the channels (3); the composition of partials (3 products, 3
# sums, an expf), in the backward again, with the log T gradient (9)
PHOTO_VALUE_OPS = {False: (245, 4), True: (136, 0)}
PHOTO_LUMA_OPS = 8
PHOTO_PARTIALS_OPS = {False: (6, 1), True: (15, 1)}


def photometric_bound(pixels: int, channels: int = 3, backward: bool = False,
                      gt_channels: int = 3, partials: bool = True):
    """(bytes, (FP32, SFU) operations) that one SSIM loss kernel must move
    and do at ``pixels`` pixels with ``channels`` compared (3: rgb mode, 1:
    gray), for :func:`bound_ms`: the render (3 floats a pixel, and log T's
    one where it comes as ``partials``) and the GT (``gt_channels``) read
    once, the forward's three derivative maps (3 · ``channels``) written,
    and in the backward read, with the render's gradients written (d rgb,
    d log T); the scalars read and written."""
    render = 3 + partials
    floats = render + gt_channels + 3 * channels
    if backward:
        floats += render
    scalars = 4 * (1 if backward else 2)
    fp32, sfu = PHOTO_VALUE_OPS[backward]
    fp32, sfu = fp32 * channels, sfu * channels
    if channels == 1:
        fp32 += PHOTO_LUMA_OPS * (1 + (gt_channels == 3)) + 3 * backward
    if partials:
        fp32 += PHOTO_PARTIALS_OPS[backward][0]
        sfu += PHOTO_PARTIALS_OPS[backward][1]
    return 4 * floats * pixels + scalars, (fp32 * pixels, sfu * pixels)


def fused_adam_call(groups, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-15):
    """The timing yardstick of the Adam kernel: a callable that runs
    ``torch._fused_adam_`` (the kernel of ``torch.optim.Adam(fused=True)``)
    over copies of the groups' parameters, gradients (made contiguous) and
    moments, one call per learning rate.  Its rounding differs from the
    JAX package's update, so the port never runs it."""
    import torch

    from event3dgs_tpu_torch.models.optimizer import AdamGroup, group_leaves

    by_lr: dict[float, list] = {}
    for grp in groups:
        params, grads, state, lrs = AdamGroup(*grp)
        for p, g, m, v, *_, lr in group_leaves(params, grads, state, lrs,
                                                params, state):
            by_lr.setdefault(float(lr), []).append(
                (p.clone(), g.contiguous(), m.clone(), v.clone(),
                 torch.ones((), dtype=torch.float32, device=p.device)))
    lists = {lr: [list(x) for x in zip(*ts)] for lr, ts in by_lr.items()}

    def call():
        for lr, (ps, gs, ms, vs, steps) in lists.items():
            torch._fused_adam_(ps, gs, ms, vs, [], steps, lr=lr, beta1=b1,
                               beta2=b2, weight_decay=0.0, eps=eps,
                               amsgrad=False, maximize=False)

    return call


def path_bounds(n: int, cap: int, offsets, live: int, pairs,
                num_tiles: int, width: int, height: int, coeffs: int = 16,
                sh_degree: int = 3) -> dict:
    """(bytes, (FP32, SFU) operations) that each kernel of one view's path
    must at least move and do on this run's inputs, for :func:`bound_ms`:
    ``n`` Gaussians with [N, coeffs, 3] features at ``sh_degree``,
    instance cap ``cap``, the depth offsets ``offsets`` [N+1], ``live``
    instances after the cull, the compositing ``pairs`` by kind
    (``rasterize_tiled._composite_plain``), ``num_tiles`` tiles."""
    from event3dgs_tpu_torch.ops.rasterize_tiled import NGRAD
    from event3dgs_tpu_torch.ops.sort_tiles import segments

    capped = min(int(offsets[-1]), cap)
    return {
        "preprocess_forward": (preprocess_bytes(n, coeffs, sh_degree),
                               preprocess_ops(n, sh_degree)),
        "preprocess_backward": (
            preprocess_bytes(n, coeffs, sh_degree, backward=True),
            preprocess_ops(n, sh_degree, backward=True)),
        # per Gaussian 33 bytes read, 52 written; at least 60 FP32 and 7
        # SFU operations (a log, two square roots, four divisions)
        "K4 gaussian_tables": (n * (33 + 52), (60 * n, 7 * n)),
        # per rank the argsort's int64 and its count read, the int32 order
        # and its offset written; a rank per segment
        "K4 depth_offsets": (n * (8 + 4 + 4 + 4) + 4 + segments(cap) * 4,
                             (0, 0)),
        # per live rank its 48-byte table row, order entry and offset; 8
        # bytes per slot; each live segment's count row
        "K4 expand_instances": (expansion_bytes(offsets, cap, num_tiles),
                                (0, 0)),
        "K5 tile_histogram": (capped * 4 + num_tiles * 4, (0, 0)),
        "K6 stable_tile_rank": (capped * 4 + num_tiles * 4 + cap * 4, (0, 0)),
        "K1 composite_forward": (
            composite_bytes(live, n, num_tiles, width, height),
            pair_ops(pairs, K1_PAIR_OPS)),
        "K2 composite_backward": (
            composite_bytes(live, n, num_tiles, width, height, backward=True),
            pair_ops(pairs, K2_PAIR_OPS)),
        "K3 segment_sums": (segment_sums_bytes(live, capped, n),
                            (live * NGRAD, 0)),
    }


def ptxas_report(log: str, kernel: str, template: str = "") -> dict:
    """What ``-Xptxas -v`` reported for ``kernel`` in a build's log:
    registers, spill stores and loads (bytes), shared memory (bytes).  A
    kernel template's instance is named by its mangled arguments
    (``template="ILi3E"``: ``kernel<3>``)."""
    lines = log.splitlines()
    tail = re.escape(template) if template else "E"
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and re.search(
                rf"\d{kernel}{tail}", line):
            text = " ".join(lines[k + 1:k + 4])
            num = lambda pat: int(m.group(1)) if (
                m := re.search(pat, text)) else 0
            return {"registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "smem": num(r"(\d+) bytes smem")}
    raise ValueError(f"no -Xptxas -v report of {kernel}")


def bench_scene(rng, n: int = N_GAUSSIANS):
    """bench.py's scene (`_scene`) from ``rng``: means, scales, rotations,
    opacities, colors."""
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)]
    scales = (np.exp(rng.uniform(np.log(0.005), np.log(0.03), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    return means, scales, rots, opac, colors


def bench_camera(i: int, width: int, height: int, device):
    """bench.py's camera i: identity rotation, translation (0.01·i, 0,
    0.02·i), fov 1.2 × 0.75."""
    from event3dgs_tpu_torch.core import make_camera

    return make_camera(np.eye(3), np.asarray([0.01 * i, 0.0, 0.02 * i]), 1.2,
                       0.75, width, height, device=device)


def bench_state(device, n: int = N_GAUSSIANS, width: int = WIDTH,
                height: int = HEIGHT, views: int = 4):
    """bench.py's `bench_train_step` set-up: (state, data, measured
    instance cap): ``n`` Gaussians of its scene from seed 0 at its scales,
    rotations and opacities, ``views`` cameras (bench.py's 4; the training
    loop's event-mode view pick needs at least 6), random images from seed
    1, event mode's data, ``spatial_lr_scale`` 3.0."""
    import torch

    from event3dgs_tpu_torch.core.camera import stack_cameras
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.models.gaussians import GaussianParams
    from event3dgs_tpu_torch.train import SceneData, init_train_state
    from event3dgs_tpu_torch.train.loop import measure_instance_cap

    means, scales, rots, opac, colors = bench_scene(np.random.default_rng(0), n)
    cameras = stack_cameras([bench_camera(i, width, height, device)
                             for i in range(views)])
    images = torch.tensor(np.random.default_rng(1).uniform(
        0, 1, (views, height, width, 3)), dtype=torch.float32, device=device)
    params = init_from_point_cloud(means, colors, capacity=n, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    params = GaussianParams(
        xyz=params.xyz, features_dc=params.features_dc,
        features_rest=params.features_rest, scaling=f32(np.log(scales)),
        rotation=f32(rots), opacity=f32(np.log(opac / (1 - opac))[:, None]),
        alive=params.alive)
    state = init_train_state(params, spatial_lr_scale=3.0)
    data = SceneData(cameras=cameras, images=images, event_cameras=cameras,
                     event_images=images)
    return state, data, measure_instance_cap(state.params, cameras)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn`` between CUDA events around ``iters``
    calls (the host's enqueue included when it is the longer)."""
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


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean time per call of ``fn`` captured ``launches`` times in one CUDA
    graph and replayed: the device's time without the host's enqueue (a
    call may allocate, from the graph's own pool, but not synchronise)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays, warmup=1) / launches


def kernel_name(key: str) -> str:
    """A device kernel's function name from the profiler's key (namespaces,
    template arguments and parameters stripped); other keys as they are."""
    key = key.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?([\w:]+?)(?:<.*>)?\(", key)
    return m.group(1).split("::")[-1] if m else key


def dot_nodes(dot: str) -> list[tuple[str, str]]:
    """(kind, function) of each node of a CUDA graph's DOT dump
    (``cudaGraphDebugDotPrint``): kind ``kernel`` with the function's name
    as :func:`kernel_name` gives it (a mangled name decoded to its last
    component), ``memset``, ``memcpy`` or ``other`` with an empty name."""
    # a node's line starts with its name and "["; an edge's with "name ->"
    starts = [m.start() for m in
              re.finditer(r'^"graph_\d+_node_\d+"\s*\[', dot, re.MULTILINE)]
    nodes = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        text = dot[a:b]
        if re.search(r"\bMEMSET\b", text):
            nodes.append(("memset", ""))
        elif re.search(r"\bMEMCPY\b", text):
            nodes.append(("memcpy", ""))
        elif re.search(r"\bKERNEL\b|\\?<\\?<\\?<", text):
            nodes.append(("kernel", dot_kernel_name(text)))
        else:
            nodes.append(("other", ""))
    return nodes


def dot_kernel_name(text: str) -> str:
    """The function of a kernel node's DOT text: the last component of a
    mangled name (``_Z20segment_count_kernelPKi...`` → segment_count_kernel,
    ``_ZN2at6native...`` → its innermost name), else of the first
    demangled signature ``name<...>(...)`` or launch ``name<<<...``."""
    m = re.search(r"\b_Z(N?)\d", text)
    if m:
        rest, parts = text[m.end() - 1:], []
        while d := re.match(r"\d+", rest):
            k = int(d.group())
            parts.append(rest[d.end():d.end() + k])
            rest = rest[d.end() + k:]
            if not m.group(1):
                break
        return parts[-1]
    m = (re.search(r"([A-Za-z_][\w:]*)\s*(?:<[^()]*>)?\s*\(", text)
         or re.search(r"([A-Za-z_][\w:]*)\s*\\?<\\?<\\?<", text))
    return m.group(1).split("::")[-1] if m else text.strip()[:60]


def graph_dot(fn) -> str:
    """One call of ``fn`` (after one warm-up call) captured in a CUDA graph
    that is never instantiated, as DOT text (``cuGraphDebugDotPrint`` of
    libcuda, verbose)."""
    import ctypes
    import tempfile

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_uint]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "graph.dot"
        rc = libcuda.cuGraphDebugDotPrint(graph.raw_cuda_graph(),
                                          str(path).encode(), 1)
        if rc != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint returned {rc}")
        return path.read_text(errors="replace")


def graph_kernels(fn) -> dict[str, int]:
    """{function: nodes} of one call of ``fn`` in its CUDA graph
    (:func:`graph_dot`), memsets, copies and other nodes under
    ``"memset"``, ``"memcpy"`` and ``"other"``: which device work a call
    enqueues, read from the graph itself, which misses no launch (unlike
    the profiler late in a long process: :func:`per_launch_ms`)."""
    dot = graph_dot(fn)
    out: dict[str, int] = {}
    for kind, name in dot_nodes(dot):
        key = name if kind == "kernel" else kind
        out[key] = out.get(key, 0) + 1
    if not out:
        raise RuntimeError(f"graph_kernels: no node in the graph's DOT dump "
                           f"({len(dot)} bytes: {dot[:200]!r})")
    return out


# profiler sessions device_profile makes at most: late in chip_smoke's
# process a session can see none of a kernel's launches (three sessions
# in a row saw no K4 launch in phase 12, NVIDIA H100 80GB HBM3, 700 W)
PROFILE_SESSIONS = 8


def device_profile(fn, calls: int = 20, expect=(),
                   sessions: int = PROFILE_SESSIONS
                   ) -> dict[str, tuple[float, float]]:
    """{device kernel name: (self device ms per call, launches per call)}
    over ``calls`` calls of ``fn`` after one warm-up call (torch.profiler).
    Late in a long process the profiler may see only some of the launches,
    or none (:func:`per_launch_ms`): a session that saw none of a function
    in ``expect`` is made again, up to ``sessions`` in all, and the last
    is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out: dict[str, tuple[float, float]] = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                ms, n = out.get(kernel_name(e.key), (0.0, 0.0))
                out[kernel_name(e.key)] = (ms + us / 1e3 / calls,
                                           n + e.count / calls)
        if all(f in out for f in expect):
            break
    return out


def per_launch_ms(prof, functions) -> float:
    """Device ms of one call that launches each of ``functions`` once, from
    :func:`device_profile`'s ``prof``: each function's time over the
    launches the profiler saw of it.  Late in a long process the profiler
    records only some of the launches, and its ms per call then falls
    short of the kernel's time (chip_smoke's phases 8 and 12, NVIDIA H100
    80GB HBM3, 700 W)."""
    return sum(prof[f][0] / prof[f][1] for f in functions)


def scale_view(dev, slots: int = SCALE_SLOTS):
    """``tools/scale.py``'s maxcap state at ``slots``: (state, data, its
    measured instance cap)."""
    from event3dgs_tpu_torch.tools import scale
    from event3dgs_tpu_torch.train.loop import measure_instance_cap

    state, data = scale.maxcap_scene(slots, WIDTH, HEIGHT, dev)
    return state, data, measure_instance_cap(state.params, data.cameras)


def main_view_binning(state, data, icap):
    """The Binning of the step's main view (camera 1) of ``state`` at the
    instance cap ``icap``."""
    import torch

    from event3dgs_tpu_torch.models import activated
    from event3dgs_tpu_torch.ops import binning
    from event3dgs_tpu_torch.ops.projection import project_gaussians

    cam = data.cameras[1]
    act = activated(state.params)
    with torch.no_grad():
        proj = project_gaussians(act.means3d, act.scales, act.rotations, cam,
                                 opacities=act.opacities)
        return binning.bin_gaussians(
            proj.mean2d, proj.depth, proj.radius, proj.valid, cam.width,
            cam.height, icap, opacities=act.opacities, conic=proj.conic)


def k3_inputs(b, rows):
    """K3's arguments at the Binning ``b`` for the slot rows ``rows``: the
    rows read through ``b.dest``, as the rasterizer hands them over; the
    same rows put into expansion order (zero where an instance was
    dropped) with an identity ``dest``; and, for ``torch.segment_reduce``,
    the ordered rows of the segments and their lengths."""
    import torch

    limit, n_rows = b.dest.shape[0], rows.shape[0]
    d = b.dest.long()
    ordered = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])[
        torch.where((d >= 0) & (d < n_rows), d, n_rows)]
    ident = torch.arange(limit, dtype=torch.int32, device=d.device)
    starts, ends = b.offsets[:-1], b.offsets[1:]
    off = torch.clamp(b.offsets.long(), max=limit)
    return ((rows, starts, ends, limit, b.dest, b.order),
            (ordered, starts, ends, limit, ident, b.order),
            (ordered[:int(off[-1])], off[1:] - off[:-1]))


def k3_timing(b, what: str) -> dict:
    """K3 at the Binning ``b``: graph ms through ``dest`` and over rows in
    expansion order, ``torch.segment_reduce``'s ms over those rows, its
    bound, whether the two calls and the plain version agree bit for bit,
    and a digest of the sums."""
    import torch

    from event3dgs_tpu_torch.ops import segscan

    g = torch.Generator().manual_seed(K3_SEED)
    via_dest, ordered, (rows, lengths) = k3_inputs(
        b, torch.randn(b.dest.shape[0], 9, generator=g).to(b.dest.device))
    out = segscan.segment_sums_kernel(*via_dest)
    same = (torch.equal(out, segscan.segment_sums_kernel(*ordered))
            and torch.equal(out, segscan.segment_sums_plain(*via_dest)))
    n, limit = b.offsets.shape[0] - 1, b.dest.shape[0]
    live = int(b.tile_counts.sum())
    bound, by = bound_ms(segment_sums_bytes(
        live, min(int(b.offsets[-1]), limit), n), (live * 9, 0))
    rec = {"k3": what, "segments": n, "slots": limit,
           "instances": min(int(b.offsets[-1]), limit), "live": live,
           "graph_ms_dest": graph_ms(
               lambda: segscan.segment_sums_kernel(*via_dest)),
           "graph_ms_expansion_order": graph_ms(
               lambda: segscan.segment_sums_kernel(*ordered)),
           "library_ms": cuda_ms(
               lambda: torch.segment_reduce(rows, "sum", lengths=lengths),
               20),
           "bound_ms": bound, "bound_by": by,
           "digest": zlib.crc32(out.cpu().numpy().tobytes())}
    if hasattr(segscan, "by_output_order"):  # a tree with both orders
        for key, by_output in (("rank", False), ("output", True)):
            call = lambda: segscan.segment_sums_kernel(*via_dest,
                                                       by_output=by_output)
            rec[f"graph_ms_{key}_order"] = graph_ms(call)
            same = same and torch.equal(call(), out)
    balanced = k3_balanced(via_dest, out)  # None: a tree without the build
    if balanced is not None:
        rec["balanced_graph_ms_dest"], balanced_same = balanced
        same = same and balanced_same
    rec["equal"] = same
    return rec


def k3_balanced(args, want):
    """K3's timing-only build with one owner per segment in rank order and
    warps balanced by instances (``E3D_K3_BALANCED``) on ``args`` (rows of
    9 floats through ``dest``): (its graph ms, whether its sums equal
    ``want`` bit for bit); None where this tree's source has no such
    build."""
    import torch

    from event3dgs_tpu_torch.ops import kernels

    if "E3D_K3_BALANCED" not in kernels.sources("segsum")[0].read_text():
        return None
    kernels.build([("segsum", K3_BALANCED)])
    rows, starts, ends, limit, dest, order = args
    n_seg = starts.shape[0]
    scratch = torch.empty(-(-(n_seg + limit) // K3_BALANCED_ITEMS) + 2,
                          dtype=torch.int32, device=rows.device)

    def call():
        out = torch.empty(n_seg, 9, dtype=torch.float32, device=rows.device)
        kernels.launch("segsum", "e3d_segment_sums_balanced",
                       rows.data_ptr(), rows.shape[0], dest.data_ptr(),
                       starts.data_ptr(), ends.data_ptr(), n_seg, limit,
                       order.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                       scratch.shape[0], defines=K3_BALANCED)
        return out

    return graph_ms(call), torch.equal(call(), want)


def sweep_segments(n_seg: int, dev, seed: int = K3_SEED):
    """K3's arguments for ``n_seg`` Gaussians shaped like the 2M-slot
    step's main view: 86.5 % of the segments with Poisson(1.5) instances,
    the rest empty and last; twice as many slots, their rows in a random
    (tile) order, past the instances the drop value; ``order`` a random
    permutation."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    live = int(n_seg * 0.865)
    lens = torch.zeros(n_seg, device=dev)
    lens[:live] = torch.poisson(torch.full((live,), 1.5, device=dev),
                                generator=g)
    offsets = torch.zeros(n_seg + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0).to(torch.int32)
    total = int(offsets[-1])
    slots = max(2 * n_seg, total)
    dest = torch.full((slots,), slots, dtype=torch.int32, device=dev)
    dest[:total] = torch.randperm(slots, generator=g, device=dev)[
        :total].to(torch.int32)
    order = torch.randperm(n_seg, generator=g, device=dev).to(torch.int32)
    rows = torch.randn(slots, 9, generator=g, device=dev)
    return rows, offsets[:-1], offsets[1:], slots, dest, order


def k3_sweep(dev, sizes=K3_SWEEP) -> list[dict]:
    """This tree's K3 in rank and in output order at each size of
    ``sizes`` (:func:`sweep_segments`): graph ms of each, the sums' MB
    against the card's L2, and whether both equal the plain version."""
    import torch

    from event3dgs_tpu_torch.ops import segscan

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    out = []
    for n in sizes:
        args = sweep_segments(n, dev)
        want = segscan.segment_sums_plain(*args)
        rec = {"k3_sweep": n, "sums_mb": n * 36 / 1e6, "l2_mb": l2 / 1e6,
               "auto": "output" if segscan.by_output_order(9, n, l2)
               else "rank"}
        for key, by_output in (("rank", False), ("output", True)):
            call = lambda: segscan.segment_sums_kernel(*args,
                                                       by_output=by_output)
            rec[f"graph_ms_{key}_order"] = graph_ms(call)
            rec[f"equal_{key}"] = torch.equal(call(), want)
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del args, want
        torch.cuda.empty_cache()
    return out


def k3_step_orders(state, data, icap, dev, what: str,
                   rounds: int = K3_STEP_ROUNDS) -> dict:
    """The graphed event step (views 1, 1 → 2) captured twice from
    ``state``, with K3 in rank order and in output order
    (``segscan.BY_OUTPUT_L2`` set while each captures), the two graphs
    replayed in turns, ``rounds`` each: the device ms of each replay (CUDA
    events) and whether the two runs' losses agree bit for bit."""
    from unittest import mock

    import torch

    from event3dgs_tpu_torch.ops import segscan
    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    runs = {}
    for key, share in (("rank", float("inf")), ("output", 0.0)):
        step = GraphTrainStep("event", OptimizationConfig(), EventConfig(),
                              spatial_lr_scale=3.0, rasterizer="tiled",
                              instance_cap=icap)
        with mock.patch.object(segscan, "BY_OUTPUT_L2", share):
            runner = FusedSteps(step, state, data, 1)
        runner.run(torch.from_numpy(step.row(int(state.step) + 1, (1, 1, 2),
                                             np.zeros(3))[None]))
        runs[key] = (runner, [])
    for _ in range(rounds):
        for runner, ms in runs.values():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            runner.cursor.zero_()  # the table's one row again
            start.record()
            runner.graph.replay()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    rec = {"k3_step": what, "instance_cap": icap, "rounds": rounds}
    for key, (runner, ms) in runs.items():
        rec[f"replay_ms_{key}_order"] = ms
        rec[f"median_ms_{key}_order"] = float(np.median(ms))
        rec[f"digest_{key}"] = state_digest(runner.state)
        runner.release()
    rec["equal"] = rec["digest_rank"] == rec["digest_output"]
    return rec


def state_digest(state, digest: int = 0) -> int:
    """A digest of the train state's parameters and contrast."""
    p = state.params
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        digest = zlib.crc32(getattr(p, f).cpu().numpy().tobytes(), digest)
    return zlib.crc32(state.contrast.cpu().numpy().tobytes(), digest)


def graphed_digest(state, data, icap, dev, what: str,
                   steps: int = GRAPHED_STEPS) -> dict:
    """``steps`` graphed event steps after one (``tools/scale.py``'s
    ``graphed_steps``: views 1, 1 → 2) from ``state``, which they consume:
    the losses, the device ms per replay, and a digest of the losses, the
    parameters and the contrast."""
    from event3dgs_tpu_torch.tools import scale

    runner, rec = scale.graphed_steps([state], data, icap, steps, steps, dev)
    digest = state_digest(runner.state, zlib.crc32(
        np.asarray(rec["losses"], np.float32).tobytes()))
    runner.release()
    return {"graphed": what, "instance_cap": icap, "losses": rec["losses"],
            "device_ms_per_replay": rec["device_ms_per_replay"],
            "digest": digest}


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_timing: needs a CUDA card")
    from event3dgs_tpu_torch.ops import binning, kernels
    from event3dgs_tpu_torch.ops.projection import project_gaussians

    logs = kernels.build()
    print(json.dumps({"tree": tree, "ptxas": {
        f"{name}:{kernel}": ptxas_report(logs[name], kernel)
        for name, kernel in PTXAS_KERNELS}}), flush=True)
    dev = torch.device("cuda")
    n = N_GAUSSIANS
    means, scales, rots, opac, _ = bench_scene(np.random.default_rng(0), n)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    opacities = f(opac)
    fields = ("inst_gauss", "tile_offsets", "tile_counts", "dest", "overflow",
              "offsets", "order")
    binnings = {}
    for view, i, cap in VIEWS:
        cam = bench_camera(i, WIDTH, HEIGHT, dev)
        proj = project_gaussians(f(means), f(scales), f(rots), cam,
                                 opacities=opacities)
        call = lambda: binning.bin_gaussians(
            proj.mean2d, proj.depth, proj.radius, proj.valid, WIDTH, HEIGHT,
            cap, opacities=opacities, conic=proj.conic)
        out = binnings[view] = call()
        digest = 0
        for field in fields:
            digest = zlib.crc32(getattr(out, field).cpu().numpy().tobytes(),
                                digest)
        prof = device_profile(call)
        print(json.dumps({
            "tree": tree, "view": view, "cap": cap,
            "live": int(out.offsets[n]), "digest": digest,
            "device_us": {k: round(v[0] * 1e3, 3) for k, v in sorted(prof.items())},
            "device_us_total": sum(v[0] for v in prof.values()) * 1e3,
            "device_ops": sum(v[1] for v in prof.values()),
            "event_ms": cuda_ms(call, 50),
        }), flush=True)
    print(json.dumps({"tree": tree, **reference_step(dev)}), flush=True)
    print(json.dumps({"tree": tree, **k3_timing(binnings["train"], "100k")}),
          flush=True)
    del binnings
    state, data, icap = bench_state(dev)
    print(json.dumps({"tree": tree, **graphed_digest(state, data, icap, dev,
                                                     "100k")}), flush=True)
    del state, data
    state, data, icap = scale_view(dev)
    b = main_view_binning(state, data, icap)
    print(json.dumps({"tree": tree, **k3_timing(b, "2M")}), flush=True)
    del b
    torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, **graphed_digest(state, data, icap, dev,
                                                     "2M")}), flush=True)


def reference_step(dev) -> dict:
    """``bench.py``'s event train step (views 1, 1 → 2) on the reference
    rasterizer at ``REFERENCE_STEP``'s size: its ms per step over 10 steps
    of one state (CUDA events), peak memory, and the loss's bits."""
    import torch

    from event3dgs_tpu_torch.train.step import make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    n, width, height = REFERENCE_STEP
    state, data, _ = bench_state(dev, n, width, height)
    step = make_train_step("event", OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=3.0, rasterizer="reference")
    bg = torch.zeros(3, device=dev)
    _, m = step(state, data, 1, 1, 2, bg)
    loss = m["loss"].detach().float().cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, data, 1, 1, 2, bg), 10)
    return {"step": "event, reference rasterizer", "gaussians": n,
            "width": width, "height": height,
            "digest": zlib.crc32(loss.tobytes()), "event_ms": ms,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+")
    parser.add_argument("--k3", action="store_true",
                        help="time this tree's K3 in both orders, alone by "
                        "size and in the graphed step")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    if args.k3:
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
        import torch

        if not torch.cuda.is_available():
            sys.exit("kernel_timing: needs a CUDA card")
        dev = torch.device("cuda")
        recs = k3_sweep(dev)
        steps = []
        for what, make in (("100k", lambda: bench_state(dev)),
                           ("2M", lambda: scale_view(dev))):
            state, data, icap = make()
            steps.append(k3_step_orders(state, data, icap, dev, what))
            print(json.dumps(steps[-1]), flush=True)
            del state, data
            torch.cuda.empty_cache()
        print(card())
        print("Gaussians  sums MB  graph ms: rank order  output order  "
              "wrapper takes  equal")
        for r in recs:
            print(f"{r['k3_sweep']:9d} {r['sums_mb']:8.1f} "
                  f"{r['graph_ms_rank_order']:20.4f} "
                  f"{r['graph_ms_output_order']:13.4f} {r['auto']:>14s}  "
                  f"{r['equal_rank'] and r['equal_output']}")
        print(f"graphed event step, K3 in each order, {K3_STEP_ROUNDS} "
              "replays each in turns: median device ms per replay "
              "(min-max)")
        for r in steps:
            cols = "  ".join(
                f"{key} order {r[f'median_ms_{key}_order']:.4f} "
                f"({min(r[f'replay_ms_{key}_order']):.4f}-"
                f"{max(r[f'replay_ms_{key}_order']):.4f})"
                for key in ("rank", "output"))
            print(f"{r['k3_step']:5s} {cols}  equal {r['equal']}")
        ok = all(r["equal_rank"] and r["equal_output"] for r in recs)
        return 0 if ok and all(r["equal"] for r in steps) else 1
    if not args.trees:
        parser.error("give --trees or --k3")
    rows, steps, k3, graphed = [], [], [], []
    for tree in args.trees:
        tree = str(Path(tree).resolve())
        out = subprocess.run([sys.executable, __file__, "--trees", tree,
                              "--worker", tree], capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"kernel_timing: {tree} failed", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line)
            rec = json.loads(line) if line.startswith("{") else {}
            for key, runs in (("view", rows), ("step", steps), ("k3", k3),
                              ("graphed", graphed)):
                if key in rec:
                    runs.append(rec)
    for view, _, _ in VIEWS:
        digests = {r["digest"] for r in rows if r["view"] == view}
        if len(digests) != 1:
            print(f"kernel_timing: the trees' outputs differ at the {view} view",
                  file=sys.stderr)
            return 1
    if len({r["digest"] for r in steps}) != 1:
        print("kernel_timing: the trees' reference steps differ in loss",
              file=sys.stderr)
        return 1
    for key, runs in (("k3", k3), ("graphed", graphed)):
        for what in {r[key] for r in runs}:
            if len({r["digest"] for r in runs if r[key] == what}) != 1:
                print(f"kernel_timing: the trees differ in {key} at {what}",
                      file=sys.stderr)
                return 1
    if not all(r["equal"] for r in k3):
        print("kernel_timing: K3 through dest, over ordered rows and its "
              "plain version differ", file=sys.stderr)
        return 1
    print(card())
    print("view    run tree                              device us  ops  event ms")
    for k, r in enumerate(rows):
        print(f"{r['view']:7s} {k // len(VIEWS) + 1:3d} {r['tree'][-32:]:32s} "
              f"{r['device_us_total']:10.3f} {r['device_ops']:4.0f} "
              f"{r['event_ms']:9.4f}")
    n, width, height = REFERENCE_STEP
    print(f"event step, reference rasterizer, {n} Gaussians at "
          f"{width}x{height}: run tree  ms per step  peak MiB")
    for k, r in enumerate(steps):
        print(f"{k + 1:3d} {r['tree'][-32:]:32s} {r['event_ms']:10.3f} "
              f"{r['peak_mib']:9.1f}")
    print("K3  run tree                             graph ms: via dest  "
          "rows in order  rank order  output order  balanced build  "
          "segment_reduce ms  bound ms")
    opt = lambda r, key, w: f"{'-' if key not in r else f'{r[key]:.4f}':>{w}s}"
    for k, r in enumerate(k3):
        print(f"{r['k3']:4s}{k // 2 + 1:3d} {r['tree'][-32:]:32s} "
              f"{r['graph_ms_dest']:18.4f} {r['graph_ms_expansion_order']:14.4f} "
              f"{opt(r, 'graph_ms_rank_order', 11)} "
              f"{opt(r, 'graph_ms_output_order', 13)} "
              f"{opt(r, 'balanced_graph_ms_dest', 15)} "
              f"{r['library_ms']:18.4f} {r['bound_ms']:9.4f}")
    print(f"graphed event step ({GRAPHED_STEPS} replays after one): run tree"
          "  device ms per replay  losses")
    for k, r in enumerate(graphed):
        print(f"{r['graphed']:4s}{k // 2 + 1:3d} {r['tree'][-32:]:32s} "
              f"{r['device_ms_per_replay']:10.4f} {r['losses']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
