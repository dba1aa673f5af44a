"""Profiling probes of the port's kernels on a CUDA card: the counterparts
of the JAX package's ``experiments/`` Pallas probes.

    python3 -m event3dgs_tpu_torch.tools.kernel_probes \\
        {stages,k1,k4,stops,relaunch,dyngrid,ssim,offsets,all} \\
        [--device cpu] \\
        [--gaussians N --width W --height H]

The scene is ``bench.py``'s (``kernel_timing.bench_scene``): by default
100k Gaussians from seed 0 at 1920×1080.  The render view is camera 0 at
the default instance cap (800,768 for 100k), built as
``tools/kernel_timing.py`` builds it; the train view is camera 1 of
``bench.py``'s training state (``kernel_timing.bench_state``, its measured
instance cap, 428,032 at full size), as ``chip_smoke.py``'s phase 7 builds
it.

- ``stages`` (``experiments/tools_r5_profile.py``'s stage chain): the
  event step of that training state in seven cumulative stages (projection;
  + SH colours; + binning; + pack and K1; + one render's backward; + the
  other two renders and the event loss; + Adam and the densify stats, the
  whole ``train_step``).  Per stage: the profiler's device µs and device
  kernels (memsets and copies counted beside them), CUDA-event ms and
  host-clock ms, and the difference to the stage before.
- ``k1`` and ``k4`` (``tools_exp_kernel.py``, ``tools_r5_expandprobe.py``):
  each timing-only build of K1 and K4 at the render view (``K1_VARIANTS``,
  ``K4_VARIANTS``): the profiler's device ms per call (its time over the
  launches it saw, one per call; and how many it saw), CUDA-event ms, graph ms (20 launches captured in a CUDA
  graph, replayed: no host enqueue), registers, spill bytes and resident
  blocks per SM, against ``base`` in graph ms; K1's evaluated pairs (the
  sum of its stop index), and from ``clock`` the tile imbalance.
- ``stops`` (``tools_exp_skiprate.py``): :func:`stop_statistics` of K1's
  stop index at both views.
- ``relaunch`` (``tools_profile_bwd.py``, ``tools_profile_scalar.py``):
  K1, K2 and K3 alone at the train view on the outputs of one render, device
  ms (as for ``k1``), CUDA-event ms, graph ms and bound.
- ``dyngrid`` (``tools_exp_dyngrid.py``): ``csrc/probes.cu``'s kernel,
  launched at capacity with its live count in device memory, captured once
  in a CUDA graph and replayed with n = 3 and n = 7 over ones (expects
  3·1024, then 7·1024, as its plain version), then over a seeded input
  whose float32 sums depend on the block order, at those counts and out of
  range, bit for bit against the plain version.

- ``offsets``: the depth order (``csrc/depth_sort.cu``: the radix sort and
  the depth offsets kernel) at the render view and at 2,097,152 Gaussians
  of the same recipe (``OFFSETS_LARGE``): graph ms of the call, of the
  sort and of the offsets kernel alone against their bounds, of each
  timing-only build (``OFFSETS_VARIANTS``), of ``torch.argsort`` and
  ``torch.sort`` of the same keys and of the table kernel; the sort on
  keys whose digits vary in 1-4 passes (the rest skipped); scratch bytes
  per Gaussian of the call and of ``torch.argsort``; registers and spills.

- ``ssim``: each timing-only build of the SSIM loss kernels
  (``csrc/ssim.cu``, ``SSIM_VARIANTS``), forward and backward, in rgb and
  gray mode on seeded 1080p partials and a GT frame
  (:func:`ssim_operands`): graph ms, CUDA-event ms, registers, spills,
  shared bytes and resident blocks per SM, against ``base``.

Each mode prints one JSON line; the last line is the card's name and power
limit (``nvidia-smi``).  ``--device cpu`` runs ``stages``, ``stops`` and
``dyngrid`` on the plain versions at a small size, with host times only;
``k1``, ``k4``, ``relaunch``, ``ssim`` and ``offsets`` need the card.  A
failed build or launch raises: nothing reruns on the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from event3dgs_tpu_torch.ops import binning, expand, kernels
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.tools import kernel_timing as kt

MODES = ("stages", "k1", "k4", "stops", "relaunch", "dyngrid", "ssim",
         "offsets")
# timing-only builds or device times
CARD_MODES = ("k1", "k4", "relaunch", "ssim", "offsets")
CALLS = 20  # profiled calls per kernel
STAGE_CALLS = 5  # profiled, event-timed and host-timed calls per stage
TRAIN_IDX = (1, 1, 2)  # bench.py's views: main 1, event pair 1 → 2
DYNGRID_CAPACITY = 100  # (8, 128) blocks of the probe's f32 [800, 128] input
DYNGRID_COUNTS = (3, 7)
# over the seeded input: the counts, then out of range (clamped), then 3
# again, which holds only if no earlier replay left the kernel's state set
DYNGRID_SEEDED_COUNTS = (3, 7, 0, -1, DYNGRID_CAPACITY + 5, 3)
BLOCK = 8 * 128


class Variant:
    """A build of K1 or K4 with some of its source's ablation macros,
    launched through the shipping wrapper's checks.  Every build but
    ``base`` (the shipping library) and K1's ``clock`` (the shipping
    arithmetic) is timing only: it composites or expands something else and
    has no plain version.  ``launches`` counts the calls of this build, a
    call captured into a CUDA graph included (its replays are not)."""

    def __init__(self, kernel: str, name: str, defines: tuple, what: str,
                 count_rows: bool = True):
        self.kernel, self.name, self.defines = kernel, name, defines
        self.what, self.count_rows = what, count_rows
        self.source = "rasterize_fwd" if kernel == "K1" else "expand"
        self.launches = 0

    @property
    def label(self) -> str:
        return f"{self.kernel} {self.name}"

    @property
    def timing_only(self) -> bool:
        return self.name not in ("base", "clock")

    def __call__(self, *args, clock=None):
        if self.kernel == "K1":
            out = rt.launch_composite_forward(*args, defines=self.defines,
                                              clock=clock)
        else:
            out = expand.launch_expand_instances(
                *args, count_rows=self.count_rows, defines=self.defines)
        self.launches += 1
        return out


K1_VARIANTS = {v.name: v for v in (
    Variant("K1", "base", (), "the shipping K1"),
    Variant("K1", "noexp", ("E3D_NOEXP",),
            "expf(power) and expf(logt) as (1 + x/8)^8"),
    Variant("K1", "nolog", ("E3D_NOEXP", "E3D_NOLOG"),
            "noexp, and log1pf(-alpha) as -alpha"),
    Variant("K1", "nocull", ("E3D_NOCULL",),
            "no warp cull: every warp takes every instance"),
    Variant("K1", "nocopy", ("E3D_NOCOPY",),
            "plain loads instead of the cp.async double buffer"),
    Variant("K1", "nostop", ("E3D_NOSTOP",), "no per-pixel early stop"),
    Variant("K1", "nospill", ("E3D_NOSPILL",),
            "launch bounds of 3 blocks per SM (no spill)"),
    Variant("K1", "clock", ("E3D_CLOCK",),
            "the shipping arithmetic with each block's entry and exit time"),
)}
K4_VARIANTS = {v.name: v for v in (
    Variant("K4", "base", (), "the shipping K4 with the count rows"),
    Variant("K4", "nochain", ("E3D_K4_NOCHAIN",),
            "table rows read at the rank, not through the order"),
    Variant("K4", "nostage", ("E3D_K4_NOSTAGE",),
            "no rank staging and max-scan"),
    Variant("K4", "nocull", ("E3D_K4_NOCULL",),
            "no per-slot tile and cull arithmetic"),
    Variant("K4", "nocount", (), "the shipping K4 without the count rows",
            count_rows=False),
    Variant("K4", "nostore", ("E3D_K4_NOSTORE",),
            "no 16-byte output stores"),
)}


class SsimVariant:
    """A build of the SSIM loss kernels (``csrc/ssim.cu``, forward and
    backward) with some of its ablation macros, launched through the
    shipping wrappers' checks (``losses/modes.launch_photometric_*``).
    Every build but ``base`` (the shipping library) is timing only.
    ``launches`` counts the calls of this build's forward and backward
    kernel, a call captured into a CUDA graph included (its replays are
    not)."""

    source = "ssim"

    def __init__(self, name: str, defines: tuple, what: str):
        self.name, self.defines, self.what = name, defines, what
        self.launches = dict.fromkeys(("forward", "backward"), 0)

    @property
    def label(self) -> str:
        return f"SSIM {self.name}"

    @property
    def timing_only(self) -> bool:
        return self.name != "base"

    def forward(self, *args, **kw):
        from event3dgs_tpu_torch.losses import modes

        out = modes.launch_photometric_forward(*args, defines=self.defines,
                                               **kw)
        self.launches["forward"] += 1
        return out

    def backward(self, *args, **kw):
        from event3dgs_tpu_torch.losses import modes

        out = modes.launch_photometric_backward(*args, defines=self.defines,
                                                **kw)
        self.launches["backward"] += 1
        return out


SSIM_VARIANTS = {v.name: v for v in (
    SsimVariant("base", (), "the shipping SSIM loss kernels"),
    SsimVariant("nostage", ("E3D_SSIM_NOSTAGE",),
                "zeros staged: no halo loaded or composed (forward: x and "
                "y; backward: the maps)"),
    SsimVariant("novert", ("E3D_SSIM_NOVERT",),
                "the vertical pass's centre tap copied, no 11-tap sums"),
    SsimVariant("nohoriz", ("E3D_SSIM_NOHORIZ",),
                "the horizontal pass's centre tap copied, no 11-tap sums"),
    SsimVariant("nostore", ("E3D_SSIM_NOSTORE",),
                "the maps (forward) and the gradients (backward) computed, "
                "never stored"),
)}
SSIM_SEED = 20  # of the SSIM probe's operands
# the depth order's timing-only builds (csrc/depth_sort.cu): (macros, what)
OFFSETS_VARIANTS = {
    "base": ((), "the shipping radix sort and depth offsets kernel"),
    "nogather": (("E3D_OFFSETS_NOGATHER",),
                 "the last pass reads the count at the rank, not through "
                 "the order"),
    "nolookback": (("E3D_OFFSETS_NOLOOKBACK",),
                   "every tile's prefix of a digit and every block's prefix "
                   "of the counts taken as 0"),
    "noclear": (("E3D_OFFSETS_NOCLEAR",),
                "the offsets kernel leaves the sort's state words"),
}
# (kernel, template arguments as mangled): the pass kernel's instances
# with 16 and 8 keys a thread
DEPTH_FUNCTIONS = (("radix_histogram_kernel", ""),
                   ("radix_pass_kernel", "ILi16E"),
                   ("radix_pass_kernel", "ILi8E"),
                   ("depth_offsets_kernel", ""))
# calls of each build by the offsets probe, a call captured into a CUDA
# graph included (its replays are not)
OFFSETS_LAUNCHES = dict.fromkeys(OFFSETS_VARIANTS, 0)


def offsets_builds():
    """(source, macros) of every depth order build of the probes, for
    :func:`kernels.build`."""
    return [("depth_sort", d) for d, _ in OFFSETS_VARIANTS.values()]
OFFSETS_LARGE = 2_097_152  # Gaussians of the probe's second view


def ssim_builds():
    """(source, macros) of every SSIM build of the probes, for
    :func:`kernels.build`."""
    return sorted({(v.source, v.defines) for v in SSIM_VARIANTS.values()})


def ssim_template(gray: bool) -> str:
    """The mangled template arguments of the SSIM kernels' instance for rgb
    (3 channels) or gray mode (1), for ``kernel_timing.ptxas_report``."""
    return f"ILi{1 if gray else 3}E"


def ssim_shared_bytes(backward: bool, gray: bool, defines=()) -> int:
    """The shared memory bytes (static and dynamic) a block of the SSIM
    forward (or backward) kernel holds in rgb (or gray) mode with λ > 0,
    as the build with ``defines`` reports it."""
    shared = ctypes.c_int()
    err = kernels.function("ssim", "e3d_photometric_shared_bytes", defines)(
        ctypes.byref(shared), int(backward), int(gray))
    if err != 0:
        raise RuntimeError(f"e3d_photometric_shared_bytes failed: "
                           f"cudaError_t {err}")
    return shared.value


def ssim_operands(height: int, width: int, device, seed: int = SSIM_SEED):
    """Seeded operands of the SSIM probe, in the step's forms: the render
    as ``Partials`` (rgb in [0, 1), log T in [-8, 0]) over a
    background, the GT as a ``Frame`` of a stack of 2 at a device index."""
    from event3dgs_tpu_torch.losses.event import Frame, Partials

    rng = np.random.default_rng(seed)
    f = lambda lo, hi, *shape: torch.tensor(
        rng.uniform(lo, hi, shape).astype(np.float32), device=device)
    render = Partials(f(0.0, 1.0, height, width, 3),
                      f(-8.0, 0.0, height, width))
    gt = Frame(f(0.0, 1.0, 2, height, width, 3),
               torch.tensor([1], device=device))
    return render, gt, f(0.0, 1.0, 3)


FLOAT32_MAX = float(np.finfo(np.float32).max)


def max_abs_err(got, want) -> float:
    """The largest |got - want| over pairs of tensors, a NaN or an infinity
    counted as float32's largest value (JSON has neither)."""
    worst = 0.0
    for a, b in zip(got, want):
        d = (a.double() - b.double()).abs()
        worst = max(worst, float(torch.nan_to_num(
            d, nan=FLOAT32_MAX, posinf=FLOAT32_MAX).max()))
    return min(worst, FLOAT32_MAX)


def variants():
    """Every K1 and K4 build of the probes."""
    return [*K1_VARIANTS.values(), *K4_VARIANTS.values()]


def variant_builds():
    """(source, macros) of every build the probes launch, for
    :func:`kernels.build`."""
    return sorted({(v.source, v.defines) for v in variants()})


# ---------------------------------------------------------------- dyngrid


def dyngrid_plain(x, n: int) -> torch.Tensor:
    """Plain version of the dynamic-grid kernel: the sum of the first ``n``
    (clamped to [0, blocks]) (8, 128) blocks of ``x``, added in block
    order."""
    blocks = x.reshape(-1, 8, 128)
    acc = torch.zeros(8, 128, dtype=x.dtype, device=x.device)
    for b in range(max(0, min(n, blocks.shape[0]))):
        acc = acc + blocks[b]
    return acc


def dyngrid_input(device, seed: int = 0) -> torch.Tensor:
    """The probe's seeded f32 [800, 128] input: normal values scaled by
    2^(b mod 24 - 12) in block b, so that a float32 sum over the blocks
    depends on the order they are added in."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((DYNGRID_CAPACITY, 8, 128)).astype(np.float32)
    x *= (2.0 ** (np.arange(DYNGRID_CAPACITY) % 24 - 12)).astype(
        np.float32)[:, None, None]
    return torch.from_numpy(x.reshape(-1, 128)).to(device)


def dyngrid_kernel(x, n, partials, arrived, out) -> None:
    """Launch ``csrc/probes.cu``'s kernel at capacity on CUDA tensors:
    ``out`` [8, 128] = the sum of the first ``n[0]`` (a device int32,
    clamped to [0, capacity]) (8, 128) blocks of ``x``; ``partials`` is
    scratch of ``x``'s size, ``arrived`` one int32 that is 0 before the
    first launch (the kernel clears it).  ``launches`` counts the calls,
    a call captured into a CUDA graph included (its replays are not)."""
    capacity = x.numel() // BLOCK
    kernels.check(x, torch.float32, "x", (capacity * 8, 128))
    kernels.check(n, torch.int32, "n", (1,))
    kernels.check(partials, torch.float32, "partials", tuple(x.shape))
    kernels.check(arrived, torch.int32, "arrived", (1,))
    kernels.check(out, torch.float32, "out", (8, 128))
    kernels.launch("probes", "e3d_dyngrid_sum", x.data_ptr(), capacity,
                   n.data_ptr(), partials.data_ptr(), arrived.data_ptr(),
                   out.data_ptr())
    dyngrid_kernel.launches += 1


dyngrid_kernel.launches = 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def dyngrid(device) -> dict:
    """The dynamic-grid probe.  On the card: the kernel captured once in a
    ``torch.cuda.CUDAGraph`` (after one launch outside it, which loads the
    library) and replayed with the live count written into device memory
    between replays: over ones at ``DYNGRID_COUNTS`` (the JAX probe's
    3·1024 and 7·1024), then over :func:`dyngrid_input` at
    ``DYNGRID_SEEDED_COUNTS`` (out-of-range counts included), each replay
    held bit for bit against the plain version.  On the CPU the plain
    version alone."""
    ones = torch.ones(DYNGRID_CAPACITY * 8, 128, device=device)
    seeded = dyngrid_input(device)
    reverse = seeded.reshape(-1, 8, 128)
    rec = {"mode": "dyngrid", "capacity": DYNGRID_CAPACITY,
           "expected": {str(n): n * BLOCK for n in DYNGRID_COUNTS},
           "plain": {str(n): float(dyngrid_plain(ones, n).sum())
                     for n in DYNGRID_COUNTS},
           # the seeded sums change when the blocks are added in reverse
           "order_sensitive": {str(n): not torch.equal(
               dyngrid_plain(seeded, n),
               dyngrid_plain(reverse[:n].flip(0).reshape(-1, 128), n))
               for n in DYNGRID_COUNTS}}
    if ones.device.type == "cpu":
        return rec
    x = ones.clone()
    n_dev = torch.ones(1, dtype=torch.int32, device=device)
    partials = torch.empty_like(x)
    arrived = torch.zeros(1, dtype=torch.int32, device=device)
    out = torch.empty(8, 128, device=device)
    args = (x, n_dev, partials, arrived, out)
    dyngrid_kernel(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dyngrid_kernel(*args)

    def replay(n: int) -> torch.Tensor:
        n_dev.copy_(torch.tensor([n], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        return out.clone()

    replays, equal = {}, {}
    for n in DYNGRID_COUNTS:
        got = replay(n)
        replays[str(n)] = float(got.sum())
        equal[str(n)] = bool(torch.equal(_bits(got),
                                         _bits(dyngrid_plain(ones, n))))
    x.copy_(seeded)
    seeded_equal, err = {}, 0.0
    for n in DYNGRID_SEEDED_COUNTS:
        got, want = replay(n), dyngrid_plain(seeded, n)
        seeded_equal[str(n)] = bool(torch.equal(_bits(got), _bits(want)))
        err = max(err, float((got - want).abs().max()))
    n = DYNGRID_COUNTS[-1]
    n_dev.fill_(n)
    rec.update(
        replays=replays, equal_to_plain=equal,
        seeded_equal_to_plain=seeded_equal, max_abs_err=err,
        # at the last count: a replay, the plain version, and one PyTorch
        # sum over the blocks
        replay_ms=kt.cuda_ms(graph.replay, CALLS),
        plain_ms=kt.cuda_ms(lambda: dyngrid_plain(x, n), 5, warmup=1),
        library_ms=kt.cuda_ms(lambda: x.view(-1, BLOCK)[:n].sum(0), CALLS),
        bound_ms=kt.bound_ms(n * BLOCK * 4 * 3 + BLOCK * 4, (0, 0))[0])
    return rec


# ------------------------------------------------------------------ stops


def stop_statistics(stop, tile_counts, width: int, height: int) -> dict:
    """How early K1 stops, from its [H, W] stop index (one past the last
    instance of the tile's list a pixel evaluated; the tile's count if it
    never stopped) and the tiles' instance counts:

    - ``pixel_share``: the share of the image's pixels that stop before
      their tile's last instance;
    - ``sub_block_share``: the share of 16×8 warp sub-blocks (their pixels
      inside the image) whose every pixel stops early;
    - ``tile_share``: the share of tiles whose every pixel stops early (the
      whole block leaves early);
    - ``unevaluated`` and ``evaluated``: the (pixel, instance) pairs of the
      tiles' lists past each pixel's stop, and before it, and their ratio.
    """
    dev = stop.device
    tiles_x, tiles_y = binning.tile_grid(width, height)
    y = torch.arange(height, device=dev)[:, None]
    x = torch.arange(width, device=dev)[None, :]
    tile = (y // binning.TILE_H) * tiles_x + x // binning.TILE_W
    count = tile_counts.long()[tile]
    stop = stop.long()
    early = (stop < count).long()
    sub = (tile * 8 + (y % binning.TILE_H) // rt.SUB_H * 2
           + (x % binning.TILE_W) // rt.SUB_W).reshape(-1)

    def all_early(group, size):
        pixels = torch.zeros(size, dtype=torch.long, device=dev)
        pixels.index_add_(0, group, torch.ones_like(group))
        hits = torch.zeros(size, dtype=torch.long, device=dev)
        hits.index_add_(0, group, early.reshape(-1))
        present = pixels > 0
        return int(present.sum()), int(((hits == pixels) & present).sum())

    n_sub, early_sub = all_early(sub, tiles_x * tiles_y * 8)
    n_tiles, early_tiles = all_early(tile.reshape(-1), tiles_x * tiles_y)
    evaluated = int(stop.sum())
    unevaluated = int((count - stop).clamp(min=0).sum())
    pixels = width * height
    return {
        "pixels": pixels, "early_pixels": int(early.sum()),
        "pixel_share": int(early.sum()) / pixels,
        "sub_blocks": n_sub, "early_sub_blocks": early_sub,
        "sub_block_share": early_sub / n_sub,
        "tiles": n_tiles, "early_tiles": early_tiles,
        "tile_share": early_tiles / n_tiles,
        "evaluated": evaluated, "unevaluated": unevaluated,
        "unevaluated_per_evaluated": unevaluated / max(evaluated, 1),
    }


# ----------------------------------------------------------------- stages


def event_step_stages(state, data, idx, bg, instance_cap: int,
                      opt_cfg=None, event_cfg=None, spatial_lr_scale=3.0,
                      max_sh_degree: int = 3):
    """The event step of ``state`` in seven cumulative stages: [(name,
    callable)], each callable running the step from ``state`` up to and
    including its stage and returning what it computed.  Stages 1-5 work on
    the main view ``idx[0]`` as a render of it alone does (the step projects
    its three views in one call); 6 is ``make_loss_and_grads``, 7
    ``make_train_step``."""
    from event3dgs_tpu_torch.ops.preprocess import masked_features
    from event3dgs_tpu_torch.ops.projection import project_gaussians
    from event3dgs_tpu_torch.ops.render import gaussian_colors, render_partials
    from event3dgs_tpu_torch.train.step import (
        make_loss_and_grads,
        make_train_step,
        step_inputs,
    )
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    opt_cfg = OptimizationConfig() if opt_cfg is None else opt_cfg
    event_cfg = EventConfig() if event_cfg is None else event_cfg
    cam = data.cameras[idx[0]]
    cap = -(-int(instance_cap) // 1024) * 1024  # as rasterize_tiled_partials

    def projection():
        inp = step_inputs(state, max_sh_degree)
        act = inp.act
        proj = project_gaussians(act.means3d, act.scales, act.rotations, cam,
                                 opacities=act.opacities)
        return inp, proj._replace(mean2d=proj.mean2d + inp.tap)

    def features(inp):  # the step's masked features, as one render reads
        return masked_features(inp.leaves["features_dc"],
                               inp.leaves["features_rest"], inp.cmask)

    def colors():
        inp, proj = projection()
        return inp, proj, gaussian_colors(max_sh_degree, features(inp),
                                          inp.act.means3d, cam.camera_center)

    def binned():
        inp, proj, rgb = colors()
        with torch.no_grad():
            b = binning.bin_gaussians(
                proj.mean2d, proj.depth, proj.radius, proj.valid, cam.width,
                cam.height, cap, opacities=inp.act.opacities, conic=proj.conic)
        return inp, proj, rgb, b

    def forward(inp=None):
        inp = step_inputs(state, max_sh_degree) if inp is None else inp
        act = inp.act
        out = render_partials(act.means3d, features(inp), act.opacities,
                              act.scales, act.rotations, cam,
                              sh_degree=max_sh_degree, mean2d_tap=inp.tap,
                              rasterizer="tiled", instance_cap=instance_cap)
        return inp, out

    def backward():
        inp, out = forward()
        inputs = [*inp.leaves.values(), inp.tap]
        grads = torch.autograd.grad(out.rgb.sum() + out.logt.sum(), inputs,
                                    allow_unused=True)
        return out, grads

    loss_and_grads = make_loss_and_grads(
        "event", event_cfg, event_cfg.event_lambda_dssim, max_sh_degree,
        rasterizer="tiled", instance_cap=instance_cap)
    step = make_train_step("event", opt_cfg, event_cfg, max_sh_degree,
                           spatial_lr_scale=spatial_lr_scale,
                           rasterizer="tiled", instance_cap=instance_cap)
    return [
        ("projection", projection),
        ("+ SH colours", colors),
        ("+ binning", binned),
        ("+ pack and K1", forward),
        ("+ one render's backward", backward),
        ("+ two renders and the event loss",
         lambda: loss_and_grads(state, data, *idx, bg)),
        ("+ Adam and densify stats", lambda: step(state, data, *idx, bg)),
    ]


def host_ms(fn, calls: int) -> float:
    """Median host-clock ms of ``fn``, each call ending in a synchronise
    (on a card)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    fn()
    sync()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_split(prof) -> tuple[float, float, float]:
    """(device µs, device kernels, memsets and copies) per call from
    :func:`kernel_timing.device_profile`'s table."""
    other = {k for k in prof if k.startswith(("Memset", "Memcpy"))}
    return (sum(v[0] for v in prof.values()) * 1e3,
            sum(v[1] for k, v in prof.items() if k not in other),
            sum(prof[k][1] for k in other))


# ------------------------------------------------------------------ views


@dataclass
class RenderView:
    """bench.py's scene binned at camera 0 for K1 and K4."""

    k1_args: tuple
    k4_args: tuple
    live: int  # instances after the ellipse cull


@dataclass
class TrainView:
    """bench.py's training state, its main view rendered through the
    kernels (held outputs for relaunching K1, K2 and K3)."""

    state: object
    data: object
    cap: int
    k1_args: tuple = ()
    k2_args: tuple = ()
    binning: object = None
    stop: torch.Tensor | None = None  # K1's stop index
    rows: torch.Tensor | None = None  # K2's rows


@dataclass
class Probes:
    """The probes' scene at one size on one device, and each mode's
    record (``records``) and outputs for the caller's checks
    (``outputs``)."""

    device: torch.device
    n: int = kt.N_GAUSSIANS
    width: int = kt.WIDTH
    height: int = kt.HEIGHT
    records: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)
    _render: RenderView | None = None
    _train: TrainView | None = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def render_view(self) -> RenderView:
        if self._render is None:
            from event3dgs_tpu_torch.ops.projection import project_gaussians

            means, scales, rots, opac, colors = kt.bench_scene(
                np.random.default_rng(0), self.n)
            f = lambda a: torch.tensor(a, dtype=torch.float32,
                                       device=self.device)
            cam = kt.bench_camera(0, self.width, self.height, self.device)
            opacities = f(opac)
            proj = project_gaussians(f(means), f(scales), f(rots), cam,
                                     opacities=opacities)
            cap = rt.default_instance_cap(self.n)
            args = (proj.mean2d, proj.depth, proj.radius, proj.valid,
                    self.width, self.height)
            kw = dict(opacities=opacities, conic=proj.conic)
            b = binning.bin_gaussians(*args, cap, **kw)
            tables = binning.gaussian_tables(*args, **kw)
            ranks = binning.depth_order(tables, cap)
            nt = b.tile_counts.shape[0]
            feat = rt.pack_features(proj.mean2d, proj.conic, f(colors),
                                    opacities)
            self._render = RenderView(
                k1_args=(b.inst_gauss, b.tile_offsets, b.tile_counts, feat,
                         b.num_tiles_x, self.width, self.height),
                k4_args=(tables.rect, tables.cull, *ranks, cap,
                         b.num_tiles_x, nt),
                live=int(b.tile_counts.sum()))
        return self._render

    def train_view(self) -> TrainView:
        if self._train is None:
            state, data, cap = kt.bench_state(self.device, self.n, self.width,
                                              self.height)
            self._train = TrainView(state, data, cap)
        return self._train

    def held_render(self) -> TrainView:
        """The train view's main render through the kernels, its outputs
        held: K1's inputs, K2's (with upstream gradients from seed 7) and
        K2's rows."""
        tv = self.train_view()
        if tv.binning is None:
            from event3dgs_tpu_torch.models import activated
            from event3dgs_tpu_torch.ops.projection import project_gaussians
            from event3dgs_tpu_torch.ops.render import gaussian_colors

            cam = tv.data.cameras[TRAIN_IDX[0]]
            with torch.no_grad():
                act = activated(tv.state.params)
                proj = project_gaussians(act.means3d, act.scales,
                                         act.rotations, cam,
                                         opacities=act.opacities)
                colors = gaussian_colors(3, act.features, act.means3d,
                                         cam.camera_center)
                b = binning.bin_gaussians(
                    proj.mean2d, proj.depth, proj.radius, proj.valid,
                    self.width, self.height, tv.cap,
                    opacities=act.opacities, conic=proj.conic)
                feat = rt.pack_features(proj.mean2d, proj.conic, colors,
                                        act.opacities)
            tv.k1_args = (b.inst_gauss, b.tile_offsets, b.tile_counts, feat,
                          b.num_tiles_x, self.width, self.height)
            _, logt, stop = rt.composite_forward(*tv.k1_args)
            g = torch.Generator().manual_seed(7)
            g_rgb = (torch.rand(self.height, self.width, 3, generator=g)
                     - 0.5).to(self.device)
            g_logt = (torch.rand(self.height, self.width, generator=g)
                      - 0.5).to(self.device)
            tv.k2_args = tv.k1_args + (g_rgb, g_logt, logt, stop, tv.cap)
            tv.binning, tv.stop = b, stop
            tv.rows = rt.composite_backward(*tv.k2_args)
        return tv

    # -------------------------------------------------------------- modes

    def stages(self) -> dict:
        tv = self.train_view()
        bg = torch.zeros(3, device=self.device)
        rows, before = [], None
        for k, (name, fn) in enumerate(event_step_stages(
                tv.state, tv.data, TRAIN_IDX, bg, tv.cap), 1):
            row = {"stage": k, "name": name,
                   "host_ms": host_ms(fn, STAGE_CALLS)}
            if self.on_card:
                us, ops, other = device_split(
                    kt.device_profile(fn, STAGE_CALLS))
                row.update(device_us=us, kernels=ops, memsets_copies=other,
                           event_ms=kt.cuda_ms(fn, STAGE_CALLS, warmup=1))
            if before is not None:
                row["added"] = {key: row[key] - before[key] for key in (
                    "host_ms", "device_us", "kernels", "memsets_copies",
                    "event_ms") if key in row}
            rows.append(row)
            before = row
        return {"mode": "stages", "cap": tv.cap, "stages": rows}

    def k1(self) -> dict:
        rv = self.render_view()
        shipping = rt.composite_forward(*rv.k1_args)  # the shipping K1
        base = None
        rows, outputs = [], {"shipping": shipping}
        for v in K1_VARIANTS.values():
            clock = None
            if v.name == "clock":
                clock = torch.empty(rv.k1_args[2].shape[0], 2,
                                    dtype=torch.int64, device=self.device)
            call = lambda: v(*rv.k1_args, clock=clock)
            out = call()
            row = self._variant_row(v, call, "composite_forward_kernel", base)
            row["evaluated_pairs"] = int(out[2].long().sum())
            row["max_abs_err_vs_shipping"] = float(
                (out[0] - shipping[0]).abs().max())
            if v.name == "clock":
                torch.cuda.synchronize()
                row["imbalance"] = clock_imbalance(clock, row["blocks_per_sm"])
            if v.name in ("base", "clock"):
                outputs[v.name] = out
            base = row if base is None else base
            rows.append(row)
        self.outputs["k1"] = outputs
        return {"mode": "k1", "live_instances": rv.live, "variants": rows}

    def k4(self) -> dict:
        rv = self.render_view()
        shipping = expand.expand_instances(*rv.k4_args, True)
        base = None
        rows = []
        for v in K4_VARIANTS.values():
            call = lambda: v(*rv.k4_args)
            out = call()
            row = self._variant_row(v, call, "expand_kernel", base)
            row["max_abs_err_vs_shipping"] = float(
                (out.tile - shipping.tile).abs().max())
            base = row if base is None else base
            rows.append(row)
        return {"mode": "k4", "cap": rv.k4_args[5], "variants": rows}

    def _variant_row(self, v: Variant, call, function: str, base) -> dict:
        """A build's device and event ms per call, its -Xptxas -v report
        and its resident blocks per SM, against ``base``'s row."""
        log = kernels.build([(v.source, v.defines)])[
            kernels.build_key(v.source, v.defines)]
        report = kt.ptxas_report(log, function)
        if v.kernel == "K1":
            occ = kernels.occupancy(v.source, "e3d_composite_forward_occupancy",
                                    defines=v.defines)
        else:
            nt = self.render_view().k4_args[-1] if v.count_rows else 0
            occ = kernels.occupancy(v.source, "e3d_expand_occupancy", nt,
                                    defines=v.defines)
        prof = kt.device_profile(call, CALLS, expect=(function,))
        if function not in prof:
            raise RuntimeError(f"{v.label}: the profiler saw no {function}")
        row = {"variant": v.name, "defines": list(v.defines), "what": v.what,
               "timing_only": v.timing_only,
               "library": kernels.library_path(v.source, v.defines).name,
               "device_ms": kt.per_launch_ms(prof, (function,)),
               "profiled_per_call": prof[function][1],
               "event_ms": kt.cuda_ms(call, CALLS),
               "graph_ms": kt.graph_ms(call, CALLS),
               **report, "blocks_per_sm": occ[1]}
        if base is not None:  # in graph time, which no host work enters
            row["vs_base_ms"] = row["graph_ms"] - base["graph_ms"]
            row["vs_base_share"] = row["graph_ms"] / base["graph_ms"]
        return row

    def stops(self) -> dict:
        rv = self.render_view()
        _, _, stop = rt.composite_forward(*rv.k1_args)
        tv = self.held_render()
        rec = {"mode": "stops",
               "render": stop_statistics(stop, rv.k1_args[2], self.width,
                                         self.height),
               "train": stop_statistics(tv.stop, tv.k1_args[2],
                                        self.width, self.height)}
        if self.on_card:  # the statistics' own time at the render view
            rec["statistics_ms"] = kt.cuda_ms(lambda: stop_statistics(
                stop, rv.k1_args[2], self.width, self.height), 5, warmup=1)
        self.outputs["stops"] = {"render_stop": stop}
        return rec

    def relaunch(self) -> dict:
        tv = self.held_render()
        b = tv.binning
        live = int(b.tile_counts.sum())
        n, nt = tv.k1_args[3].shape[0], b.tile_counts.shape[0]
        slots = min(int(b.offsets[-1]), tv.cap)
        pairs = rt._composite_plain(*tv.k1_args)[3].tolist()
        timed = {
            "K1 composite_forward": (
                lambda: rt.composite_forward_kernel(*tv.k1_args),
                "composite_forward_kernel",
                (kt.composite_bytes(live, n, nt, self.width, self.height),
                 kt.pair_ops(pairs, kt.K1_PAIR_OPS))),
            "K2 composite_backward": (
                lambda: rt.composite_backward_kernel(*tv.k2_args),
                "composite_backward_kernel",
                (kt.composite_bytes(live, n, nt, self.width, self.height,
                                    backward=True),
                 kt.pair_ops(pairs, kt.K2_PAIR_OPS))),
            "K3 segment_sums": (
                lambda: rt.gaussian_grads(b, tv.rows),
                "segment_sums_kernel",
                (kt.segment_sums_bytes(live, slots, n), (live * rt.NGRAD, 0))),
        }
        rows = []
        for name, (call, function, work) in timed.items():
            prof = kt.device_profile(call, CALLS, expect=(function,))
            if function not in prof:
                raise RuntimeError(f"{name}: the profiler saw no {function}")
            bound, by = kt.bound_ms(*work)
            graph = kt.graph_ms(call, CALLS)
            rows.append({"kernel": name,
                         "device_ms": kt.per_launch_ms(prof, (function,)),
                         "profiled_per_call": prof[function][1],
                         "event_ms": kt.cuda_ms(call, CALLS), "graph_ms": graph,
                         "bound_ms": bound, "bound_by": by,
                         "over_bound": graph / bound})
        return {"mode": "relaunch", "cap": tv.cap, "live_instances": live,
                "pairs": pairs, "kernels": rows}

    def dyngrid(self) -> dict:
        return dyngrid(self.device)

    def ssim(self) -> dict:
        """Each SSIM build, forward and backward, in rgb and gray mode on
        :func:`ssim_operands` at the probes' size (λ 0.2, the maps wanted):
        graph ms, CUDA-event ms, registers, spills, shared bytes (static
        and dynamic) and resident blocks per SM, against ``base`` in graph
        ms; each build's outputs against the shipping kernels'."""
        from event3dgs_tpu_torch.losses import modes

        render, gt, bg = ssim_operands(self.height, self.width, self.device)
        grad = torch.ones((), device=self.device)
        rows, outputs = [], {}
        for gray in (False, True):
            mode = "gray" if gray else "rgb"
            shipping = modes.photometric_loss_forward_kernel(
                render, gt, 0.2, gray, bg)
            shipping_d = modes.photometric_loss_backward_kernel(
                grad, render, gt, shipping[2], 0.2, gray, bg)
            base = {}
            for v in SSIM_VARIANTS.values():
                log = kernels.build([(v.source, v.defines)])[
                    kernels.build_key(v.source, v.defines)]
                fwd = lambda v=v: v.forward(render, gt, 0.2, gray, bg)
                loss, l1, maps = fwd()
                bwd = lambda v=v, maps=maps: v.backward(grad, render, gt, maps,
                                                       0.2, gray, bg)
                d = bwd()
                if v.name == "base":
                    outputs[mode] = {"shipping": (shipping, shipping_d),
                                     "base": ((loss, l1, maps), d)}
                errs = {
                    "forward": max_abs_err((loss, l1, maps), shipping),
                    "backward": max_abs_err(d, shipping_d)}
                for which, call, fn in (
                        ("forward", fwd, "photometric_loss_forward_kernel"),
                        ("backward", bwd, "photometric_loss_backward_kernel")):
                    flags = (int(which == "backward"), int(gray))
                    occ = kernels.occupancy(
                        "ssim", "e3d_photometric_occupancy", *flags,
                        defines=v.defines)
                    row = {"variant": v.name, "mode": mode, "kernel": which,
                           "defines": list(v.defines), "what": v.what,
                           "timing_only": v.timing_only,
                           "library": kernels.library_path(
                               v.source, v.defines).name,
                           "event_ms": kt.cuda_ms(call, CALLS),
                           "graph_ms": kt.graph_ms(call, CALLS),
                           **kt.ptxas_report(log, fn, ssim_template(gray)),
                           "shared_bytes": ssim_shared_bytes(*flags,
                                                             v.defines),
                           "blocks_per_sm": occ[1],
                           "max_abs_err_vs_shipping": errs[which]}
                    if which in base:
                        row["vs_base_ms"] = (row["graph_ms"]
                                             - base[which]["graph_ms"])
                        row["vs_base_share"] = (row["graph_ms"]
                                                / base[which]["graph_ms"])
                    else:
                        base[which] = row
                    rows.append(row)
        self.outputs["ssim"] = outputs
        return {"mode": "ssim", "variants": rows}

    def depth_tables(self, n: int):
        """The table kernel's outputs for ``n`` Gaussians of ``bench.py``'s
        scene recipe at camera 0, and the default instance cap."""
        from event3dgs_tpu_torch.ops.projection import project_gaussians

        means, scales, rots, opac, _ = kt.bench_scene(
            np.random.default_rng(0), n)
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        cam = kt.bench_camera(0, self.width, self.height, self.device)
        opacities = f(opac)
        proj = project_gaussians(f(means), f(scales), f(rots), cam,
                                 opacities=opacities)
        args = (proj.mean2d, proj.depth, proj.radius, proj.valid, self.width,
                self.height)
        kw = dict(opacities=opacities, conic=proj.conic)
        table = lambda: binning.gaussian_tables(*args, **kw)
        return table(), rt.default_instance_cap(n), table

    def offsets(self) -> dict:
        """The depth order at the render view (the probes' size) and at
        ``OFFSETS_LARGE`` Gaussians of the same recipe: graph ms of the
        shipping call, of the sort and the offsets kernel alone, of each
        timing-only build (both kernels), of ``torch.argsort`` and
        ``torch.sort`` of the keys (stable) and of the table kernel; the
        sort alone on keys whose digits vary in 1-4 of its passes (the
        others skipped); the scratch bytes per Gaussian of the depth order
        and of ``torch.argsort`` (peak allocated over the call, its outputs
        included); registers and spills of each kernel."""
        from event3dgs_tpu_torch.ops.sort_tiles import SEGMENT, segments

        log = kernels.build(["depth_sort"])["depth_sort"]
        registers = {f + t: kt.ptxas_report(log, f, t)
                     for f, t in DEPTH_FUNCTIONS}
        rows = []
        for n in (self.n, OFFSETS_LARGE):
            tables, cap, table = self.depth_tables(n)
            key = tables.key
            want = binning.depth_order(tables, cap)
            # the plain version on the card; the same order on these keys
            # (no NaN) as torch.argsort's
            plain = binning.radix_order_plain(tables, cap)
            live_segments = -(-min(int(want.offsets[-1]), cap) // SEGMENT)
            equal = (torch.equal(want.order, plain.order)
                     and torch.equal(want.offsets, plain.offsets)
                     and torch.equal(want.seg_rank[:live_segments],
                                     plain.seg_rank[:live_segments]))
            order, counts = binning.depth_sort_kernel(tables)
            common = {"gaussians": n,
                      "live": int((tables.rect[:, 3] > 0).sum()), "cap": cap,
                      "instances": int(want.offsets[-1]),
                      "segments": segments(cap)}
            bound = {
                "depth_order": kt.depth_order_bytes(n, cap),
                "depth_sort": (n * 16, (0, 0)),
                "depth_offsets": (n * 8 + 4 + segments(cap) * 4, (0, 0)),
            }
            calls = {
                "depth_order": lambda: binning.depth_order(tables, cap),
                "depth_sort": lambda: binning.depth_sort_kernel(tables),
                "depth_offsets": lambda: binning.depth_offsets_kernel(
                    tables, counts, cap),
                "argsort": lambda: torch.argsort(key, stable=True),
                "sort": lambda: torch.sort(key, stable=True),
                "table_kernel": table,
            }
            for name, call in calls.items():
                row = {**common, "call": name,
                       "graph_ms": kt.graph_ms(call, CALLS),
                       "event_ms": kt.cuda_ms(call, CALLS)}
                if name in bound:
                    row["bound_ms"] = kt.bound_ms(*bound[name])[0]
                    row["over_bound"] = row["graph_ms"] / row["bound_ms"]
                if name == "depth_order":
                    row["equal_to_plain"] = equal
                    row["bound_argsort_ms"] = kt.bound_ms(
                        n * 20 + 4 + segments(cap) * 4, (0, 0))[0]
                if name in ("depth_order", "argsort"):
                    row["scratch_bytes_per_gaussian"] = peak_bytes(call) / n
                rows.append(row)
            base = None
            for name, (defines, what) in OFFSETS_VARIANTS.items():
                def call(name=name, defines=defines):
                    OFFSETS_LAUNCHES[name] += 1
                    return binning.depth_order_kernel(tables, cap,
                                                      defines=defines)

                got = call()
                row = {**common, "call": f"build {name}", "what": what,
                       "timing_only": name != "base",
                       "graph_ms": kt.graph_ms(call, CALLS),
                       "event_ms": kt.cuda_ms(call, CALLS),
                       "equal_to_shipping": bool(
                           torch.equal(got.order, want.order)
                           and torch.equal(got.offsets, want.offsets)),
                       "max_abs_err_vs_shipping": max_abs_err(
                           (got.order, got.offsets),
                           (want.order, want.offsets))}
                if base is None:
                    base = row
                else:
                    row["vs_base_ms"] = row["graph_ms"] - base["graph_ms"]
                rows.append(row)
            # the sort on keys whose words vary in the low 8, 16 or 24 bits
            # (floats in [2, 4)) and on the view's own keys: a pass a digit
            g = torch.Generator(device=self.device).manual_seed(n)
            bits = torch.randint(0, 1 << 24, (n,), generator=g,
                                 device=self.device, dtype=torch.int32)
            for passes in range(1, binning.PASSES + 1):
                if passes < binning.PASSES:
                    mask = (1 << (binning.RADIX_BITS * passes)) - 1
                    k = (bits & mask | 0x40000000).view(torch.float32)
                    t = tables._replace(key=k)
                else:
                    t = tables
                plan = binning.radix_plan(binning.ordered_keys(t.key))
                rows.append({**common, "call": "depth_sort by passes",
                             "passes": len(plan),
                             "graph_ms": kt.graph_ms(
                                 lambda t=t: binning.depth_sort_kernel(t),
                                 CALLS)})
            binning.depth_order(tables, cap)  # the state left cleared
        return {"mode": "offsets", "registers": registers, "rows": rows}

    def run(self, mode: str) -> dict:
        if mode in CARD_MODES and not self.on_card:
            raise SystemExit(f"kernel_probes {mode}: needs a CUDA card (its "
                             "builds are timing only, without plain versions)")
        rec = getattr(self, mode)()
        rec.update(device=str(self.device), gaussians=self.n,
                   width=self.width, height=self.height)
        self.records[mode] = rec
        return rec


def peak_bytes(call) -> int:
    """The device bytes one call of ``call`` allocates at its peak, its
    outputs included (the caching allocator's peak over the call)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def clock_imbalance(clock, blocks_per_sm: int) -> dict:
    """From the ``clock`` build's [num_tiles, 2] entry and exit times (ns):
    the longest block against the median block; the share of the kernel's
    span with fewer blocks running than a full wave (``blocks_per_sm`` ×
    the SMs), the mean number running as a share of a full wave, and the
    tail (from the last block's entry to the end) as a share of the
    span."""
    t = clock.cpu().numpy().astype(np.float64)
    span = t[:, 1].max() - t[:, 0].min()
    dur = t[:, 1] - t[:, 0]
    wave = blocks_per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    edges = np.r_[t[:, 0], t[:, 1]]
    steps = np.r_[np.ones(len(t)), -np.ones(len(t))]
    order = np.lexsort((steps, edges))  # exits before entries at a tie
    running = np.cumsum(steps[order])
    gaps = np.diff(edges[order])
    under = float(gaps[running[:-1] < wave].sum())
    return {"blocks": len(t), "span_us": span / 1e3,
            "median_block_us": float(np.median(dur)) / 1e3,
            "longest_block_us": float(dur.max()) / 1e3,
            "longest_over_median": float(dur.max() / np.median(dur)),
            "full_wave": wave, "under_full_wave_share": under / span,
            "mean_running_share": float((gaps * running[:-1]).sum())
            / (span * wave),
            "tail_share": float(t[:, 1].max() - t[:, 0].max()) / span}


def run_probes(modes, device, n=kt.N_GAUSSIANS, width=kt.WIDTH,
               height=kt.HEIGHT) -> Probes:
    """Run ``modes`` in order, printing one JSON line each; returns the
    :class:`Probes` with their records and outputs."""
    probes = Probes(torch.device(device), n, width, height)
    if probes.on_card and any(m in ("k1", "k4") for m in modes):
        kernels.build(variant_builds())
    if probes.on_card and "ssim" in modes:
        kernels.build(ssim_builds())
    if probes.on_card and "offsets" in modes:
        kernels.build(offsets_builds())
    for mode in modes:
        print(json.dumps(probes.run(mode)), flush=True)
    return probes


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=(*MODES, "all"))
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (stages, stops, dyngrid)")
    p.add_argument("--gaussians", type=int, default=kt.N_GAUSSIANS)
    p.add_argument("--width", type=int, default=kt.WIDTH)
    p.add_argument("--height", type=int, default=kt.HEIGHT)
    return p


def main(argv=None) -> int:
    from event3dgs_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    modes = MODES if args.mode == "all" else (args.mode,)
    run_probes(modes, device, args.gaussians, args.width, args.height)
    print(kt.card() if device.type == "cuda" else
          "cpu: no card; device times not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
