"""Scale probes of the port: the counterparts of the JAX package's
``experiments/`` scale scripts, one subcommand each.

    python3 -m event3dgs_tpu_torch.tools.scale step [--gaussians N]
        [--steps 20] [--fused_steps K]
    python3 -m event3dgs_tpu_torch.tools.scale maxcap [--capacity C]
        [--iters 3] [--fused_steps K [--skip_eager]]
    python3 -m event3dgs_tpu_torch.tools.scale maxcap --search
        [--fused_steps 10]
    python3 -m event3dgs_tpu_torch.tools.scale train [--iters 300]
        [--densify] [--fused_steps K]
    python3 -m event3dgs_tpu_torch.tools.scale mesh [--capacity C]
        [--ranks K]

Every subcommand runs on the CUDA card unless ``--device cpu`` is given
(``mesh`` always runs on gloo CPU ranks) and prints one JSON line per run,
with the card's name and power limit (``nvidia-smi``) under ``card``.  The
scenes are the scripts' numpy recipes from seed 0, in the scripts' draw
order, so the same seed gives the same arrays in both packages.

- ``step`` (``experiments/tools_scale_1m.py``): N splats (default
  1,000,000) at 1080p, four cameras, random images; event mode, the tiled
  rasterizer, the measured instance cap; ``--steps`` timed steps of
  ``make_train_step`` after a first one.  It/s, 3·W·H pixels/s, the
  instance cap and instances per splat, peak memory.  With
  ``--fused_steps K`` the same steps also replay a CUDA graph of
  ``GraphTrainStep`` (``train/fused.FusedSteps``): capture ms, device ms
  per replay (CUDA events), the memory the graph and its buffers add.
- ``maxcap`` (``experiments/tools_r5_maxcap.py``): one capacity per
  process (default 2,097,152) with the script's small-splat statistics;
  state GiB, instance cap, ms per step and loss over ``--iters`` steps,
  eager and, with ``--fused_steps``, graphed.  A run counts ("status":
  "ok") only if every loss is finite and the end state's instances fit
  the measured cap at the step's views; an out-of-memory error is
  reported as ``"status": "oom"`` with a non-zero exit, never retried
  smaller.  ``--search`` runs one subprocess per capacity (2M, 4M, 8M,
  12M, 16M, 24M, then 32M and 48M, up to the first that runs out of
  memory, then bisection to 256 slots) for the eager step and for the
  graphed one (``--fused_steps``, 10 where it is not given), prints both
  ceilings, and stops at a run that neither counts nor ran out of
  memory.
- ``train`` (``experiments/tools_scale_1m_train.py``): a 100k-point world
  rendered by the tiled rasterizer into 12 1080p views, a 1,048,576-slot
  model from a noisy tenfold copy of its points (every slot alive, or 9/10
  of them with ``--densify``), trained through ``train_loop`` in ``"rgb"``
  mode, the script's mode.  With ``--densify``: densify every 50 after 50
  and below ``--iters`` (the loop's rule: at 100, 150, ...), no opacity
  reset.  Finite losses and the mean of the
  last 3k below the first 3k (k a tenth of the run), as the script
  asserts; the loss curve, it/s, alive at start and end, and the instance
  overflow of the end state at the loop's last instance cap.
- ``mesh`` (``experiments/tools_r5_5m_mesh.py``): capacity 5,242,880 over
  ``gauss`` = 8 gloo CPU ranks, gray mode, the reference rasterizer, 16
  views at 32×24.  The parent process initialises the whole point cloud
  once (its 3-NN scales included), as the script does, and hands each
  rank its C/K slots in a file.  Each rank holds C/K rows of every
  per-Gaussian tensor before and after one real step, and its state
  bytes are its C/K share of the whole state's (with the scalars whole)
  and, past 2 ranks, under half of them; the loss is finite.

``--width``/``--height`` (and ``--views``, ``--true_points`` for ``train``)
cut a run to a small size, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
STEP_GAUSSIANS = 1_000_000
STEP_STEPS = 20
MAXCAP_CAPACITY = 2_097_152
MAXCAP_ITERS = 3
# the script's capacities (2M-24M), then 32M and 48M in case 24M runs
SEARCH_GRID = (2_097_152, 4_194_304, 8_388_608, 12_582_912, 16_777_216,
               25_165_824, 33_554_432, 50_331_648)
SEARCH_GRANULARITY = 256
SEARCH_FUSED_STEPS = 10  # the graphed search's, where none is given
PROBE_TIMEOUT = 900.0  # seconds a search's process may take
TRAIN_ITERS = 300
TRAIN_TRUE_POINTS = 100_000
TRAIN_CAPACITY = 1 << 20
TRAIN_VIEWS = 12
TRAIN_EXTENT = 4.4  # the script's spatial_lr_scale and scene extent
TRAIN_DENSIFY_EVERY = 50
MESH_CAPACITY = 5_242_880
MESH_RANKS = 8
MESH_WIDTH, MESH_HEIGHT, MESH_VIEWS = 32, 24, 16
STEP_VIEWS = (1, 1, 2)  # the scripts' (main, now, next)
SPATIAL_LR_SCALE = 3.0  # step and maxcap


def card(device) -> str:
    """The card's name and power limit, or a note that there is none."""
    if torch.device(device).type != "cuda":
        return "cpu: no card; device times not measured"
    from event3dgs_tpu_torch.tools.kernel_timing import card as smi

    return smi()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --- scenes: the scripts' recipes ----------------------------------------


def splat_params(means, colors, log_scales, device, rotation=None,
                 opacity=None):
    """``init_from_point_cloud(means, colors, capacity=len(means))`` with
    the scripts' ``.replace(scaling=..., rotation=..., opacity=...)``
    applied: every slot alive, DC features from the colors, the given
    log-scales (in place of the 3-NN ones, so no neighbour search runs),
    and the given rotations and raw opacities where the recipe sets them
    (identity and the init opacity 0.1 where it does not)."""
    from event3dgs_tpu_torch.core.sh import rgb_to_sh
    from event3dgs_tpu_torch.core.transforms import inverse_sigmoid
    from event3dgs_tpu_torch.models.gaussians import GaussianParams

    n = means.shape[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if rotation is None:
        rotation = np.zeros((n, 4), np.float32)
        rotation[:, 0] = 1.0
    if opacity is None:
        opacity = np.full((n, 1), float(inverse_sigmoid(0.1)), np.float32)
    return GaussianParams(
        xyz=f32(means),
        features_dc=f32(rgb_to_sh(np.asarray(colors, np.float32))[:, None]),
        features_rest=torch.zeros(n, 15, 3, device=device),
        scaling=f32(log_scales),
        rotation=f32(rotation),
        opacity=f32(opacity),
        alive=torch.ones(n, dtype=torch.bool, device=device),
    )


def step_cameras(rng, n_images, width, height, device):
    """The scripts' four cameras (identity rotation, translation (0.01·i,
    0, 0.02·i), fov 1.2 × 0.75) and ``n_images`` random images from
    ``rng``: (cameras, images)."""
    from event3dgs_tpu_torch.core.camera import make_camera, stack_cameras

    cams = stack_cameras([
        make_camera(np.eye(3), np.asarray([0.01 * i, 0.0, 0.02 * i]), 1.2,
                    0.75, width, height, device=device) for i in range(4)])
    images = torch.as_tensor(
        rng.uniform(0, 1, (n_images, height, width, 3)).astype(np.float32),
        device=device)
    return cams, images


def event_data(cameras, images):
    from event3dgs_tpu_torch.train import SceneData

    return SceneData(cameras=cameras, images=images, event_cameras=cameras,
                     event_images=images)


def step_scene(n, width=WIDTH, height=HEIGHT, device="cuda"):
    """``tools_scale_1m.py``'s scene: (state, data)."""
    from event3dgs_tpu_torch.train import init_train_state

    rng = np.random.default_rng(0)
    pts = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                rng.uniform(2, 10, n)]
    cols = rng.uniform(0.1, 1.0, (n, 3))
    # sub-pixel to few-pixel splats at this density
    scales = (np.exp(rng.uniform(np.log(0.002), np.log(0.008), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    params = splat_params(pts, cols, np.log(scales), device)
    cams, images = step_cameras(rng, 4, width, height, device)
    state = init_train_state(params, spatial_lr_scale=SPATIAL_LR_SCALE)
    return state, event_data(cams, images)


def maxcap_scene(n, width=WIDTH, height=HEIGHT, device="cuda"):
    """``tools_r5_maxcap.py``'s scene: (state, data)."""
    from event3dgs_tpu_torch.train import init_train_state

    rng = np.random.default_rng(0)
    means = np.c_[rng.uniform(-3, 3, n), rng.uniform(-1.8, 1.8, n),
                  rng.uniform(2, 10, n)].astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    # small splats: per-splat tile coverage ~1-2, as a trained model's
    scales = (np.exp(rng.uniform(np.log(0.002), np.log(0.006), (n, 1)))
              * rng.uniform(0.8, 1.2, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    cams, images = step_cameras(rng, 4, width, height, device)
    params = splat_params(means, colors, np.log(scales), device,
                          rotation=rots,
                          opacity=np.log(opac / (1 - opac))[:, None])
    state = init_train_state(params, spatial_lr_scale=SPATIAL_LR_SCALE)
    return state, event_data(cams, images)


def orbit_cameras(n_views, fov_y, width, height, device):
    """The scripts' orbit: ``n_views`` cameras on a radius-4 circle at
    height 0.6 looking at the origin, fov 1.0 × ``fov_y``."""
    from event3dgs_tpu_torch.core.camera import make_camera, stack_cameras

    cams = []
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        pos = np.array([4.0 * np.sin(th), 0.6, -4.0 * np.cos(th)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        r = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cams.append(make_camera(r, -r.T @ pos, 1.0, fov_y, width, height,
                                device=device))
    return stack_cameras(cams)


def train_scene(capacity=TRAIN_CAPACITY, densify=False,
                n_true=TRAIN_TRUE_POINTS, n_views=TRAIN_VIEWS, width=WIDTH,
                height=HEIGHT, device="cuda"):
    """``tools_scale_1m_train.py``'s world and model: (state, data).  The
    ground truth is rendered by the tiled rasterizer over a white
    background and clipped to [0, 1]."""
    from event3dgs_tpu_torch.core.sh import rgb_to_sh
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.ops.render import render
    from event3dgs_tpu_torch.train import SceneData, init_train_state

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n_true, 3)) * np.array([0.9, 0.6, 0.9])
    cols = rng.uniform(0.1, 1.0, (n_true, 3))
    scales = np.exp(rng.uniform(np.log(0.004), np.log(0.02), (n_true, 1)))
    scales = np.tile(scales, (1, 3)) * rng.uniform(0.8, 1.2, (n_true, 3))
    quats = rng.normal(size=(n_true, 4))
    opac = rng.uniform(0.55, 0.95, n_true)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    feats = torch.zeros(n_true, 16, 3, device=device)
    feats[:, 0, :] = rgb_to_sh(f32(cols))
    cameras = orbit_cameras(n_views, 0.6, width, height, device)
    bg = torch.ones(3, device=device)
    gts = []
    with torch.no_grad():
        for i in range(n_views):
            img = render(f32(pts), feats, f32(opac), f32(scales), f32(quats),
                         cameras[i], bg, sh_degree=0,
                         rasterizer="tiled").image
            gts.append(torch.clamp(img, 0, 1))
    images = torch.stack(gts)

    # the true points replicated with noise (the init must be learned back
    # toward the truth); every slot alive, or 9/10 of them to densify into
    n_init = (capacity * 9) // 10 if densify else capacity
    reps = n_init // n_true + 1
    init_pts = np.tile(pts, (reps, 1))[:n_init]
    init_cols = np.tile(cols, (reps, 1))[:n_init]
    init_pts = init_pts + rng.normal(size=init_pts.shape) * 0.03
    params = init_from_point_cloud(init_pts, init_cols, capacity=capacity,
                                   device=device)
    state = init_train_state(params, spatial_lr_scale=TRAIN_EXTENT)
    return state, SceneData(cameras=cameras, images=images)


def depth_offsets_case(n, seed=0, device="cuda"):
    """The depth offsets kernel's inputs for ``n`` Gaussians with no render
    behind them (its ceiling-size check): instance counts 0-4 (a zero
    count's key is +inf, as the table kernel writes it), keys with ties,
    and the cleared look-back state."""
    from event3dgs_tpu_torch.ops import binning

    g = torch.Generator(device=device).manual_seed(seed)
    counts = torch.randint(0, 5, (n,), generator=g, device=device,
                           dtype=torch.int32)
    key = torch.randint(0, 1 << 20, (n,), generator=g, device=device)
    key = torch.where(counts > 0, key.to(torch.float32) * 1e-3,
                      float("inf"))
    rect = torch.zeros(n, 4, dtype=torch.int32, device=device)
    rect[:, 3] = counts
    return binning.GaussianTables(
        rect=rect, cull=torch.empty(0, 8, device=device), key=key,
        lookback=torch.zeros(binning.lookback_words(n), dtype=torch.int64,
                             device=device))


def counting_sort_case(m, n_bins, seed=1, device="cuda"):
    """The counting sort's inputs over ``m`` instance slots and ``n_bins``
    tiles (its ceiling-size check): tile ids with the drop sentinel among
    them, Gaussian ids, and a live count a quarter short of ``m``.
    Returns (ids, gauss, n_live)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, n_bins + 1, (m,), generator=g, device=device,
                        dtype=torch.int32)
    gauss = torch.randint(0, 1 << 24, (m,), generator=g, device=device,
                          dtype=torch.int32)
    n_live = torch.tensor([m - m // 4], dtype=torch.int32, device=device)
    return ids, gauss, n_live


# --- the runs --------------------------------------------------------------


def state_bytes(state) -> int:
    from event3dgs_tpu_torch.train.state import map_tensors

    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t

    map_tensors(add, state)
    return total[0]


def instance_overflow(params, cameras, icap, views) -> int:
    """The most (tile, Gaussian) instances by which one of ``views`` passes
    the cap ``icap`` (0: the binning drops none)."""
    from event3dgs_tpu_torch.train.loop import probe_instance_count

    return max(max(probe_instance_count(params, cameras[v]) - icap, 0)
               for v in views)


def is_oom(err: BaseException) -> bool:
    """Whether ``err`` is the card running out of memory (PyTorch's own
    error, or a library's allocation failure that it passes on)."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    text = str(err)
    return isinstance(err, RuntimeError) and (
        "out of memory" in text or "ALLOC_FAILED" in text)


def peak_mib(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def eager_steps(held, data, icap, iters, device):
    """The scripts' timing on the state that ``held`` (a one-element list)
    hands over, so that no other reference keeps it once the first step
    has replaced it: one step (the JAX scripts' compile), then ``iters``
    steps of ``make_train_step`` timed on the host clock up to a
    synchronise.  Returns (state, record)."""
    from event3dgs_tpu_torch.train.step import make_train_step
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    step = make_train_step("event", OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=SPATIAL_LR_SCALE,
                           rasterizer="tiled", instance_cap=icap)
    bg = torch.zeros(3, device=device)
    reset_peak(device)
    t0 = time.perf_counter()
    state, m = step(held.pop(), data, *STEP_VIEWS, bg)
    sync(device)
    first_s = time.perf_counter() - t0
    losses = [m["loss"]]
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, data, *STEP_VIEWS, bg)
        losses.append(m["loss"])
    sync(device)
    dt = (time.perf_counter() - t0) / iters if iters else first_s
    w, h = data.cameras.width, data.cameras.height
    return state, {
        "first_step_s": first_s, "ms_per_step": dt * 1e3, "it_s": 1 / dt,
        "pixels_s": 3 * w * h / dt, "loss": float(m["loss"]),
        "finite": bool(torch.isfinite(torch.stack(losses)).all()),
        "instance_overflow": instance_overflow(state.params, data.cameras,
                                               icap, set(STEP_VIEWS)),
        "num_visible": int(m["num_visible"]), "peak_mib": peak_mib(device)}


def graphed_steps(held, data, icap, iters, rows, device):
    """The same steps through ``FusedSteps`` (a CUDA graph of
    ``GraphTrainStep`` on the card, eager steps through its row table on
    the CPU) on the state ``held`` hands over, dropped once the fused steps
    hold their copy, as ``train_loop`` drops its own: ``iters`` steps in
    chunks of ``rows`` after one untimed step, as :func:`eager_steps` runs
    them.  Capture ms, host ms per step, device ms per step (CUDA events
    around each chunk of replays, its row-table copy and loss read
    included), the memory the fused steps reserve (their copy of
    the state, the row table and the graph's pool) and the peak.  Returns
    (the fused steps, record)."""
    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    on_card = torch.device(device).type == "cuda"
    step = GraphTrainStep("event", OptimizationConfig(), EventConfig(),
                          spatial_lr_scale=SPATIAL_LR_SCALE,
                          rasterizer="tiled", instance_cap=icap)
    release(device)
    reset_peak(device)
    reserved = torch.cuda.memory_reserved(device) if on_card else 0
    state = held.pop()
    step0 = int(state.step)
    runner = FusedSteps(step, state, data, rows)
    del state
    reserved = (torch.cuda.memory_reserved(device) - reserved) if on_card \
        else None

    def chunk(first, k):
        return runner.run(torch.from_numpy(np.stack([
            step.row(step0 + first + 1 + j, STEP_VIEWS, np.zeros(3))
            for j in range(k)])))  # reads the losses: synchronises

    losses = chunk(0, 1)  # the eager steps' untimed first step
    device_ms = []
    t0 = time.perf_counter()
    done = 0
    while done < iters:
        k = min(rows, iters - done)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        losses.extend(chunk(1 + done, k))
        if on_card:
            end.record()
            end.synchronize()
            device_ms.append(start.elapsed_time(end) / k)
        done += k
    dt = (time.perf_counter() - t0) / iters
    w, h = data.cameras.width, data.cameras.height
    return runner, {
        "capture_ms": runner.capture_ms, "ms_per_step": dt * 1e3,
        "device_ms_per_replay": (float(np.median(device_ms)) if device_ms
                                 else None),
        "pixels_s": 3 * w * h / dt, "loss": losses[-1],
        "finite": bool(np.isfinite(losses).all()),
        "instance_overflow": instance_overflow(runner.state.params,
                                               data.cameras, icap,
                                               set(STEP_VIEWS)),
        "losses": losses, "replays": runner.replays,
        "reserved_mib": None if reserved is None else reserved / 2**20,
        "peak_mib": peak_mib(device)}


SCENES = {"step": step_scene, "maxcap": maxcap_scene}


def run_scene(probe, capacity, iters, fused_steps=1, skip_eager=False,
              width=WIDTH, height=HEIGHT, device="cuda") -> dict:
    """``step`` or ``maxcap`` (``probe``) at one capacity: one JSON record,
    ``status`` "ok" (every loss finite, no instance past the cap at the
    end of each phase), "failed" where one is not, or "oom"; ``failed_in``
    names the phase.  The eager and the graphed phase each build the
    scene anew, so that each holds one train state beside the data, as
    the script does."""
    from event3dgs_tpu_torch.train.loop import measure_instance_cap

    rec = {"probe": probe, "status": "ok", "capacity": capacity,
           "width": width, "height": height, "device": str(device),
           "iters": iters, "fused_steps": fused_steps, "init_s": None,
           "state_gib": None, "instance_cap": None,
           "instances_per_splat": None, "eager": None, "graphed": None,
           "same_loss": None, "failed_in": None}
    phases = ([] if skip_eager else ["eager"]) + (
        ["graphed"] if fused_steps > 1 else [])
    phase = "init"
    try:
        for run in phases:
            phase = "init"
            t0 = time.perf_counter()
            held = [None]
            held[0], data = SCENES[probe](capacity, width, height, device)
            sync(device)
            rec["init_s"] = time.perf_counter() - t0
            rec["state_gib"] = state_bytes(held[0]) / 2**30
            phase = "instance_cap"
            icap = measure_instance_cap(held[0].params, data.cameras)
            rec["instance_cap"] = icap
            rec["instances_per_splat"] = icap / capacity
            phase = run
            if run == "eager":
                rec["eager"] = eager_steps(held, data, icap, iters, device)[1]
            else:
                runner, rec["graphed"] = graphed_steps(
                    held, data, icap, iters, fused_steps, device)
                rec["graphed"].pop("losses")
                runner.release()
                del runner
            del data
            release(device)
    except Exception as err:  # noqa: BLE001 - an OOM is this probe's result
        if not is_oom(err):
            raise
        rec.update(status="oom", failed_in=phase,
                   error=str(err).splitlines()[0][:300])
    if rec["eager"] and rec["graphed"]:
        rec["same_loss"] = rec["eager"]["loss"] == rec["graphed"]["loss"]
    for run in ("eager", "graphed"):
        r = rec[run]
        if r and (not r["finite"] or r["instance_overflow"]):
            rec["status"], rec["failed_in"] = "failed", run
            break
    rec["card"] = card(device)
    return rec


def release(device) -> None:
    """Hand the caching allocator's free blocks back to the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def maxcap_process(capacity, args) -> dict:
    """``maxcap`` at ``capacity`` in a process of its own: its JSON record
    (``status`` "error" where it printed none)."""
    cmd = [sys.executable, "-m", "event3dgs_tpu_torch.tools.scale", "maxcap",
           "--capacity", str(capacity), "--iters", str(args.iters),
           "--width", str(args.width), "--height", str(args.height)]
    if args.device:
        cmd += ["--device", args.device]
    if args.fused_steps > 1:
        cmd += ["--fused_steps", str(args.fused_steps), "--skip_eager"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=PROBE_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    try:
        rec = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec = {"probe": "maxcap", "status": "error", "capacity": capacity,
               "stderr": proc.stderr[-2000:]}
    rec["returncode"] = proc.returncode
    rec["process_s"] = time.perf_counter() - t0
    return rec


def search_ceiling(args, probe=maxcap_process) -> dict:
    """The largest capacity whose step ran (``args.fused_steps`` > 1: the
    graphed step alone), exact to ``SEARCH_GRANULARITY`` slots: the grid
    until the first OOM, then bisection between the last capacity that ran
    and the first that did not.  Each probe prints its record; a probe
    that neither ran ("ok": finite losses, no instance overflow) nor ran
    out of memory ends the search."""
    runs = []

    def run(c):
        rec = probe(c, args)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
        if rec["status"] not in ("ok", "oom"):
            raise SystemExit(f"maxcap --search: capacity {c} failed without "
                             f"running out of memory: {rec}")
        return rec["status"] == "ok"

    ok, bad = 0, None
    for c in SEARCH_GRID:
        if not run(c):
            bad = c
            break
        ok = c
    g = SEARCH_GRANULARITY
    while bad is not None and bad - ok > g:
        mid = (ok + bad) // 2 // g * g
        if mid <= ok:
            break
        if run(mid):
            ok = mid
        else:
            bad = mid
    return {"ceiling": ok or None, "first_oom": bad, "probes": len(runs),
            "runs": [{k: r.get(k) for k in ("capacity", "status", "failed_in",
                                             "state_gib", "instance_cap")}
                     for r in runs]}


def run_search(args) -> dict:
    """``maxcap --search``: the eager ceiling, then the graphed one at
    ``args.fused_steps`` (``SEARCH_FUSED_STEPS`` where it is 1)."""
    fused = args.fused_steps if args.fused_steps > 1 else SEARCH_FUSED_STEPS
    out = {"probe": "maxcap_search", "status": "ok",
           "granularity": SEARCH_GRANULARITY, "fused_steps": fused}
    for key, k in (("eager", 1), ("graphed", fused)):
        out[key] = search_ceiling(argparse.Namespace(**{**vars(args),
                                                        "fused_steps": k}))
    out["card"] = card(args.device or "cuda")
    return out


def train_record(res, state, data, icap, iters, wall, fused_steps,
                 densify) -> dict:
    """``train``'s record and the script's two checks, and the instance
    overflow of the end state at the loop's last cap ``icap``."""
    h = np.asarray(res.history, np.float64)
    k = max(len(h) // 10, 1)
    finite = bool(np.isfinite(h).all())
    decreasing = bool(np.mean(h[-3 * k:]) < np.mean(h[:3 * k]))
    p = res.state.params
    overflow = 0
    if icap is not None:
        overflow = instance_overflow(p, data.cameras, icap,
                                     range(data.num_views))
    w, h_px = data.cameras.width, data.cameras.height
    return {
        "probe": "train", "status": "ok" if finite and decreasing
        else "failed", "capacity_start": state.params.capacity,
        "capacity_end": p.capacity, "alive_start": int(state.params.alive.sum()),
        "alive_end": int(p.alive.sum()), "iters": iters, "densify": densify,
        "fused_steps": fused_steps, "wall_s": wall, "it_s": iters / wall,
        # one render per rgb-mode step
        "pixels_s": iters / wall * w * h_px,
        "loss_curve": [float(np.mean(h[i:i + k])) for i in range(0, len(h), k)],
        "loss_first": float(h[0]), "loss_last": float(h[-1]),
        "finite": finite, "decreasing": decreasing,
        "instance_cap": icap, "instance_overflow": int(overflow),
        "width": w, "height": h_px, "views": data.num_views}


def run_train(iters=TRAIN_ITERS, densify=False, fused_steps=1,
              capacity=TRAIN_CAPACITY, n_true=TRAIN_TRUE_POINTS,
              n_views=TRAIN_VIEWS, width=WIDTH, height=HEIGHT, device="cuda",
              scene=None, densify_every=TRAIN_DENSIFY_EVERY):
    """``train``: (record, the loop's result).  ``scene`` (state, data)
    reuses a built scene.  With ``densify`` the loop densifies at every
    multiple of ``densify_every`` above ``densify_every`` and below
    ``iters`` (the loop's rule: the script's 50 densifies at 100, 150,
    ...; the tests' small runs take 5)."""
    from event3dgs_tpu_torch.train.loop import (
        TrainCallbacks,
        measure_instance_cap,
        train_loop,
    )
    from event3dgs_tpu_torch.utils.config import OptimizationConfig, TrainConfig

    if scene is None:
        scene = train_scene(capacity, densify, n_true, n_views, width, height,
                            device)
    state, data = scene
    if densify:
        opt = OptimizationConfig(densify_from_iter=densify_every,
                                 densify_until_iter=iters,
                                 densification_interval=densify_every,
                                 opacity_reset_interval=10 ** 9)
    else:
        opt = OptimizationConfig(densify_from_iter=10 ** 9,
                                 densify_until_iter=0)
    cfg = TrainConfig(optimization=opt)
    cfg.pipeline.rasterizer = "tiled"
    cfg.pipeline.fused_steps = fused_steps
    # the loop's cap: measured as the loop measures it, raised on its events
    caps = [measure_instance_cap(state.params, data.cameras)]
    events = []

    def on_metrics(it, m):
        events.append((it, m))
        if "instance_cap" in m:
            caps.append(m["instance_cap"])

    cb = TrainCallbacks(on_metrics=on_metrics)
    t0 = time.perf_counter()
    res = train_loop(state, data, cfg, "rgb", TRAIN_EXTENT, iterations=iters,
                     callbacks=cb)
    wall = time.perf_counter() - t0
    rec = train_record(res, state, data, caps[-1], iters, wall, fused_steps,
                       densify)
    rec["device"] = str(device)
    rec["captures"] = sum("graph_capture_ms" in m for _, m in events)
    rec["capture_ms"] = [m["graph_capture_ms"] for _, m in events
                         if "graph_capture_ms" in m]
    rec["alive"] = [(it, m["num_alive"]) for it, m in events
                    if "num_alive" in m]
    rec["card"] = card(device)
    return rec, res


# --- mesh: gloo CPU ranks --------------------------------------------------


def mesh_scene(capacity, ranks, width, height, n_views, out_dir) -> int:
    """The script's scene, built once: the recipe from seed 0, the whole
    point cloud initialised (its 3-NN scales included), and in ``out_dir``
    each rank's C/K slots (``shard{rank}.pt``) and the images
    (``images.pt``).  Returns the whole train state's bytes, from its
    shapes alone."""
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
    from event3dgs_tpu_torch.train import init_train_state

    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(capacity, 3))
           * np.array([0.9, 0.6, 0.9])).astype(np.float32)
    cols = rng.uniform(0.1, 1.0, (capacity, 3)).astype(np.float32)
    torch.save(torch.as_tensor(rng.uniform(0, 1, (n_views, height, width, 3))
                               .astype(np.float32)),
               os.path.join(out_dir, "images.pt"))
    full = init_from_point_cloud(pts, cols, capacity=capacity, device="cpu")
    del pts, cols
    per = capacity // ranks
    for rank in range(ranks):
        torch.save({f: getattr(full, f)[rank * per:(rank + 1) * per].clone()
                    for f in FIELDS}, os.path.join(out_dir, f"shard{rank}.pt"))
    return state_bytes(init_train_state(
        GaussianParams(**{f: getattr(full, f).to("meta") for f in FIELDS}),
        spatial_lr_scale=TRAIN_EXTENT))


def mesh_shard(rank, width, height, n_views, out_dir):
    """This rank's shard of the script's train state (its C/K slots as
    :func:`mesh_scene` left them; the Adam moments and densify stats made
    for those slots only) and the scene data."""
    from event3dgs_tpu_torch.models.gaussians import GaussianParams
    from event3dgs_tpu_torch.train import SceneData, init_train_state

    params = GaussianParams(**torch.load(
        os.path.join(out_dir, f"shard{rank}.pt")))
    images = torch.load(os.path.join(out_dir, "images.pt"))
    cameras = orbit_cameras(n_views, 0.75, width, height, "cpu")
    return (init_train_state(params, spatial_lr_scale=TRAIN_EXTENT),
            SceneData(cameras=cameras, images=images))


def state_tensors(state):
    """Every tensor of ``state``."""
    from event3dgs_tpu_torch.train.state import map_tensors

    found = []
    map_tensors(lambda t: found.append(t) or t, state)
    return found


def mesh_rank(rank, ranks, capacity, width, height, n_views, full_bytes,
              init, out_dir):
    """One gloo rank of ``mesh``: its shard from ``out_dir``, one sharded
    gray-mode step on the reference rasterizer, the memory contract
    against the whole state's ``full_bytes``; rank 0 writes the record to
    ``out_dir``."""
    import torch.distributed as dist

    from event3dgs_tpu_torch.parallel.distributed import init_distributed
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
    )
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    init_distributed(init, num_processes=1, local_ranks=ranks,
                     local_rank=rank, device="cpu")
    try:
        state, data = mesh_shard(rank, width, height, n_views, out_dir)
        per = capacity // ranks
        rank_bytes = state_bytes(state)
        # the per-Gaussian tensors (params, Adam moments, densify stats)
        # and the scalars (contrast and its Adam state), whole on each rank
        rows = [t for t in state_tensors(state) if t.ndim >= 1]
        scalar_bytes = rank_bytes - sum(t.numel() * t.element_size()
                                        for t in rows)
        mesh = make_mesh(ranks, gauss=ranks)
        step = make_sharded_train_step(
            "gray", OptimizationConfig(), EventConfig(), mesh,
            spatial_lr_scale=TRAIN_EXTENT, rasterizer="reference")
        idx = list(range(ranks))
        t0 = time.perf_counter()
        after, m = step(state, data, idx, idx, [i + 1 for i in idx],
                        torch.zeros(3))
        step_s = time.perf_counter() - t0
        loss = float(m["loss"])
        rows_after = [t for t in state_tensors(after) if t.ndim >= 1]
        checks = {
            "rows_before": all(t.shape[0] == per for t in rows),
            "rows_after": len(rows_after) == len(rows) and all(
                t.shape[0] == per for t in rows_after),
            # the rank holds its share of the whole state and no more
            "rank_state_is_its_share": rank_bytes - scalar_bytes
            == (full_bytes - scalar_bytes) // ranks,
            "finite_loss": math.isfinite(loss),
        }
        if ranks > 2:  # the script's check at 8 ranks
            checks["rank_state_under_half"] = rank_bytes < full_bytes / 2
        # the largest resident set of any rank (the host's memory per rank)
        rss = torch.tensor([resource.getrusage(resource.RUSAGE_SELF).ru_maxrss])
        dist.all_reduce(rss, op=dist.ReduceOp.MAX)
        if rank == 0:
            rec = {"probe": "mesh", "status": "ok" if all(checks.values())
                   else "failed", "capacity": capacity, "ranks": ranks,
                   "rows_per_rank": per, "views": ranks, "width": width,
                   "height": height, "mode": "gray",
                   "rasterizer": "reference", "backend": dist.get_backend(),
                   "full_state_gib": full_bytes / 2**30,
                   "rank_state_gib": rank_bytes / 2**30,
                   "per_gaussian_tensors": len(rows),
                   "rank_max_rss_gib": float(rss) / 2**20,
                   "step_s": step_s, "loss": loss, "checks": checks,
                   "card": "cpu: gloo ranks; device times not measured"}
            with open(os.path.join(out_dir, "mesh.json"), "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def run_mesh(capacity=MESH_CAPACITY, ranks=MESH_RANKS, width=MESH_WIDTH,
             height=MESH_HEIGHT, n_views=MESH_VIEWS,
             timeout=None) -> dict:
    """``mesh``: the scene built here once, then ``ranks`` spawned gloo
    ranks; rank 0's record, with the init's time and this process's
    largest resident set."""
    from event3dgs_tpu_torch.parallel.distributed import spawn_ranks

    if capacity % ranks:
        raise ValueError(f"capacity {capacity} is not a multiple of {ranks}")
    if n_views < ranks + 1:
        raise ValueError(f"{ranks} ranks need {ranks + 1} views")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full_bytes = mesh_scene(capacity, ranks, width, height, n_views, tmp)
        init_s = time.perf_counter() - t0
        init = "file://" + os.path.join(tmp, "rendezvous")
        spawn_ranks(mesh_rank, (ranks, capacity, width, height, n_views,
                                full_bytes, init, tmp), nprocs=ranks,
                    timeout=timeout, threads_per_rank=1)
        with open(os.path.join(tmp, "mesh.json")) as f:
            rec = json.load(f)
    rec["init_s"] = init_s
    rec["init_max_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF)
                               .ru_maxrss / 2**20)
    return rec


# --- command line ----------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="probe", required=True)

    def common(q, width=WIDTH, height=HEIGHT):
        q.add_argument("--device", default=None,
                       help="cuda (default) or cpu")
        q.add_argument("--width", type=int, default=width)
        q.add_argument("--height", type=int, default=height)

    q = sub.add_parser("step", help="tools_scale_1m.py")
    common(q)
    q.add_argument("--gaussians", dest="capacity", type=int,
                   default=STEP_GAUSSIANS)
    q.add_argument("--steps", dest="iters", type=int, default=STEP_STEPS)
    q.add_argument("--fused_steps", type=int, default=1)

    q = sub.add_parser("maxcap", help="tools_r5_maxcap.py")
    common(q)
    q.add_argument("--capacity", type=int, default=MAXCAP_CAPACITY)
    q.add_argument("--iters", type=int, default=MAXCAP_ITERS)
    q.add_argument("--fused_steps", type=int, default=1)
    q.add_argument("--skip_eager", action="store_true",
                   help="with --fused_steps: the graphed steps alone (the "
                        "search's graphed probes)")
    q.add_argument("--search", action="store_true",
                   help="the eager and graphed ceilings, a process each "
                        "capacity")

    q = sub.add_parser("train", help="tools_scale_1m_train.py")
    common(q)
    q.add_argument("--iters", type=int, default=TRAIN_ITERS)
    q.add_argument("--densify", action="store_true")
    q.add_argument("--fused_steps", type=int, default=1)
    q.add_argument("--capacity", type=int, default=TRAIN_CAPACITY)
    q.add_argument("--true_points", type=int, default=TRAIN_TRUE_POINTS)
    q.add_argument("--views", type=int, default=TRAIN_VIEWS)

    q = sub.add_parser("mesh", help="tools_r5_5m_mesh.py")
    q.add_argument("--capacity", type=int, default=MESH_CAPACITY)
    q.add_argument("--ranks", type=int, default=MESH_RANKS)
    q.add_argument("--width", type=int, default=MESH_WIDTH)
    q.add_argument("--height", type=int, default=MESH_HEIGHT)
    q.add_argument("--views", type=int, default=MESH_VIEWS)
    return p


def main(argv=None) -> int:
    from event3dgs_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.probe == "mesh":
        rec = run_mesh(args.capacity, args.ranks, args.width, args.height,
                       args.views)
    elif args.probe == "maxcap" and args.search:
        rec = run_search(args)
    else:
        device = resolve_device(args.device)
        if args.probe in SCENES:
            rec = run_scene(args.probe, args.capacity, args.iters,
                            args.fused_steps,
                            getattr(args, "skip_eager", False), args.width,
                            args.height, device)
        else:
            rec, _ = run_train(args.iters, args.densify, args.fused_steps,
                               args.capacity, args.true_points, args.views,
                               args.width, args.height, device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
