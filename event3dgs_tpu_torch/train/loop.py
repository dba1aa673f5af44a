"""Training loop: view sampling, densification cadence, checkpoints.

Counterpart of ``event3dgs_tpu/train/loop.py``, replaying the reference's
control flow (`train.py:75-336`): random view pick with the manual
test-view holdout, SH degree warm-up (inside the step), densify every
`densification_interval` after `densify_from_iter` until
`densify_until_iter` (capacity grows when candidates outnumber free
slots), opacity reset every `opacity_reset_interval` (10k in event mode),
and the tiled rasterizer's instance budget measured at the start and
re-measured after each densify and every 1000 iterations after the
densify window.

Randomness follows the JAX loop where it can: view picks from
``random.Random(seed)`` and random backgrounds from
``np.random.default_rng(seed)`` in the same order, so both packages see the
same views.  The split samples of densification come from a
``torch.Generator`` seeded with ``seed`` (``jax.random`` has no torch
counterpart), drawn on the CPU so every device gets the same samples.

``pipeline.fused_steps`` N > 1 runs the steps between host events in
chunks of up to N (:func:`next_event` plans them as the JAX loop does;
chunks never cross a log, densify, opacity-reset, instance-recheck, save,
checkpoint or test iteration, and may end on one).  Each chunk's view
indices and backgrounds are drawn on the host in the order the per-step
loop draws them, so the step sequence is the same.  On a CUDA device a
chunk replays a CUDA graph of the step once per step (``train/fused.py``)
and reads its losses back once; on the CPU the same graph-ready step runs
eagerly.  Metrics reach ``on_metrics`` at log ticks only, and callbacks get
copies of the state.  N = 1 (the default) runs one eager step per
iteration.
"""

from __future__ import annotations

import random as pyrandom
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from event3dgs_tpu_torch.models.gaussians import activated
from event3dgs_tpu_torch.ops.binning import count_instances, suggest_instance_cap
from event3dgs_tpu_torch.ops.preprocess import preprocess
from event3dgs_tpu_torch.train.fused import GraphCache
from event3dgs_tpu_torch.train.state import (
    SceneData,
    TrainState,
    grow_state,
    map_tensors,
)
from event3dgs_tpu_torch.train.step import (
    GraphTrainStep,
    make_densify_step,
    make_train_step,
    opacity_reset_step,
)
from event3dgs_tpu_torch.utils import trace
from event3dgs_tpu_torch.utils.config import TrainConfig

# Views held out for evaluation in gray/event modes (`train.py:126-131`).
TEST_VIEW_INDICES = (5, 25, 45, 65, 85)

# Cadence of the instance-cap re-measurement after the densify window.
INSTANCE_RECHECK_INTERVAL = 1000


@dataclass
class TrainCallbacks:
    """Hooks invoked from the loop (logging, saving)."""

    on_metrics: Optional[Callable] = None  # (iteration, metrics dict)
    on_save: Optional[Callable] = None  # (iteration, state)
    on_checkpoint: Optional[Callable] = None  # (iteration, state)
    on_tick: Optional[Callable] = None  # (iteration, live state), log_every
    log_every: int = 10


@dataclass
class TrainResult:
    state: TrainState
    history: list = field(default_factory=list)
    wall_time: float = 0.0


@torch.no_grad()
def probe_instance_count(params, camera) -> int:
    """(tile, gaussian) instances of one view: the counting half of the
    binning, used to size the tiled rasterizer's instance budget.  The
    projection is the render's (the forward kernel on the card), so the
    cap is sized from the radii the render bins.  Each call adds one to
    ``probe_instance_count.calls``, read beside the kernels' launch counts:
    a probe launches the forward preprocess once.  Its ``int`` waits for
    the device: a ``train.probe`` span, counted in ``trace.host_syncs``."""
    probe_instance_count.calls += 1
    with trace.synced("train.probe"):
        act = activated(params)
        proj, _ = preprocess(act.means3d, act.scales, act.rotations, camera,
                             opacities=act.opacities)
        return int(count_instances(proj.mean2d, proj.radius, proj.valid,
                                   camera.width, camera.height,
                                   conic=proj.conic, opacities=act.opacities))


probe_instance_count.calls = 0


def measure_instance_cap(params, cameras, probe_views=8,
                         margin: float = 1.5) -> int:
    """Suggested instance cap: the max count over a camera probe set, with
    headroom for densification growth between re-measurements."""
    n_views = cameras.camera_center.shape[0]
    step = max(1, n_views // probe_views)
    with trace.span("train.instance_cap"):
        worst = max(probe_instance_count(params, cameras[v])
                    for v in range(0, n_views, step))
    return suggest_instance_cap(worst, margin)


def densify_with_growth(state: TrainState, densify_fn, normals_fn,
                        use_size_prune: bool, growth: float = 1.5):
    """Run a densify step, growing capacity until nothing is dropped (the
    reference never drops candidates, `scene/gaussian_model.py:349-403`).

    ``normals_fn(capacity)`` returns the [2, C, 3] split samples; a dropped
    attempt is discarded and re-run at the larger capacity, as the JAX loop
    re-runs with the same key.  Returns (state, grew).
    """
    normals = normals_fn(state.params.capacity)
    new_state, overflow = densify_fn(state, normals, use_size_prune)
    grew = False
    while int(overflow) > 0:
        new_cap = int(state.params.capacity * growth) + int(overflow)
        new_cap = -(-new_cap // 256) * 256
        state = grow_state(state, new_cap)
        grew = True
        normals = normals_fn(new_cap)
        new_state, overflow = densify_fn(state, normals, use_size_prune)
    return new_state, grew


def pick_view_index(rng: pyrandom.Random, n_views: int, mode: str,
                    holdout: bool) -> int:
    """Random view selection with the reference's quirks (`train.py:116-131`):
    event mode samples [2, n-4]; others [2, n-3]; gray/event skip the manual
    test views by decrementing."""
    if mode.startswith("event"):
        idx = rng.randint(2, n_views - 4)
    else:
        idx = rng.randint(2, n_views - 3)
    if holdout and idx in TEST_VIEW_INDICES:
        idx -= 1
    return idx


def opacity_reset_interval(cfg: TrainConfig, mode: str) -> int:
    """Iterations between opacity resets: event mode's override or the
    optimization config's (`train.py:119`)."""
    return (cfg.event.opacity_reset_interval if mode.startswith("event")
            else cfg.optimization.opacity_reset_interval)


def next_event(it0: int, iters: int, cfg: TrainConfig, mode: str,
               log_every: int) -> int:
    """Smallest iteration ≥ ``it0`` at which the loop acts on the host: the
    last one, a log tick, a densify, opacity-reset or instance-recheck
    cadence, a save, checkpoint or test iteration, or ``densify_from_iter``
    (the JAX loop's chunk planner, ``event3dgs_tpu/train/loop.py``)."""
    opt = cfg.optimization
    cands = [iters]
    for interval in (log_every, opt.densification_interval,
                     opacity_reset_interval(cfg, mode),
                     INSTANCE_RECHECK_INTERVAL):
        if interval and interval > 0:
            cands.append(((it0 + interval - 1) // interval) * interval)
    for lst in (cfg.save_iterations, cfg.checkpoint_iterations,
                cfg.test_iterations, (opt.densify_from_iter,)):
        cands.extend(t for t in lst if t >= it0)
    return min(c for c in cands if c >= it0)


def train_loop(
    state: TrainState,
    data: SceneData,
    cfg: TrainConfig,
    mode: str,
    extent: float,
    iterations: Optional[int] = None,
    callbacks: Optional[TrainCallbacks] = None,
) -> TrainResult:
    """Run the optimization.

    Args:
        state: initial train state (on the training device).
        data: scene data on the same device.
        cfg: full config; optimization/event subsections drive the schedule.
        mode: "rgb" | "gray" | "event" | "event_deblur".
        extent: nerf++ scene radius (densification scale reference).
        iterations: override cfg.optimization.iterations.
    """
    with trace.span("train.prologue"):
        opt = cfg.optimization
        ev = cfg.event
        iters = iterations or opt.iterations
        callbacks = callbacks or TrainCallbacks()
        dev = state.params.device

        reset_interval = opacity_reset_interval(cfg, mode)
        holdout = mode != "rgb"  # gray/event hold out the manual test views
        fused = max(int(cfg.pipeline.fused_steps), 1)
        graphs = GraphCache() if fused > 1 else None

        use_tiled = cfg.pipeline.rasterizer == "tiled"
        instance_cap = (measure_instance_cap(state.params, data.cameras)
                        if use_tiled else None)

        def build_step():
            with trace.span("train.build_step"):
                return (make_train_step if graphs is None else GraphTrainStep)(
                    mode, opt, ev, max_sh_degree=state.max_sh_degree,
                    spatial_lr_scale=state.spatial_lr_scale,
                    rasterizer=cfg.pipeline.rasterizer,
                    instance_cap=instance_cap,
                )

        def remeasure(it):
            nonlocal instance_cap, step_fn
            with trace.span("train.remeasure"):
                needed = measure_instance_cap(state.params, data.cameras)
                if needed > instance_cap:
                    instance_cap = needed
                    step_fn = build_step()
                    if callbacks.on_metrics:
                        callbacks.on_metrics(it, {"instance_cap": instance_cap})

        step_fn = build_step()
        densify_fn = make_densify_step(opt, extent)
        bg = (torch.ones if cfg.model.white_background else torch.zeros)(
            3, device=dev)

        view_rng = pyrandom.Random(cfg.seed)
        np_rng = np.random.default_rng(cfg.seed)
        split_rng = torch.Generator().manual_seed(cfg.seed)

        def split_normals(capacity):
            return torch.randn((2, capacity, 3), generator=split_rng).to(dev)

        # callbacks keep what they are given: the fused steps' live state is
        # handed out as a copy
        public = (lambda st: st) if graphs is None else \
            (lambda st: map_tensors(torch.clone, st))
        base_bg = [1.0 if cfg.model.white_background else 0.0] * 3
    history = []
    t0 = time.perf_counter()
    it = 0
    try:
        while it < iters:
            if graphs is None:
                it += 1
                idx = pick_view_index(view_rng, data.num_views, mode, holdout)
                iter_bg = (torch.tensor(np_rng.uniform(size=3),
                                        dtype=torch.float32, device=dev)
                           if opt.random_background else bg)
                state, metrics = step_fn(state, data, idx, idx, idx + 1,
                                         iter_bg)
                with trace.synced("train.loss"):
                    history.append(float(metrics["loss"]))
            else:
                # the steps up to the next host event, at most `fused`
                with trace.span("train.chunk") as chunk:
                    with trace.span("train.rows"):
                        k = min(fused, next_event(it + 1, iters, cfg, mode,
                                                  callbacks.log_every) - it)
                        step0 = int(state.step)  # on the host
                        rows = []
                        for j in range(k):
                            idx = pick_view_index(view_rng, data.num_views,
                                                  mode, holdout)
                            iter_bg = (np_rng.uniform(size=3)
                                       if opt.random_background else base_bg)
                            rows.append(step_fn.row(step0 + 1 + j,
                                                    (idx, idx, idx + 1),
                                                    iter_bg))
                        rows = torch.from_numpy(np.stack(rows))
                    chunk.n = k
                    captures = graphs.captures
                    runner = graphs.get(step_fn, state, data, fused)
                    if graphs.captures > captures and callbacks.on_metrics:
                        callbacks.on_metrics(
                            it, {"graph_capture_ms": runner.capture_ms})
                    history.extend(runner.run(rows))
                    state, metrics = runner.state, runner.slots.metrics
                    it += k

            if it % callbacks.log_every == 0:
                with trace.span("train.log"):
                    if callbacks.on_metrics:
                        values = {}
                        for name, v in metrics.items():
                            with trace.synced("train.metric"):
                                values[name] = float(v)
                        callbacks.on_metrics(it, values)
                    if callbacks.on_tick:
                        callbacks.on_tick(it, public(state))

            # densification (`train.py:316-327`), growing capacity as needed
            if it < opt.densify_until_iter:
                if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                    state, grew = densify_with_growth(
                        state, densify_fn, split_normals,
                        use_size_prune=it > reset_interval)
                    n_alive = int(state.params.alive.sum())
                    if callbacks.on_metrics:
                        callbacks.on_metrics(it, {"num_alive": n_alive})
                        if grew:
                            callbacks.on_metrics(
                                it, {"capacity": state.params.capacity})
                    if n_alive < 16:
                        warnings.warn(
                            f"model nearly dead after densify at iter {it}: "
                            f"{n_alive} alive gaussians. Common causes: the "
                            "reference's hardcoded 20px screen-size prune vs "
                            "large splats, or an opacity collapse.",
                            stacklevel=2,
                        )
                    if use_tiled:
                        remeasure(it)
                if it % reset_interval == 0 or (
                    cfg.model.white_background and it == opt.densify_from_iter
                ):
                    state = opacity_reset_step(state)
            elif use_tiled and it % INSTANCE_RECHECK_INTERVAL == 0:
                # scales keep training after the densify window, so per-view
                # instance counts can outgrow the budget: re-measure
                remeasure(it)

            if callbacks.on_save and it in cfg.save_iterations:
                callbacks.on_save(it, public(state))
            if callbacks.on_checkpoint and it in cfg.checkpoint_iterations:
                callbacks.on_checkpoint(it, public(state))
    finally:
        if graphs is not None:
            graphs.clear()  # its graph; the live state stays as the result

    if dev.type == "cuda":
        with trace.synced("train.sync"):
            torch.cuda.synchronize(dev)
    return TrainResult(state=state, history=history,
                       wall_time=time.perf_counter() - t0)
