"""Host-side training loop over a (data × gauss) rank grid.

Counterpart of ``event3dgs_tpu/train/loop_sharded.py``.  Every rank of the
mesh runs this loop with the same control flow: each step consumes ``B``
views (``data·gauss`` in exact mode, ``data`` in partials mode) through
``parallel.sharded_train.make_sharded_train_step``, and Gaussian storage
stays sharded over ``gauss`` between host events.  ``state.step`` counts
reference iterations (views consumed), so every cadence of the reference
schedule (densify every ``densification_interval``, opacity reset, SH
warm-up, lr decay, `train.py:95-332`) fires at the same view counts as
in ``train/loop.py``; with a batch stride it fires on interval crossings.

Densification is a host round trip: the state is gathered whole on every
rank, the single-device densify (with capacity growth, never dropping a
candidate) runs on every rank on the same state with the same split
samples (one seeded ``torch.Generator`` per job, drawn identically by
every rank), the partials strategy re-partitions by depth, and each rank
takes its shard again.  Views come from ``random.Random(seed)`` drawn
identically on every rank, or from ``view_batch_fn``.

Every rank must pass callbacks with the same hooks set: a hook receives
the gathered state, and the gather is a collective.  Which rank writes
files is the caller's choice (``cli.train``: global rank 0).
"""

from __future__ import annotations

import random as pyrandom
import time
from typing import Callable, Optional

import numpy as np
import torch

from event3dgs_tpu_torch.train.loop import (
    INSTANCE_RECHECK_INTERVAL,
    TrainCallbacks,
    TrainResult,
    densify_with_growth,
    measure_instance_cap,
    pick_view_index,
)
from event3dgs_tpu_torch.train.state import SceneData, TrainState
from event3dgs_tpu_torch.train.step import make_densify_step, opacity_reset_step
from event3dgs_tpu_torch.utils.config import TrainConfig


def _crossed(prev: int, now: int, interval: int) -> bool:
    """Did the view counter cross a multiple of ``interval``?"""
    return now // interval > prev // interval


def train_loop_sharded(
    state: TrainState,
    data: SceneData,
    cfg: TrainConfig,
    mode: str,
    extent: float,
    mesh,
    iterations: Optional[int] = None,
    callbacks: Optional[TrainCallbacks] = None,
    view_batch_fn: Optional[Callable] = None,
) -> TrainResult:
    """Run the optimization on the mesh's ranks.

    Args mirror ``train_loop``; ``state`` is the full state (the same on
    every rank), ``mesh`` a :class:`~parallel.mesh.Mesh`, and
    ``view_batch_fn(it) -> (idx_main [B], idx_now [B], idx_next [B])``
    optionally overrides view sampling with the global batch (the same on
    every rank).  Returns the full final state on every rank.
    """
    from event3dgs_tpu_torch.parallel.partition import repartition_by_depth
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        unshard_state,
    )

    opt = cfg.optimization
    ev = cfg.event
    iters = iterations or opt.iterations
    callbacks = callbacks or TrainCallbacks()
    gauss = mesh.gauss
    gauss_mode = cfg.pipeline.gauss_mode
    exact = gauss_mode == "exact"
    b = mesh.data * (gauss if exact else 1)
    dev = mesh.device

    opacity_reset_interval = (ev.opacity_reset_interval
                              if mode.startswith("event")
                              else opt.opacity_reset_interval)
    holdout = mode != "rgb"

    use_tiled = cfg.pipeline.rasterizer == "tiled"
    # the exchange rasterizes the full splat set, and a partials shard may
    # hold most of a view's instances: budget the full-scene count
    instance_cap = (measure_instance_cap(state.params, data.cameras)
                    if use_tiled else None)

    def build_step():
        return make_sharded_train_step(
            mode, opt, ev, mesh, max_sh_degree=state.max_sh_degree,
            spatial_lr_scale=state.spatial_lr_scale,
            rasterizer=cfg.pipeline.rasterizer, instance_cap=instance_cap,
            gauss_mode=gauss_mode)

    step_fn = build_step()
    densify_fn = make_densify_step(opt, extent)

    # the exchange restores the unsharded splat order, so slot layout is
    # irrelevant; the partials merge wants depth-quantile shards
    if not exact:
        state = repartition_by_depth(state, data.cameras, gauss)
    state = shard_train_state(state, mesh)

    bg = (torch.ones if cfg.model.white_background else torch.zeros)(
        3, device=dev)
    view_rng = pyrandom.Random(cfg.seed)
    np_rng = np.random.default_rng(cfg.seed)
    split_rng = torch.Generator().manual_seed(cfg.seed)

    def split_normals(capacity):
        return torch.randn((2, capacity, 3), generator=split_rng).to(dev)

    def default_view_batch(_it):
        idx = [pick_view_index(view_rng, data.num_views, mode, holdout)
               for _ in range(b)]
        return idx, idx, [i + 1 for i in idx]

    sample = view_batch_fn or default_view_batch

    history = []
    t0 = time.perf_counter()
    it = 0
    while it < iters:
        idx_main, idx_now, idx_next = sample(it)
        iter_bg = (torch.tensor(np_rng.uniform(size=3), dtype=torch.float32,
                                device=dev)
                   if opt.random_background else bg)
        state, metrics = step_fn(state, data, idx_main, idx_now, idx_next,
                                 iter_bg)
        prev, it = it, it + b
        history.append(float(metrics["loss"]))

        if _crossed(prev, it, callbacks.log_every):
            if callbacks.on_metrics:
                callbacks.on_metrics(
                    it, {k: float(v) for k, v in metrics.items()})
            if callbacks.on_tick:
                callbacks.on_tick(it, unshard_state(state, mesh))

        if it < opt.densify_until_iter:
            if it > opt.densify_from_iter and _crossed(
                    prev, it, opt.densification_interval):
                use_size_prune = it > opacity_reset_interval
                full, grew = densify_with_growth(
                    unshard_state(state, mesh), densify_fn, split_normals,
                    use_size_prune)
                if not exact:
                    full = repartition_by_depth(full, data.cameras, gauss)
                if callbacks.on_metrics:
                    callbacks.on_metrics(
                        it, {"num_alive": int(full.params.alive.sum())})
                    if grew:
                        callbacks.on_metrics(
                            it, {"capacity": full.params.capacity})
                if use_tiled:
                    needed = measure_instance_cap(full.params, data.cameras)
                    if needed > instance_cap:
                        instance_cap = needed
                        step_fn = build_step()
                state = shard_train_state(full, mesh)
            if _crossed(prev, it, opacity_reset_interval) or (
                    cfg.model.white_background
                    and prev < opt.densify_from_iter <= it):
                # per slot, so each shard resets its own
                state = opacity_reset_step(state)
        elif use_tiled and _crossed(prev, it, INSTANCE_RECHECK_INTERVAL):
            # scales keep training after the densify window, so per-view
            # instance counts can outgrow the budget: re-measure
            needed = measure_instance_cap(unshard_state(state, mesh).params,
                                          data.cameras)
            if needed > instance_cap:
                instance_cap = needed
                step_fn = build_step()
                if callbacks.on_metrics:
                    callbacks.on_metrics(it, {"instance_cap": instance_cap})

        if callbacks.on_save and any(prev < s <= it
                                     for s in cfg.save_iterations):
            callbacks.on_save(it, unshard_state(state, mesh))
        if callbacks.on_checkpoint and any(
                prev < s <= it for s in cfg.checkpoint_iterations):
            callbacks.on_checkpoint(it, unshard_state(state, mesh))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return TrainResult(state=unshard_state(state, mesh), history=history,
                       wall_time=wall)
