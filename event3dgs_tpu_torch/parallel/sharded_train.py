"""Sharded multi-view train step over a (data × gauss) rank grid.

Counterpart of ``event3dgs_tpu/parallel/sharded_train.py``.  The reference
trains one view per iteration on one GPU (`train.py:137-144`); this step
batches views over the ranks of a :class:`~parallel.mesh.Mesh`:

- **data axis**: the view batch shards over the data ranks; parameter
  gradients and densify stats are summed over ``data``.
- **gauss axis**: Gaussian storage (params, Adam moments, densify stats)
  shards its capacity dimension: every rank holds C/K rows, never the
  whole set.

Two compositing strategies for the gauss axis (``gauss_mode``):

- ``"exact"`` (default): per view, the group exchanges projected splats
  (``parallel.exchange``) and each rank rasterizes the full splat set for
  its own view: the unsharded renderer's result on any geometry, and the
  gauss axis renders K more views per step (D·K views per step).
- ``"partials"``: each rank rasterizes only its own Gaussians into
  (rgb, log T) partials merged in per-view shard depth order
  (``parallel.compose``): approximate on orbit rigs, by design.

JAX runs the body under ``shard_map`` and takes the cross-rank gradient
reductions from its AD transposes.  Here every rank runs the body on its
own slot block and views, the collectives it differentiates through carry
their own backward rules (``parallel.collectives``), and the reductions
JAX's transposes insert are explicit, after the backward pass:

- parameter gradients are summed over ``data`` (each rank's backward has
  already gathered its gauss group's views' sensitivities to its slots);
- the contrast gradient is summed over every rank (exact) or over ``data``
  (partials, where the gauss group shares one loss);
- the mean2d tap gradients are not reduced: each is this rank's own.

Each sum is an all-gather and a sum in rank order, so data replicas end a
step with bitwise identical parameters.

Densify stats under batching accumulate per view, as the reference does
per iteration (`train.py:317-320`): ``Σ_v ‖g_v‖`` into ``grad_accum`` and
``Σ_v vis_v`` into ``denom`` (summed over ``data``), the max radius over
``data``; each view's tap gradient is scaled by (0.5W, 0.5H) and by the
global batch to undo the loss's batch mean, so the reference's 2e-4
threshold transfers unchanged.  ``state.step`` counts reference
iterations (views consumed): one step adds the global batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from event3dgs_tpu_torch.losses.event import effective_contrast
from event3dgs_tpu_torch.losses.modes import (
    deblur_mix,
    event_total_loss,
    gray_total_loss,
    rgb_total_loss,
)
from event3dgs_tpu_torch.models.densify import DensifyStats
from event3dgs_tpu_torch.models.gaussians import (
    activated,
    trainable_dict,
    with_trainable,
)
from event3dgs_tpu_torch.models.optimizer import adam_update
from event3dgs_tpu_torch.ops.render import render_partials
from event3dgs_tpu_torch.parallel.collectives import gather, ordered_sum
from event3dgs_tpu_torch.parallel.compose import merge_depth_partials, view_depth_ranks
from event3dgs_tpu_torch.parallel.exchange import render_view_exchange
from event3dgs_tpu_torch.parallel.mesh import GAUSS_AXIS, Mesh, data_sharding, gauss_sharding
from event3dgs_tpu_torch.train.state import (
    SceneData,
    TrainState,
    active_sh_degree,
    map_tensors,
    sh_coeff_mask,
)
from event3dgs_tpu_torch.train.step import MODES, _lr_tree
from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig


def _is_capacity_leaf(leaf: torch.Tensor, capacity: int) -> bool:
    return leaf.ndim >= 1 and leaf.shape[0] == capacity


def state_partition_specs(state: TrainState, mesh: Mesh):
    """The state's tree with ``"gauss"`` at every capacity tensor (sharded
    over the gauss axis) and ``None`` at the replicated ones."""
    cap = state.params.capacity
    return map_tensors(
        lambda leaf: GAUSS_AXIS if _is_capacity_leaf(leaf, cap) else None,
        state)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's shard of a full train state, on the mesh's device: every
    per-Gaussian tensor (params, Adam moments, densify stats) cut to this
    rank's C/K slots, the scalars kept whole.  Every rank must hold the
    same full state (true after init and after a densify round trip)."""
    cap = state.params.capacity
    block = gauss_sharding(mesh, cap)

    def place(leaf):
        if _is_capacity_leaf(leaf, cap):
            leaf = leaf[block]
        return leaf.to(mesh.device).clone()

    # the step counter stays on the host
    return map_tensors(place, state).replace(step=state.step.clone())


@torch.no_grad()
def unshard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The full train state on every rank, gathered over the gauss group
    (collective: every rank calls it together).  Used at densification
    boundaries, where densify runs on the whole set, and for saving."""
    cap = state.params.capacity
    group = mesh.gauss_group

    def pull(leaf):
        if not _is_capacity_leaf(leaf, cap):
            return leaf
        if leaf.dtype == torch.bool:
            return gather(leaf.to(torch.uint8), group).flatten(0, 1).bool()
        return gather(leaf, group).flatten(0, 1)

    return map_tensors(pull, state)


def make_sharded_train_step(
    mode: str,
    opt_cfg: OptimizationConfig,
    event_cfg: EventConfig,
    mesh: Mesh,
    max_sh_degree: int = 3,
    spatial_lr_scale: float = 1.0,
    rasterizer: str = "tiled",
    instance_cap: int | None = None,
    gauss_mode: str = "exact",
) -> Callable:
    """Build the batched/sharded train step.

    Signature: ``(state, data, idx_main [B], idx_now [B], idx_next [B], bg)
    → (state, metrics)``, with ``state`` this rank's shard and the global
    view batch (the same on every rank; each rank takes its own block).
    With ``gauss_mode="exact"`` B is a multiple of data·gauss; with
    ``"partials"`` a multiple of data, and the state should be
    depth-partitioned (``parallel.partition.repartition_by_depth``).
    """
    if gauss_mode not in ("exact", "partials"):
        raise ValueError(
            f"gauss_mode must be 'exact' or 'partials', got {gauss_mode!r}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    lambda_dssim = (event_cfg.event_lambda_dssim if mode.startswith("event")
                    else opt_cfg.lambda_dssim)
    gauss_size = mesh.gauss
    exact = gauss_mode == "exact"
    # exact: the gauss axis renders its own views, so one step consumes
    # b_local·data·gauss reference iterations; partials shares views
    views_per_local = mesh.data * (gauss_size if exact else 1)

    def exchange_render(act, features, cameras, views, tap, bg):
        ex = render_view_exchange(
            act.means3d, features, act.opacities, act.scales, act.rotations,
            cameras, views, mesh.gauss_group, max_sh_degree, taps=tap,
            rasterizer=rasterizer, instance_cap=instance_cap)
        img = ex.rgb + torch.exp(ex.logt)[:, :, None] * bg[None, None, :]
        return img, ex.radii_own, ex.vis_own

    def partials_render(act, features, cameras, views, tap, bg):
        pm = render_partials(
            act.means3d, features, act.opacities, act.scales, act.rotations,
            cameras[views[0]], sh_degree=max_sh_degree, mean2d_tap=tap,
            rasterizer=rasterizer, instance_cap=instance_cap)
        ranks = view_depth_ranks(pm.depth, pm.visibility, mesh.gauss_group,
                                 gauss_size)
        img = merge_depth_partials(pm.rgb, pm.logt, bg, mesh.gauss_group,
                                   gauss_size, ranks=ranks)
        return img, pm.radii, pm.visibility

    render_view = exchange_render if exact else partials_render

    def view_loss(act, features, contrast, tap, data, group_main, group_now,
                  group_next, bg):
        # the group's views in rank order (exact) or the shared view
        # (partials); this rank's own is at its gauss rank (exact)
        me = mesh.gauss_rank if exact else 0
        im, inow, inext = group_main[me], group_now[me], group_next[me]
        img_main, radii, vis = render_view(act, features, data.cameras,
                                           group_main, tap, bg)
        gt_main = data.images[im]
        if mode == "rgb":
            loss, _ = rgb_total_loss(img_main, gt_main, lambda_dssim)
        elif mode == "gray":
            loss, _ = gray_total_loss(img_main, gt_main, lambda_dssim)
        else:
            img_now, _, _ = render_view(act, features, data.event_cameras,
                                        group_now, None, bg)
            img_next, _, _ = render_view(act, features, data.event_cameras,
                                         group_next, None, bg)
            loss, _ = event_total_loss(
                img_now, img_next, img_main, data.event_images[inow],
                data.event_images[inext], gt_main,
                effective_contrast(contrast,
                                   event_cfg.contrast_parameterization),
                gt_contrast=event_cfg.gt_contrast,
                event_weight=event_cfg.event_weight)
            if mode == "event_deblur":
                loss, _ = deblur_mix(loss, img_main, data.blurry_images[im],
                                     event_cfg.blur_alpha)
        return loss, radii, vis

    def train_step(state: TrainState, data: SceneData, idx_main, idx_now,
                   idx_next, bg: torch.Tensor):
        idx_main, idx_now, idx_next = (
            [int(i) for i in idx] for idx in (idx_main, idx_now, idx_next))
        b_global = len(idx_main)
        if b_global % views_per_local:
            raise ValueError(f"view batch {b_global} is not a multiple of "
                             f"{views_per_local} ({gauss_mode} mode)")
        b_local = b_global // views_per_local
        if exact:
            # slot d·K + j holds views [slot·b_local, (slot + 1)·b_local)
            first = mesh.data_rank * gauss_size * b_local
            groups = [[[idx[first + j * b_local + v] for j in range(gauss_size)]
                       for idx in (idx_main, idx_now, idx_next)]
                      for v in range(b_local)]
        else:
            mine = data_sharding(mesh, b_global)
            groups = [[[idx[mine][v]] for idx in (idx_main, idx_now, idx_next)]
                      for v in range(b_local)]
        params = state.params
        dev = params.device
        cap_local = params.capacity
        # state.step counts reference iterations (views consumed), so the
        # lr and SH schedules of the one-view loop transfer unchanged
        step = int(state.step) + b_global
        cmask = sh_coeff_mask(active_sh_degree(step, max_sh_degree),
                              (max_sh_degree + 1) ** 2, device=dev)

        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in trainable_dict(params).items()}
        contrast = state.contrast.detach().requires_grad_(True)
        # per local view, the screen-grad zeros of this shard's slots under
        # each rendered camera: [B, K, C/K, 2] exact, [B, C/K, 2] partials
        tap_shape = ((b_local, gauss_size, cap_local, 2) if exact
                     else (b_local, cap_local, 2))
        taps = torch.zeros(tap_shape, device=dev, requires_grad=True)
        act = activated(with_trainable(params, leaves))
        features = act.features * cmask[None, :, None]
        total = torch.zeros((), device=dev)
        radii_l, vis_l = [], []
        for v, (g_main, g_now, g_next) in enumerate(groups):
            lv, radii, vis = view_loss(act, features, contrast, taps[v],
                                       data, g_main, g_now, g_next, bg)
            total = total + lv
            radii_l.append(radii)
            vis_l.append(vis)
        loss = total / b_global
        inputs = [*leaves.values(), contrast, taps]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        g_params = dict(zip(leaves, grads[:-2]))
        g_contrast, g_taps = grads[-2], grads[-1]

        with torch.no_grad():
            radii = torch.stack(radii_l)
            vis_f = torch.stack(vis_l).to(torch.float32)
            view_dims = (0, 1) if exact else (0,)
            scale = torch.tensor(
                [0.5 * data.cameras.width, 0.5 * data.cameras.height],
                dtype=g_taps.dtype, device=dev)
            gnorm = torch.linalg.norm(g_taps * scale, dim=-1) * b_global
            # one gather over data: [grads | contrast grad | loss | stats
            # sums] summed in rank order, [max radii | any visible] maxed
            sums = [g.reshape(-1) for g in g_params.values()] + [
                g_contrast.reshape(1), loss.detach().reshape(1),
                torch.sum(gnorm * vis_f, dim=view_dims),
                torch.sum(vis_f, dim=view_dims)]
            maxes = [torch.amax(radii * vis_f, dim=view_dims),
                     torch.amax(vis_f, dim=view_dims)]
            n_sum = sum(t.numel() for t in sums)
            rows = gather(torch.cat(sums + maxes), mesh.data_group)
            summed = ordered_sum(rows[:, :n_sum])
            maxed = rows[:, n_sum:].amax(dim=0)
            off = 0
            for k, g in g_params.items():
                g_params[k] = summed[off: off + g.numel()].reshape(g.shape)
                off += g.numel()
            g_contrast = summed[off].reshape(g_contrast.shape)
            loss_d = summed[off + 1]
            acc, den = summed[off + 2:].split(cap_local)
            rmax, any_vis = maxed.split(cap_local)
            # over gauss: contrast grad and loss (exact: the group's views
            # differ), visible count (every mode: the slots differ)
            per_g = gather(torch.stack([g_contrast.reshape(()), loss_d,
                                        any_vis.sum()]), mesh.gauss_group)
            num_visible = ordered_sum(per_g[:, 2])
            if exact:
                g_contrast = ordered_sum(per_g[:, 0]).reshape(g_contrast.shape)
                loss_total = ordered_sum(per_g[:, 1])
            else:
                loss_total = loss_d

            lrs = _lr_tree(opt_cfg, step, spatial_lr_scale)
            new_tree, new_opt = adam_update(trainable_dict(params), g_params,
                                            state.opt_state, lrs)
            if mode.startswith("event"):
                new_contrast, new_copt = adam_update(
                    state.contrast, g_contrast, state.contrast_opt,
                    event_cfg.contrast_lr)
            else:
                new_contrast, new_copt = state.contrast, state.contrast_opt
            new_stats = DensifyStats(
                grad_accum=state.stats.grad_accum + acc,
                denom=state.stats.denom + den,
                max_radii2d=torch.maximum(state.stats.max_radii2d, rmax),
            )
            metrics = {
                "loss": loss_total,
                "contrast": effective_contrast(
                    new_contrast, event_cfg.contrast_parameterization),
                "num_visible": num_visible,
            }
        new_state = state.replace(
            params=with_trainable(params, new_tree),
            opt_state=new_opt,
            contrast=new_contrast,
            contrast_opt=new_copt,
            stats=new_stats,
            step=state.step + b_global,
        )
        return new_state, metrics

    return train_step
