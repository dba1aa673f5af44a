"""The train step: render → mode loss → grads → Adam → stats.

Counterpart of ``event3dgs_tpu/train/step.py``.  :func:`make_train_step`
closes over the configuration (mode, optimizer hyperparameters, rasterizer,
instance budget) and returns

    (state, scene_data, idx_main, idx_now, idx_next, bg) → (state, metrics)

covering the reference's per-iteration work (`train.py:95-332`) minus
densification (:func:`make_densify_step`, every `densification_interval`
iterations) and the opacity reset (:func:`opacity_reset_step`).  A step
returns a new state and leaves its input state untouched.

:class:`GraphTrainStep` is the same step in the form a CUDA graph can
hold (``pipeline.fused_steps > 1``, ``train/fused.py``): it reads what
changes from step to step (views, background, position learning rate, SH
mask) from a row of a device table picked by a device cursor, and writes
the new state in place into the state it is given.

Gradients come from one backward pass with respect to the six trainable
leaves, the contrast ``c`` and a zero [C, 2] tap added to the main view's
projected means; the tap's gradient is what the reference reads from
``screenspace_points.grad`` for densification (`train.py:319-320`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.core.schedules import exponential_lr
from event3dgs_tpu_torch.losses.event import (
    Frame,
    Partials,
    effective_contrast,
)
from event3dgs_tpu_torch.losses.modes import (
    event_total_loss,
    gray_total_loss,
    rgb_total_loss,
)
from event3dgs_tpu_torch.models.densify import (
    densify_and_prune,
    reset_opacity,
    update_stats,
)
from event3dgs_tpu_torch.models.gaussians import (
    activated,
    trainable_dict,
    with_trainable,
)
from event3dgs_tpu_torch.models.optimizer import AdamGroup, adam_update_groups
from event3dgs_tpu_torch.ops.preprocess import preprocess_views
from event3dgs_tpu_torch.ops.render import rasterize_projected
from event3dgs_tpu_torch.train.state import (
    SceneData,
    TrainState,
    active_sh_degree,
    copy_tree_,
    sh_coeff_mask,
)
from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

MODES = ("rgb", "gray", "event", "event_deblur")


def _lr_tree(opt_cfg: OptimizationConfig, step: int, spatial_scale: float) -> dict:
    """Per-group learning rates (`gaussian_model.py:154-167`)."""
    xyz_lr = exponential_lr(
        step,
        opt_cfg.position_lr_init * spatial_scale,
        opt_cfg.position_lr_final * spatial_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return {
        "xyz": xyz_lr,
        "features_dc": opt_cfg.feature_lr,
        "features_rest": opt_cfg.feature_lr / 20.0,
        "opacity": opt_cfg.opacity_lr,
        "scaling": opt_cfg.scaling_lr,
        "rotation": opt_cfg.rotation_lr,
    }


class StepInputs(NamedTuple):
    """The leaves a step differentiates and what it renders from them."""

    leaves: dict  # the six trainable tensors, detached, requiring grad
    contrast: torch.Tensor  # the raw contrast, requiring grad
    tap: torch.Tensor  # [C, 2] zeros requiring grad (the mean2d tap)
    act: object  # the activated Gaussians of ``leaves``, without features
    cmask: torch.Tensor  # [K] SH mask of the step's degree


def step_inputs(state: TrainState, max_sh_degree: int = 3,
                cmask: Optional[torch.Tensor] = None) -> StepInputs:
    """The differentiable inputs of ``state``'s next step: fresh leaves of
    its trainable tensors and contrast, the zero tap, the activated
    Gaussians (the preprocess reads the feature leaves themselves) and the
    SH mask of the step's degree (``cmask``, [K] float, where given; else
    from ``state.step``)."""
    params = state.params
    dev = params.device
    if cmask is None:
        step = int(state.step) + 1  # reference iterations start at 1
        cmask = sh_coeff_mask(active_sh_degree(step, max_sh_degree),
                              (max_sh_degree + 1) ** 2, device=dev)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in trainable_dict(params).items()}
    contrast = state.contrast.detach().requires_grad_(True)
    tap = torch.zeros(params.capacity, 2, device=dev, requires_grad=True)
    act = activated(with_trainable(params, leaves), features=False)
    return StepInputs(leaves, contrast, tap, act, cmask)


class StepViews(NamedTuple):
    """The cameras a step renders and the images it compares them with
    (None where its mode needs none): each image as a tensor or as a
    ``Frame`` of its stack, which the loss picks itself."""

    cam_main: Camera
    gt_main: torch.Tensor | Frame
    cam_now: Optional[Camera] = None
    cam_next: Optional[Camera] = None
    gt_now: Optional[torch.Tensor | Frame] = None
    gt_next: Optional[torch.Tensor | Frame] = None
    blurry_main: Optional[torch.Tensor | Frame] = None


def take(x, index: torch.Tensor):
    """Row ``index`` ([1] int64 on ``x``'s device) of a tensor or of a
    camera batch, picked on the device (``index_select``): the host never
    reads the index, so a CUDA graph can hold the pick."""
    if isinstance(x, Camera):
        return dataclasses.replace(x, **{
            f: getattr(x, f).index_select(0, index)[0]
            for f in ("world_view", "full_proj", "camera_center", "tan_fovx",
                      "tan_fovy")})
    return x.index_select(0, index)[0]


def step_views(data: SceneData, mode: str, idx_main, idx_now, idx_next,
               pick=lambda x, i: x[i], frame=None) -> StepViews:
    """What a step of ``mode`` reads from ``data``: the main view
    ``idx_main`` and, in the event modes, the event pair (``idx_now``,
    ``idx_next``) and the blurry capture.  ``pick(stack, index)`` takes one
    view of a stack (default: Python int indexing; :func:`take` for device
    indices); ``frame(stack, index)`` one GT image, which the loss reads
    (default: ``pick``; ``Frame`` for device indices, so that the loss
    kernels read the frame where it lies)."""
    event = mode.startswith("event")
    frame = frame or pick
    return StepViews(
        cam_main=pick(data.cameras, idx_main),
        gt_main=frame(data.images, idx_main),
        cam_now=pick(data.event_cameras, idx_now) if event else None,
        cam_next=pick(data.event_cameras, idx_next) if event else None,
        gt_now=frame(data.event_images, idx_now) if event else None,
        gt_next=frame(data.event_images, idx_next) if event else None,
        blurry_main=(frame(data.blurry_images, idx_main)
                     if mode == "event_deblur" else None),
    )


def make_loss_and_grads(
    mode: str,
    event_cfg: EventConfig,
    lambda_dssim: float,
    max_sh_degree: int = 3,
    rasterizer: str = "reference",
    instance_cap: int | None = None,
    plain: bool = False,
) -> Callable:
    """The step's loss and its gradients:

        (state, data, idx_main, idx_now, idx_next, bg) →
            (loss, aux, {"params": dict, "contrast": [], "tap": [C, 2]})

    ``plain`` runs the plain versions of the preprocess, tiled rasterizer
    and loss kernels on CUDA tensors (for holding the kernel path against
    them).
    """
    views_fn = _views_loss_and_grads(mode, event_cfg, lambda_dssim,
                                     max_sh_degree, rasterizer, instance_cap,
                                     plain)

    def loss_and_grads(state: TrainState, data: SceneData, idx_main: int,
                       idx_now: int, idx_next: int, bg: torch.Tensor):
        return views_fn(state, step_views(data, mode, idx_main, idx_now,
                                          idx_next), bg)

    return loss_and_grads


def _views_loss_and_grads(mode, event_cfg, lambda_dssim, max_sh_degree,
                          rasterizer, instance_cap, plain=False) -> Callable:
    """:func:`make_loss_and_grads`'s function on views already picked:
    ``(state, views, bg, cmask=None) → (loss, aux, grads)``."""

    def loss_and_grads(state: TrainState, views: StepViews, bg: torch.Tensor,
                       cmask: Optional[torch.Tensor] = None):
        leaves, contrast, tap, act, cmask = step_inputs(
            state, max_sh_degree, cmask)
        cams = ([views.cam_main, views.cam_now, views.cam_next]
                if mode.startswith("event") else [views.cam_main])
        # one preprocess call for the step's views (the main view first,
        # which takes the tap) that also writes each view's packed rows,
        # then per view the rasterizer's (rgb, log T)
        projected = preprocess_views(
            act.means3d, act.scales, act.rotations, cams,
            opacities=act.opacities, features_dc=leaves["features_dc"],
            features_rest=leaves["features_rest"], cmask=cmask,
            sh_degree=max_sh_degree, plain=plain, mean2d_tap=tap,
            packed=True)
        partials = [Partials(*rasterize_projected(
            proj, colors, act.opacities, cam, rasterizer, instance_cap,
            plain, feat))
            for cam, (proj, colors, feat) in zip(cams, projected)]
        proj_main = projected[0][0]
        # the loss composes the renders over bg itself
        if mode in ("rgb", "gray"):
            total = rgb_total_loss if mode == "rgb" else gray_total_loss
            loss, aux = total(partials[0], views.gt_main, lambda_dssim,
                              plain=plain, background=bg)
        else:  # event / event_deblur (the blurry capture in the latter)
            loss, aux = event_total_loss(
                partials[1], partials[2], partials[0],
                views.gt_now, views.gt_next, views.gt_main,
                effective_contrast(contrast,
                                   event_cfg.contrast_parameterization),
                gt_contrast=event_cfg.gt_contrast,
                event_weight=event_cfg.event_weight,
                blurry_main=views.blurry_main,
                blur_alpha=event_cfg.blur_alpha, plain=plain,
                background=bg,
            )
        aux["radii"] = proj_main.radius
        aux["visibility"] = proj_main.valid

        inputs = [*leaves.values(), contrast, tap]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        return loss.detach(), aux, {
            "params": dict(zip(leaves, grads[:-2])),
            "contrast": grads[-2],
            "tap": grads[-1],
        }

    return loss_and_grads


def _lambda_dssim(mode: str, opt_cfg: OptimizationConfig,
                  event_cfg: EventConfig) -> float:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return (event_cfg.event_lambda_dssim if mode.startswith("event")
            else opt_cfg.lambda_dssim)


def _updated(state: TrainState, mode: str, event_cfg: EventConfig, loss, aux,
             grads, lrs, cam_main: Camera, in_place: bool = False):
    """The state after a step's Adam updates and densify stats (its
    counter unchanged), and the step's metrics.  The parameters, the
    contrast and their moments and counts are new tensors, or with
    ``in_place`` ``state``'s own, written in place."""
    groups = [AdamGroup(trainable_dict(state.params), grads["params"],
                        state.opt_state, lrs)]
    if mode.startswith("event"):  # learnable contrast (`train.py:210-212`)
        groups.append(AdamGroup(state.contrast, grads["contrast"],
                                state.contrast_opt, event_cfg.contrast_lr))
    # one launch for both groups on a card
    out = [(g.params, g.state) for g in groups] if in_place else None
    updated = adam_update_groups(groups, out=out)
    new_tree, new_opt = updated[0]
    new_contrast, new_copt = (updated[1] if len(updated) > 1
                              else (state.contrast, state.contrast_opt))
    # the (0.5W, 0.5H) scale matches the reference CUDA backward's
    # NDC-Jacobian pre-scaling (see update_stats)
    new_stats = update_stats(
        state.stats, grads["tap"], aux["radii"], aux["visibility"],
        grad_scale=(0.5 * cam_main.width, 0.5 * cam_main.height))

    with torch.no_grad():
        metrics = {
            "loss": loss,
            "l1": aux.get("l1", aux.get("event_l1", loss)).detach(),
            "contrast": effective_contrast(
                new_contrast, event_cfg.contrast_parameterization),
            "contrast_raw": new_contrast,
            "num_visible": aux["visibility"].sum(),
        }
        for k in ("event_l1", "intensity_l1", "coverage", "blur_l1"):
            if k in aux:
                metrics[k] = aux[k].detach()
    new_state = state.replace(
        params=with_trainable(state.params, new_tree),
        opt_state=new_opt,
        contrast=new_contrast,
        contrast_opt=new_copt,
        stats=new_stats,
    )
    return new_state, metrics


def make_train_step(
    mode: str,
    opt_cfg: OptimizationConfig,
    event_cfg: EventConfig,
    max_sh_degree: int = 3,
    spatial_lr_scale: float = 1.0,
    rasterizer: str = "reference",
    instance_cap: int | None = None,
) -> Callable:
    """Build the train step for a training mode.

    ``instance_cap`` is the tiled rasterizer's instance budget; the training
    loop sizes it from measured counts and rebuilds the step when the scene
    outgrows it (`train/loop.py`).  None falls back to the default rule.
    """
    lambda_dssim = _lambda_dssim(mode, opt_cfg, event_cfg)
    grads_fn = _views_loss_and_grads(mode, event_cfg, lambda_dssim,
                                     max_sh_degree, rasterizer, instance_cap)

    def train_step(state: TrainState, data: SceneData, idx_main: int,
                   idx_now: int, idx_next: int, bg: torch.Tensor):
        views = step_views(data, mode, idx_main, idx_now, idx_next)
        loss, aux, grads = grads_fn(state, views, bg)
        step = int(state.step) + 1
        lrs = _lr_tree(opt_cfg, step, spatial_lr_scale)
        new_state, metrics = _updated(state, mode, event_cfg, loss, aux,
                                      grads, lrs, views.cam_main)
        return new_state.replace(step=state.step + 1), metrics

    return train_step


class StepSlots:
    """Where :class:`GraphTrainStep` writes what a step returns: the loss
    of table row r into ``history[r]``, the metrics into ``metrics`` (made
    by the first call, written in place after it)."""

    def __init__(self, rows: int, device):
        self.history = torch.zeros(rows, dtype=torch.float32, device=device)
        self.metrics: Optional[dict] = None


class GraphTrainStep:
    """:func:`make_train_step`'s step with no host value inside, for a CUDA
    graph to hold (``train/fused.py``).

    ``step(state, data, table, cursor, slots)`` runs the step of table row
    ``cursor`` ([1] int64 on the state's device): the row (:meth:`row`,
    [columns] float32) holds the main and event-pair view indices, the
    background, the position learning rate and the SH coefficient mask, so
    nothing the step reads changes its address or asks the host.  It writes
    the new parameters, Adam state, contrast and densify stats in place into
    ``state`` (Adam writes its tensors itself; its host counter
    ``state.step`` is the caller's to advance),
    the loss into ``slots.history[cursor]`` and the metrics into
    ``slots.metrics``, then advances ``cursor``.  From the same state and
    inputs it computes what :func:`make_train_step`'s step computes.
    """

    def __init__(self, mode: str, opt_cfg: OptimizationConfig,
                 event_cfg: EventConfig, max_sh_degree: int = 3,
                 spatial_lr_scale: float = 1.0, rasterizer: str = "reference",
                 instance_cap: int | None = None):
        lambda_dssim = _lambda_dssim(mode, opt_cfg, event_cfg)
        self.mode, self.opt_cfg, self.event_cfg = mode, opt_cfg, event_cfg
        self.max_sh_degree = max_sh_degree
        self.spatial_lr_scale = spatial_lr_scale
        self.lrs = _lr_tree(opt_cfg, 0, spatial_lr_scale)  # "xyz" from a row
        self.grads_fn = _views_loss_and_grads(
            mode, event_cfg, lambda_dssim, max_sh_degree, rasterizer,
            instance_cap)
        self.n_coeffs = (max_sh_degree + 1) ** 2
        self.columns = 7 + self.n_coeffs

    def row(self, step: int, views, bg) -> np.ndarray:
        """The table row of the step that makes ``step`` the state's count
        (the reference iteration): ``views`` (main, now, next), ``bg`` [3],
        the position learning rate and the SH mask at ``step``."""
        lr = _lr_tree(self.opt_cfg, step, self.spatial_lr_scale)["xyz"]
        degree = active_sh_degree(step, self.max_sh_degree)
        mask = np.arange(self.n_coeffs) < (degree + 1) ** 2
        return np.concatenate([np.asarray(views, np.float64),
                               np.asarray(bg, np.float64), [lr],
                               mask]).astype(np.float32)

    def __call__(self, state: TrainState, data: SceneData,
                 table: torch.Tensor, cursor: torch.Tensor,
                 slots: StepSlots) -> None:
        r = table.index_select(0, cursor)[0]
        idx = r[:3].to(torch.int64)
        # the GT images stay in their stacks: the loss kernels read frame
        # idx[k] where it lies
        views = step_views(data, self.mode, idx[0:1], idx[1:2], idx[2:3],
                           pick=take, frame=Frame)
        loss, aux, grads = self.grads_fn(state, views, r[3:6], r[7:])
        lrs = dict(self.lrs, xyz=r[6:7])
        # Adam writes the parameters, the contrast and their moments in
        # place: after torch.autograd.grad has returned, nothing of the step
        # reads the old values (step_inputs' leaves share their storage, and
        # the renders' outputs that the stats and metrics read are computed)
        new_state, metrics = _updated(state, self.mode, self.event_cfg, loss,
                                      aux, grads, lrs, views.cam_main,
                                      in_place=True)
        with torch.no_grad():
            # copies only the stats: the rest is already state's own
            for f in ("params", "opt_state", "contrast", "contrast_opt",
                      "stats"):
                copy_tree_(getattr(state, f), getattr(new_state, f))
            slots.history.index_copy_(0, cursor, loss.reshape(1))
            if slots.metrics is None:
                slots.metrics = {k: v.clone() for k, v in metrics.items()}
            else:
                copy_tree_(slots.metrics, metrics)
            cursor.add_(1)


def make_densify_step(opt_cfg: OptimizationConfig, extent: float) -> Callable:
    """The densify-and-prune maintenance step (`train.py:322-324`):
    ``(state, normals [2, C, 3], use_size_prune) → (state, overflow)``."""

    def densify_step(state: TrainState, normals: torch.Tensor,
                     use_size_prune: bool):
        res = densify_and_prune(
            state.params, state.opt_state, state.stats, normals,
            grad_threshold=opt_cfg.densify_grad_threshold,
            min_opacity=0.005,
            extent=extent,
            max_screen_size=20.0 if use_size_prune else 0.0,
            percent_dense=opt_cfg.percent_dense,
        )
        return (state.replace(params=res.params, opt_state=res.opt_state,
                              stats=res.stats), res.overflow)

    return densify_step


def opacity_reset_step(state: TrainState) -> TrainState:
    """`reset_opacity` every opacity_reset_interval (`train.py:326-327`)."""
    params, opt = reset_opacity(state.params, state.opt_state)
    return state.replace(params=params, opt_state=opt)
