"""The train step: render → mode loss → grads → Adam → stats.

Counterpart of ``event3dgs_tpu/train/step.py``.  :func:`make_train_step`
closes over the configuration (mode, optimizer hyperparameters, rasterizer,
instance budget) and returns

    (state, scene_data, idx_main, idx_now, idx_next, bg) → (state, metrics)

covering the reference's per-iteration work (`train.py:95-332`) minus
densification (:func:`make_densify_step`, every `densification_interval`
iterations) and the opacity reset (:func:`opacity_reset_step`).  A step
returns a new state and leaves its input state untouched.

Gradients come from one backward pass with respect to the six trainable
leaves, the contrast ``c`` and a zero [C, 2] tap added to the main view's
projected means; the tap's gradient is what the reference reads from
``screenspace_points.grad`` for densification (`train.py:319-320`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from event3dgs_tpu_torch.core.schedules import exponential_lr
from event3dgs_tpu_torch.losses.event import effective_contrast
from event3dgs_tpu_torch.losses.modes import (
    deblur_mix,
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
from event3dgs_tpu_torch.models.optimizer import adam_update
from event3dgs_tpu_torch.ops.render import render
from event3dgs_tpu_torch.train.state import (
    SceneData,
    TrainState,
    active_sh_degree,
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
    act: object  # the activated Gaussians of ``leaves``
    features: torch.Tensor  # their SH features, masked to the active degree


def step_inputs(state: TrainState, max_sh_degree: int = 3) -> StepInputs:
    """The differentiable inputs of ``state``'s next step: fresh leaves of
    its trainable tensors and contrast, the zero tap, and the activated
    Gaussians with their SH features masked to the step's degree."""
    params = state.params
    dev = params.device
    step = int(state.step) + 1  # reference iterations start at 1
    cmask = sh_coeff_mask(active_sh_degree(step, max_sh_degree),
                          (max_sh_degree + 1) ** 2, device=dev)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in trainable_dict(params).items()}
    contrast = state.contrast.detach().requires_grad_(True)
    tap = torch.zeros(params.capacity, 2, device=dev, requires_grad=True)
    act = activated(with_trainable(params, leaves))
    return StepInputs(leaves, contrast, tap, act,
                      act.features * cmask[None, :, None])


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

    ``plain`` runs the plain versions of the tiled rasterizer's kernels on
    CUDA tensors (for holding the kernel path against them).
    """

    def loss_and_grads(state: TrainState, data: SceneData, idx_main: int,
                       idx_now: int, idx_next: int, bg: torch.Tensor):
        leaves, contrast, tap, act, features = step_inputs(state,
                                                           max_sh_degree)

        def render_view(cam, tap=None):
            return render(act.means3d, features, act.opacities, act.scales,
                          act.rotations, cam, bg, sh_degree=max_sh_degree,
                          mean2d_tap=tap, rasterizer=rasterizer,
                          instance_cap=instance_cap, plain=plain)

        cam_main = data.cameras[idx_main]
        gt_main = data.images[idx_main]
        out_main = render_view(cam_main, tap)
        if mode == "rgb":
            loss, aux = rgb_total_loss(out_main.image, gt_main, lambda_dssim)
        elif mode == "gray":
            loss, aux = gray_total_loss(out_main.image, gt_main, lambda_dssim)
        else:  # event / event_deblur
            out_now = render_view(data.event_cameras[idx_now])
            out_next = render_view(data.event_cameras[idx_next])
            loss, aux = event_total_loss(
                out_now.image, out_next.image, out_main.image,
                data.event_images[idx_now], data.event_images[idx_next],
                gt_main,
                effective_contrast(contrast,
                                   event_cfg.contrast_parameterization),
                gt_contrast=event_cfg.gt_contrast,
                event_weight=event_cfg.event_weight,
            )
            if mode == "event_deblur":
                loss, blur_aux = deblur_mix(loss, out_main.image,
                                            data.blurry_images[idx_main],
                                            event_cfg.blur_alpha)
                aux.update(blur_aux)
        aux["radii"] = out_main.radii
        aux["visibility"] = out_main.visibility

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
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    lambda_dssim = (event_cfg.event_lambda_dssim if mode.startswith("event")
                    else opt_cfg.lambda_dssim)
    grads_fn = make_loss_and_grads(mode, event_cfg, lambda_dssim,
                                   max_sh_degree, rasterizer, instance_cap)

    def train_step(state: TrainState, data: SceneData, idx_main: int,
                   idx_now: int, idx_next: int, bg: torch.Tensor):
        loss, aux, grads = grads_fn(state, data, idx_main, idx_now, idx_next,
                                    bg)
        step = int(state.step) + 1
        lrs = _lr_tree(opt_cfg, step, spatial_lr_scale)
        new_tree, new_opt = adam_update(trainable_dict(state.params),
                                        grads["params"], state.opt_state, lrs)
        if mode.startswith("event"):  # learnable contrast (`train.py:210-212`)
            new_contrast, new_copt = adam_update(
                state.contrast, grads["contrast"], state.contrast_opt,
                event_cfg.contrast_lr)
        else:
            new_contrast, new_copt = state.contrast, state.contrast_opt
        cam_main = data.cameras[idx_main]
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
            step=state.step + 1,
        )
        return new_state, metrics

    return train_step


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
