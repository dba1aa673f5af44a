"""The plain reference of the port's train step: renders (``splats``), the
mode's loss (``losses``), the gradients by autograd, Adam and the densify
statistics, in plain PyTorch.

Frozen from what ``event3dgs_tpu_torch/train/step.py``,
``models/optimizer.py``, ``models/densify.py`` and ``core/schedules.py``
document at commit 3dea7a3, which follow the reference's ``train.py``:

- the six leaves (means, DC and higher SH features, log-scales,
  quaternions, logit opacities) and, in event mode, the contrast c;
- Adam with β 0.9 / 0.999 and eps 1e-15, one count, learning rates
  0.0025 (DC), 0.0025 / 20 (higher SH), 0.05 (opacity), 0.005 (scales),
  0.001 (rotation), 0.1 (contrast) and for the means the exponential decay
  from 1.6e-4 to 1.6e-6 of the spatial scale over 30,000 steps (delay
  multiplier 0.01 with no delay steps, so it does not act);
- the densify statistics of the main view: the norm of its screen-space
  mean gradient scaled by (W/2, H/2) added where visible, the visits, and
  the largest radius.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import splats
from benchmark.reference.losses import event_loss, rgb_loss

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-15
LR = {"features_dc": 0.0025, "features_rest": 0.0025 / 20.0,
      "opacity": 0.05, "scaling": 0.005, "rotation": 0.001}
CONTRAST_LR = 0.1
POSITION_LR = (0.00016, 0.0000016, 30_000)  # init, final, max steps


def position_lr(step: int, spatial_scale: float) -> float:
    """The means' learning rate at ``step`` (log-linear decay, float32)."""
    f32 = np.float32
    init, final, max_steps = POSITION_LR
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    return float(f32(np.exp(np.log(f32(init * spatial_scale)) * (f32(1) - t)
                            + np.log(f32(final * spatial_scale)) * t)))


@dataclasses.dataclass
class State:
    """Parameters, Adam moments and count, contrast, densify statistics."""

    params: dict
    mu: dict
    nu: dict
    count: int
    stats: dict  # grad_accum, denom, max_radii2d
    contrast: torch.Tensor | None = None
    c_mu: torch.Tensor | None = None
    c_nu: torch.Tensor | None = None


def loss_and_grads(state: State, mode: str, scene, idx: int, background,
                   dtype=torch.float32, half: bool = False):
    """(loss, {leaf: gradient}, contrast gradient, tap gradient [N, 2],
    main view's radius, visibility, aux) of the step at view ``idx``."""
    leaves = {k: state.params[k].detach().to(dtype).requires_grad_(True)
              for k in LEAVES}
    contrast = (state.contrast.detach().to(dtype).requires_grad_(True)
                if mode == "event" else None)
    means = leaves["xyz"]
    feats = torch.cat([leaves["features_dc"], leaves["features_rest"]], dim=1)
    opac = torch.sigmoid(leaves["opacity"][:, 0])
    scales = torch.exp(leaves["scaling"])
    rots = leaves["rotation"]
    bg = background.to(dtype)
    if mode == "event":
        cams = [(scene["cameras"], idx), (scene["event_cameras"], idx),
                (scene["event_cameras"], idx + 1)]
    else:
        cams = [(scene["cameras"], idx)]
    feat_views, lists, images, main = [], [], [], None
    for v, i in cams:
        cam = splats.camera(v, i, dtype)
        p = splats.project(means, scales, rots, opac, cam)
        f = splats.features(p, splats.sh_colors(feats, means, cam.center), opac)
        tl = splats.tile_lists(p, opac, cam.width, cam.height)
        rgb, logt = splats.composite(f.detach(), tl, cam.width, cam.height)
        feat_views.append(f)
        lists.append(tl)
        images.append((rgb.requires_grad_(True), logt.requires_grad_(True)))
        main = p if main is None else main
    composed = [r + torch.exp(lt)[..., None] * bg for r, lt in images]
    gt = lambda stack, i: stack[i].to(dtype)
    if mode == "event":
        loss, aux = event_loss(
            composed[1], composed[2], composed[0],
            gt(scene["event_images"], idx), gt(scene["event_images"], idx + 1),
            gt(scene["images"], idx), contrast, half=half)
        wrt = [x for pair in images for x in pair] + [contrast]
    else:
        loss, aux = rgb_loss(composed[0], gt(scene["images"], idx), half=half)
        wrt = [x for pair in images for x in pair]
    g = torch.autograd.grad(loss, wrt, allow_unused=True)
    g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(wrt, g)]
    g_feat = [splats.composite_backward(f, tl, g[2 * k], g[2 * k + 1])
              for k, (f, tl) in enumerate(zip(feat_views, lists))]
    torch.autograd.backward(feat_views, g_feat)
    grads = {k: leaves[k].grad for k in LEAVES}
    g_contrast = g[-1] if mode == "event" else None
    return (loss.detach(), grads, g_contrast, g_feat[0][:, :2],
            main.radius, main.valid, aux)


def adam(p, g, m, v, lr, t: int):
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * g * g
    c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    return p - lr * (m / c1) / (torch.sqrt(v / c2) + EPS), m, v


@torch.no_grad()
def step(state: State, mode: str, scene, idx: int, background,
         iteration: int, spatial_scale: float, dtype=torch.float32,
         half: bool = False):
    """One train step → (new state, loss, gradients {leaf and "contrast"},
    aux)."""
    with torch.enable_grad():
        loss, grads, g_c, tap, radius, valid, aux = loss_and_grads(
            state, mode, scene, idx, background, dtype, half)
    t = state.count + 1
    lrs = dict(LR, xyz=position_lr(iteration, spatial_scale))
    params, mu, nu = {}, {}, {}
    for k in LEAVES:
        params[k], mu[k], nu[k] = adam(state.params[k].to(dtype), grads[k],
                                       state.mu[k].to(dtype),
                                       state.nu[k].to(dtype), lrs[k], t)
    contrast, c_mu, c_nu = state.contrast, state.c_mu, state.c_nu
    if mode == "event":
        contrast, c_mu, c_nu = adam(contrast.to(dtype), g_c, c_mu.to(dtype),
                                    c_nu.to(dtype), CONTRAST_LR, t)
    cam = scene["cameras"]
    scale = tap.new_tensor([0.5 * cam.width, 0.5 * cam.height])
    vis = valid.to(tap.dtype)
    s = state.stats
    stats = {"grad_accum": s["grad_accum"].to(dtype)
             + torch.linalg.norm(tap * scale, dim=-1) * vis,
             "denom": s["denom"].to(dtype) + vis,
             "max_radii2d": torch.maximum(s["max_radii2d"].to(dtype),
                                          radius.to(dtype) * vis)}
    grads = dict(grads, contrast=g_c) if mode == "event" else grads
    return State(params, mu, nu, t, stats, contrast, c_mu, c_nu), loss, grads, aux
