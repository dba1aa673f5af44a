"""Event-camera losses: the differentiable event simulation and the
reference's experimental variants (counterpart of
``event3dgs_tpu/losses/event.py``).

Two consecutively rendered views are turned into a normalized
log-intensity difference (the event frame a DVS camera with contrast
threshold C would integrate to) and compared against the same quantity
computed from event-derived ground-truth intensity pairs.  The contrast of
the rendered pair is a learnable scalar optimized jointly (reference
`train.py:71-72,165-196`; loss formula `utils/loss_utils.py:234-249`).

:func:`event_mixture_loss`, the training loss of the event modes, runs on a
card as two hand-written kernels (``csrc/loss.cu``) behind one autograd
Function, :class:`EventLoss`: :func:`event_loss_forward_kernel` and
:func:`event_loss_backward_kernel`, whose plain versions are
:func:`event_mixture_loss_plain` and :func:`event_loss_backward_plain`.
The train step hands it each render as its :class:`Partials` (rgb and
log T) and, graphed, each GT image as a :class:`Frame` of its stack: the
kernels compose the renders over the background and pick the frames
themselves.  CPU tensors take the plain forward and autograd's backward.

The variants after :func:`event_loss_backward_plain` are the reference's
experimental event losses, which no training mode calls.  They keep the
JAX package's static shapes where those decide the result: the first
``max_points`` hits in stable order, masked (not dropped) invalid points,
``argmin`` taking the first minimum.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from event3dgs_tpu_torch.losses.basic import (
    _LUV_WEIGHTS,
    l1_loss,
    rgb_to_grayscale,
    rgb_to_luv_l,
)
from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops.render import composed
from event3dgs_tpu_torch.utils.device import constant

LOG_EPS = 1e-8  # epsilon inside the logs (`loss_utils.py:243`)


def effective_contrast(raw, parameterization: str = "identity"):
    """Map the optimized scalar to the contrast used by the loss:
    "identity" is the reference's unconstrained c; "softplus" is the opt-in
    positivity guard c = softplus(raw) + 1e-4."""
    if parameterization == "softplus":
        return F.softplus(raw) + 1e-4
    if parameterization != "identity":
        raise ValueError(f"unknown contrast parameterization "
                         f"{parameterization!r}")
    return raw


def raw_contrast_init(c_init: float, parameterization: str = "identity"):
    """Host-side inverse of :func:`effective_contrast` for state init.

    Under "softplus" the contrast is above its 1e-4 floor, so a ``c_init``
    at or below it has no inverse and raises ``ValueError``.
    """
    if parameterization == "softplus":
        if not c_init > 1e-4:
            raise ValueError(f"softplus contrast init must exceed its 1e-4 "
                             f"floor, got {c_init}")
        return float(np.log(np.expm1(c_init - 1e-4)))
    return c_init


def event_log_diff(image, image_next, contrast) -> torch.Tensor:
    """``(log(L(I₂)+ε) − log(L(I₁)+ε)) / C`` on the LUV L-channel
    (`loss_utils.py:234-249`): [..., H, W, 3] frames → [..., H, W, 1]."""
    l1 = rgb_to_luv_l(image)
    l2 = rgb_to_luv_l(image_next)
    return (torch.log(l2 + LOG_EPS) - torch.log(l1 + LOG_EPS)) / contrast


def deblur_mix(loss, render_main, gt_blurry, blur_alpha: float = 0.5):
    """Deblur mode: ``(1-α)·loss + α·L1(render, blurry)``
    (`train.py:197-203`)."""
    ll1 = l1_loss(render_main, gt_blurry)
    return (1.0 - blur_alpha) * loss + blur_alpha * ll1, {"blur_l1": ll1}


class Partials(NamedTuple):
    """A render before its background: the rasterizer's rgb [H, W, 3] and
    log T [H, W] (``ops/render.rasterize_projected``).  The event loss
    takes a render as its image or as its partials, which it composes over
    its ``background`` (``ops/render.composed``)."""

    rgb: torch.Tensor
    logt: torch.Tensor


class Frame(NamedTuple):
    """Frame ``index`` ([1] int64 on the stack's device) of a stack of GT
    images [V, H, W, C].  The event loss takes a GT operand as its image or
    as such a frame, which the kernels read where it lies: the host never
    reads the index, so a CUDA graph holds the pick."""

    stack: torch.Tensor
    index: torch.Tensor


def render_image(render, background):
    """The image of a render operand: its partials composed over
    ``background`` (``ops/render.composed``), or the image itself."""
    if isinstance(render, Partials):
        return composed(render.rgb, render.logt, background)
    return render


def frame_image(gt):
    """The image of a GT operand: its frame picked on the device
    (``index_select``, as the train step picked it), or the image
    itself."""
    if isinstance(gt, Frame):
        return gt.stack.index_select(0, gt.index)[0]
    return gt


def composed_backward_plain(grad, render: Partials, background) -> Partials:
    """The gradients of ``ops/render.composed``'s image with respect to the
    partials, from the image's gradient ``grad``: autograd's chain written
    out, one PyTorch op for each of its own in its order (the sum passes
    ``grad`` on; the product's backward ``grad·bg``, summed over the
    broadcast channel axis; the exp's backward, times its result)."""
    g_e = (grad * background[None, None, :]).sum(-1, keepdim=True)
    return Partials(grad, g_e.squeeze(-1) * torch.exp(render.logt))


def event_mixture_loss_plain(render_now, render_next, render_main, gt_now,
                             gt_next, gt_main, contrast,
                             gt_contrast: float = 0.17,
                             event_weight: float = 0.9, blurry_main=None,
                             blur_alpha: float = 0.5, background=None):
    """The event-mode training loss (reference `train.py:165-196`) in plain
    PyTorch, differentiated by autograd.

    ``loss1``: L1 between the rendered pair's log-diff (learnable C) and the
    GT pair's log-diff (fixed C); ``loss2``: L1 between the main render and
    its GT.  With coverage = mean(gt_diff ≠ 0):

        loss = w·loss1·coverage + (1-w)·loss2·(1-coverage)

    With ``blurry_main`` (event_deblur mode) the loss is :func:`deblur_mix`'s
    of it.  A render may come as its :class:`Partials`, composed over
    ``background`` first (:func:`render_image`), a GT operand as a
    :class:`Frame`, picked first (:func:`frame_image`).  Returns (loss, aux
    dict with event_l1 / intensity_l1 / coverage [/ blur_l1]).
    """
    render_now, render_next, render_main = (
        render_image(r, background)
        for r in (render_now, render_next, render_main))
    gt_now, gt_next, gt_main = (frame_image(g)
                                for g in (gt_now, gt_next, gt_main))
    img_diff = event_log_diff(render_now, render_next, contrast)
    gt_diff = event_log_diff(gt_now, gt_next, gt_contrast)
    loss1 = l1_loss(img_diff, gt_diff)
    loss2 = l1_loss(render_main, gt_main)
    coverage = torch.mean((gt_diff != 0.0).to(img_diff.dtype))
    loss = event_weight * loss1 * coverage + (1.0 - event_weight) * loss2 * (
        1.0 - coverage)
    aux = {"event_l1": loss1, "intensity_l1": loss2, "coverage": coverage}
    if blurry_main is None:
        return loss, aux
    loss, blur = deblur_mix(loss, render_main, frame_image(blurry_main),
                            blur_alpha)
    return loss, {**aux, **blur}


def event_loss_backward_plain(grad, render_now, render_next, render_main,
                              gt_now, gt_next, gt_main, contrast, coverage,
                              gt_contrast: float = 0.17,
                              event_weight: float = 0.9, blurry_main=None,
                              blur_alpha: float = 0.5, background=None):
    """The backward kernel's plain version: the gradients of
    :func:`event_mixture_loss_plain`'s loss times ``grad`` (a 0-d tensor)
    with respect to the three renders and the contrast (a tensor; the
    forward's ``coverage`` is given) → (d render_now, d render_next,
    d render_main, d contrast), a render's a :class:`Partials` of d rgb
    and d log T where it came as partials (:func:`composed_backward_plain`).

    Autograd's chain written out, one PyTorch op for each of its own in its
    order (a mean's backward divides by the count, an abs's multiplies by
    ``sgn``, 0 at a tie), so the image gradients equal autograd's bit for
    bit on either device; the contrast's is a sum over the pixels.
    """
    renders = (render_now, render_next, render_main)
    render_now, render_next, render_main = (render_image(r, background)
                                            for r in renders)
    gt_now, gt_next, gt_main = (frame_image(g)
                                for g in (gt_now, gt_next, gt_main))
    w = constant(_LUV_WEIGHTS, render_now.dtype, render_now.device)
    base = grad if blurry_main is None else grad * (1.0 - blur_alpha)
    a_now = rgb_to_luv_l(render_now) + LOG_EPS
    a_next = rgb_to_luv_l(render_next) + LOG_EPS
    d = torch.log(a_next) - torch.log(a_now)
    r = d / contrast - event_log_diff(gt_now, gt_next, gt_contrast)
    g_r = base * coverage * event_weight / r.numel() * torch.sgn(r)
    g_d = g_r / contrast
    g_now = -g_d / a_now * w
    g_next = g_d / a_next * w
    g_c = (-g_r * (d / contrast / contrast)).sum().reshape(contrast.shape)
    r_main = render_main - gt_main
    g_main = (base * (1.0 - coverage) * (1.0 - event_weight) / r_main.numel()
              * torch.sgn(r_main))
    if blurry_main is not None:
        r_blur = render_main - frame_image(blurry_main)
        g_main = g_main + (grad * blur_alpha / r_blur.numel()
                           * torch.sgn(r_blur))
    return (*(composed_backward_plain(g, x, background)
              if isinstance(x, Partials) else g
              for g, x in zip((g_now, g_next, g_main), renders)), g_c)


# the loss kernels' outputs beside the loss, in order (blur_l1 is 0 in event
# mode)
AUX = ("event_l1", "intensity_l1", "coverage", "blur_l1")
# rows of the loss kernels' partials scratch: the most blocks of their grid
LOSS_BLOCKS = 2048


def loss_constants(pixels: int, gt_contrast: float, event_weight: float,
                   blur_alpha: float):
    """The loss kernels' constants, 11 float32 on the host: the LUV weights,
    ``LOG_EPS``, 1/gt_contrast, w, 1-w, α, 1-α, 1/P and 1/3P, each rounded
    as PyTorch rounds a Python float, the reciprocals as its CUDA division
    by a host scalar and its mean make them (1.0f / float32(x))."""
    f = np.float32
    values = [*(f(x) for x in _LUV_WEIGHTS), f(LOG_EPS),
              f(1) / f(gt_contrast), f(event_weight), f(1.0 - event_weight),
              f(blur_alpha), f(1.0 - blur_alpha), f(1) / f(pixels),
              f(1) / f(3 * pixels)]
    return (ctypes.c_float * len(values))(*values)


def _gt_operand(gt, what: str, frame_shape) -> tuple:
    """A GT operand's (image or stack, index or None) and its (channels,
    frames, frame stride) after the checks."""
    t, index = (gt.stack, gt.index) if isinstance(gt, Frame) else (gt, None)
    kernels.check(t, torch.float32, what)
    lead = 0 if index is None else 1
    shape = tuple(t.shape[lead:])
    if (len(shape) != len(frame_shape) + 1
            or shape[:-1] != tuple(frame_shape) or shape[-1] not in (1, 3)):
        raise ValueError(f"{what}: expected {'[V] + ' if lead else ''}"
                         f"{tuple(frame_shape)} + (1 or 3,), got "
                         f"{tuple(t.shape)}")
    frames, stride = 1, 0
    if index is not None:
        kernels.check(index, torch.int64, f"{what} index", (1,))
        if index.device != t.device:
            raise ValueError(f"{what} index: on {index.device}, its stack "
                             f"on {t.device}")
        frames, stride = t.shape[0], t.stride(0)
    return (t, index), (shape[-1], frames, stride)


def _loss_launch(renders, gts, contrast, background, settings) -> tuple:
    """The loss kernels' leading arguments after the checks: the host
    arrays of operand pointers and sizes (by address), P, the constants
    and the contrast; then the host arrays themselves, to keep them alive
    for the call."""
    gt_contrast, event_weight, blur_alpha = settings
    rgbs = [r.rgb if isinstance(r, Partials) else r for r in renders]
    shape = rgbs[0].shape
    if len(shape) < 2 or shape[-1] != 3:
        raise ValueError(f"render_now: expected [..., 3], got {tuple(shape)}")
    ptrs = []
    for r, rgb, what in zip(renders, rgbs,
                            ("render_now", "render_next", "render_main")):
        kernels.check(rgb, torch.float32, what, shape)
        logt = None
        if isinstance(r, Partials):
            logt = r.logt
            kernels.check(logt, torch.float32, f"{what} log T", shape[:-1])
        ptrs += [rgb.data_ptr(), None if logt is None else logt.data_ptr()]
    if background is not None:
        kernels.check(background, torch.float32, "background", (3,))
    elif any(isinstance(r, Partials) for r in renders):
        raise ValueError("renders given as partials need the background")
    ptrs.append(None if background is None else background.data_ptr())
    sizes = []
    for g, what in zip(gts, ("gt_now", "gt_next", "gt_main", "blurry_main")):
        if g is None:
            ptrs += [None, None]
            sizes += [1, 1, 0]
            continue
        (t, index), size = _gt_operand(g, what, shape[:-1])
        ptrs += [t.data_ptr(), None if index is None else index.data_ptr()]
        sizes += size
    kernels.check(contrast, torch.float32, "contrast")
    if contrast.numel() != 1:
        raise ValueError(f"contrast: expected one value, got "
                         f"{tuple(contrast.shape)}")
    pixels = rgbs[0].numel() // 3
    if not 0 < pixels < 2**31:
        raise ValueError(f"{pixels} pixels: expected 1 to 2**31 - 1")
    operands = (ctypes.c_void_p * len(ptrs))(*ptrs)
    sizes = (ctypes.c_longlong * len(sizes))(*sizes)
    consts = loss_constants(pixels, gt_contrast, event_weight, blur_alpha)
    return ((ctypes.addressof(operands), ctypes.addressof(sizes), pixels,
             consts, contrast.data_ptr()), (operands, sizes))


def event_loss_forward_kernel(render_now, render_next, render_main, gt_now,
                              gt_next, gt_main, contrast,
                              gt_contrast: float = 0.17,
                              event_weight: float = 0.9, blurry_main=None,
                              blur_alpha: float = 0.5, background=None):
    """Launch the forward kernel (``csrc/loss.cu``) on CUDA tensors (the
    arguments of :func:`event_mixture_loss_plain`: each render [..., 3]
    or its :class:`Partials`, each GT operand [..., 1 or 3] or a
    :class:`Frame`, the contrast one float, the background [3] where a
    render comes as partials) → (the loss [], [4] of ``AUX``)."""
    args, keep = _loss_launch(
        (render_now, render_next, render_main),
        (gt_now, gt_next, gt_main, blurry_main), contrast, background,
        (gt_contrast, event_weight, blur_alpha))
    dev = contrast.device
    partials = torch.empty(LOSS_BLOCKS, 4, dtype=torch.float64, device=dev)
    loss = torch.empty((), device=dev)
    aux = torch.empty(len(AUX), device=dev)
    kernels.launch("loss", "e3d_event_loss_forward", *args,
                   partials.data_ptr(), LOSS_BLOCKS, loss.data_ptr(),
                   aux.data_ptr())
    del keep
    event_loss_forward_kernel.launches += 1
    return loss, aux


event_loss_forward_kernel.launches = 0


def event_loss_backward_kernel(grad, render_now, render_next, render_main,
                               gt_now, gt_next, gt_main, contrast, coverage,
                               gt_contrast: float = 0.17,
                               event_weight: float = 0.9, blurry_main=None,
                               blur_alpha: float = 0.5, background=None):
    """Launch the backward kernel (``csrc/loss.cu``) on CUDA tensors (the
    arguments of :func:`event_loss_backward_plain`; ``grad`` and
    ``coverage`` 0-d) → (d render_now, d render_next, d render_main,
    d contrast), as the plain version gives them."""
    renders = (render_now, render_next, render_main)
    args, keep = _loss_launch(
        renders, (gt_now, gt_next, gt_main, blurry_main), contrast,
        background, (gt_contrast, event_weight, blur_alpha))
    kernels.check(grad, torch.float32, "grad", ())
    kernels.check(coverage, torch.float32, "coverage", ())
    dev = contrast.device
    partials = torch.empty(LOSS_BLOCKS, dtype=torch.float64, device=dev)
    out = [Partials(torch.empty_like(r.rgb), torch.empty_like(r.logt))
           if isinstance(r, Partials) else torch.empty_like(r)
           for r in renders]
    g_c = torch.empty_like(contrast)
    ptrs = [p for g in out for p in (
        (g.rgb.data_ptr(), g.logt.data_ptr()) if isinstance(g, Partials)
        else (g.data_ptr(), None))]
    grads = (ctypes.c_void_p * len(ptrs))(*ptrs)
    kernels.launch("loss", "e3d_event_loss_backward", *args,
                   grad.data_ptr(), coverage.data_ptr(), partials.data_ptr(),
                   LOSS_BLOCKS, ctypes.addressof(grads), g_c.data_ptr())
    del keep
    event_loss_backward_kernel.launches += 1
    return (*out, g_c)


event_loss_backward_kernel.launches = 0


def _flat_operands(renders, gts) -> list:
    """The loss's operands as :class:`EventLoss` takes them: per render its
    rgb or image and its log T or None, per GT operand its image or stack
    (None: no blurry image) and its index or None."""
    out = []
    for r in renders:
        out += list(r) if isinstance(r, Partials) else [r, None]
    for g in gts:
        out += list(g) if isinstance(g, Frame) else [g, None]
    return out


def _operands(flat) -> tuple:
    """:func:`_flat_operands`' inverse: (renders, GT operands)."""
    renders = [x if lt is None else Partials(x, lt)
               for x, lt in zip(flat[0:6:2], flat[1:6:2])]
    gts = [x if i is None else Frame(x, i)
           for x, i in zip(flat[6::2], flat[7::2])]
    return renders, gts


class EventLoss(torch.autograd.Function):
    """The event-mode loss on a card, forward and backward one kernel each.

    ``forward(contrast, background, settings, *operands)`` with
    ``settings`` (gt_contrast, event_weight, blur_alpha) and the operands
    of :func:`_flat_operands` → (loss, [4] of ``AUX``, not
    differentiable); gradients flow to each render's rgb and log T (or its
    image) and to the contrast, none to the GT images, stacks or indices
    or to the background.
    """

    @staticmethod
    def forward(ctx, contrast, background, settings, *flat):
        gt_contrast, event_weight, blur_alpha = settings
        renders, gts = _operands(flat)
        loss, aux = event_loss_forward_kernel(
            *renders, *gts[:3], contrast, gt_contrast, event_weight, gts[3],
            blur_alpha, background)
        ctx.mark_non_differentiable(aux)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(contrast, background, aux, *flat)
        ctx.settings = settings
        return loss, aux

    @staticmethod
    def backward(ctx, g_loss, g_aux):
        n = len(ctx.saved_tensors) - 3
        if g_loss is None:
            return (None,) * (3 + n)
        contrast, background, aux, *flat = ctx.saved_tensors
        gt_contrast, event_weight, blur_alpha = ctx.settings
        renders, gts = _operands(flat)
        *g_renders, g_c = event_loss_backward_kernel(
            g_loss, *renders, *gts[:3], contrast, aux[2], gt_contrast,
            event_weight, gts[3], blur_alpha, background)
        g_flat = _flat_operands(g_renders, [None] * 4)
        return (g_c, None, None, *g_flat[:6], *([None] * (n - 6)))


def event_mixture_loss(render_now, render_next, render_main, gt_now, gt_next,
                       gt_main, contrast, gt_contrast: float = 0.17,
                       event_weight: float = 0.9, blurry_main=None,
                       blur_alpha: float = 0.5, plain: bool = False,
                       background=None):
    """The event-mode training loss (reference `train.py:165-196`; in
    event_deblur mode, with ``blurry_main``, :func:`deblur_mix`'s of it,
    `train.py:197-203`) → (loss, aux dict with event_l1 / intensity_l1 /
    coverage [/ blur_l1]).

    Each render is its image or, as the train step gives it, its
    :class:`Partials` over ``background``; each GT operand its image or,
    as the graphed step gives it, a :class:`Frame` of its stack.  The
    sharded step and the probes pass images, which they have composed or
    picked themselves.

    For CUDA tensors the two kernels of :class:`EventLoss`, which compose
    the partials and read the frames themselves; for CPU tensors, or with
    ``plain``, :func:`event_mixture_loss_plain` under autograd.
    """
    renders = (render_now, render_next, render_main)
    gts = (gt_now, gt_next, gt_main, blurry_main)
    first = render_now.rgb if isinstance(render_now, Partials) else render_now
    if first.device.type == "cpu" or plain:
        return event_mixture_loss_plain(*renders, *gts[:3], contrast,
                                        gt_contrast, event_weight, gts[3],
                                        blur_alpha, background)
    flat = [None if t is None else t.contiguous()
            for t in _flat_operands(renders, gts)]
    loss, aux = EventLoss.apply(contrast, background,
                                (float(gt_contrast), float(event_weight),
                                 float(blur_alpha)), *flat)
    names = AUX if blurry_main is not None else AUX[:3]
    return loss, {k: aux[i] for i, k in enumerate(names)}


def thresholded_event_l1(network_output, gt, thresh: float = 0.5):
    """Band-tolerant event-count L1 (reference `l1_loss_gray_event`,
    `loss_utils.py:49-63`): differences within ±thresh of the GT count are
    free; the negative side is reweighted by the positive/negative count
    ratio."""
    out = rgb_to_grayscale(network_output)
    g = rgb_to_grayscale(gt)
    abs1 = torch.abs(out - g - thresh)
    abs2 = torch.abs(g - out - thresh)
    ratio = (g > 0).sum().to(out.dtype) / torch.clamp(
        (g < 0).sum().to(out.dtype), min=1.0)
    loss = torch.where(g > 0, torch.clamp(abs1 - thresh, min=0.0),
                       torch.clamp(abs2 - thresh, min=0.0) * ratio)
    return torch.mean(loss)


def dice_loss(network_output, gt, smooth: float = 1e-8):
    """Dice overlap loss on grayscale frames (reference `Dice_Loss`,
    `loss_utils.py:64-78`)."""
    out = rgb_to_grayscale(network_output)
    g = rgb_to_grayscale(gt)
    dice = (2.0 * (out * g) + smooth) / (out + g + smooth)
    return torch.mean(1.0 - dice)


def cross_entropy_event_loss(img_diff, gt_image):
    """Cross-entropy between max-normalized event frames (reference
    `cross_entropy_loss`, `loss_utils.py:101-126`): both frames grayscaled,
    |·|-normalized by their max and flattened into a [2, HW] logit matrix
    scored against the targets (0, 1), then divided by 10."""
    d = rgb_to_grayscale(img_diff)
    g = rgb_to_grayscale(gt_image)
    d = torch.abs(d) / torch.clamp(torch.max(torch.abs(d)), min=LOG_EPS)
    g = torch.abs(g) / torch.clamp(torch.max(torch.abs(g)), min=LOG_EPS)
    rows = torch.stack([d.reshape(-1), g.reshape(-1)])
    nll = torch.logsumexp(rows, dim=1) - torch.stack([rows[0, 0], rows[1, 1]])
    return torch.mean(nll) / 10.0


def quadratic_tolerance_loss(network_output, gt, tolerance: float = 0.2):
    """Dead-band quadratic event loss (reference `l1_loss_event_new`,
    `loss_utils.py:272-283`): differences within ±tolerance are free, the
    excess is scaled by 1000 and squared."""
    abs_diff = torch.abs(network_output - gt)
    pixel = torch.where(abs_diff < tolerance, torch.zeros_like(abs_diff),
                        ((abs_diff - tolerance) * 1000.0) ** 2)
    return torch.mean(pixel)


def _first_hits(mask, k: int):
    """The indices of the first ``k`` entries of ``mask`` (last axis) that
    are set, in stable order, then the unset ones: (indices, set)."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :k]
    return order, torch.gather(mask, -1, order)


def _masked_nn_mean_dist(src_xy, src_valid, dst_xy, dst_valid):
    """Mean 2D distance from each valid src point to its nearest valid dst;
    invalid rows are pushed to +inf instead of being dropped."""
    d2 = torch.sum((src_xy[:, None, :] - dst_xy[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(dst_valid[None, :], d2, torch.full_like(d2, float("inf")))
    dist = torch.sqrt(torch.clamp(torch.min(d2, dim=1).values, min=0.0))
    denom = torch.clamp(src_valid.sum().to(dist.dtype), min=1.0)
    return torch.sum(torch.where(src_valid, dist, torch.zeros_like(dist))) / denom


def pointcloud_nn_loss(network_output, gt, threshold: float = 0.9,
                       max_points: int = 9000):
    """Nearest-neighbour point-cloud event loss (reference `l1_loss_event`,
    `loss_utils.py:284-355`): pixels above +threshold / below -threshold
    form point sets matched to the same-polarity GT sets; the loss is the
    mean distance from each rendered event point to its nearest GT one
    (each set its first ``max_points`` hits, where the reference draws a
    randperm).  Plain L1 when any set is empty, as the reference."""
    out = network_output.reshape(-1)
    g = gt.reshape(-1)
    h, w = gt.shape[-3], gt.shape[-2]
    if gt.ndim == 2:
        h, w = gt.shape
    idx = torch.arange(g.shape[0], device=g.device)
    xy = torch.stack([(idx // w).to(torch.float32),
                      (idx % w).to(torch.float32)], dim=1)

    def select(mask):
        order, valid = _first_hits(mask, max_points)
        return xy[order], valid

    d_pos = _masked_nn_mean_dist(*select(out > threshold),
                                 *select(g > threshold))
    d_neg = _masked_nn_mean_dist(*select(out < -threshold),
                                 *select(g < -threshold))
    have_all = ((out > threshold).any() & (g > threshold).any()
                & (out < -threshold).any() & (g < -threshold).any())
    return torch.where(have_all, d_pos + d_neg, l1_loss(network_output, gt))


def chamfer_event_loss(img_diff, gt_image, grid: int = 5,
                       threshold: float = 0.85, band: float = 2.0,
                       max_points: int = 1024):
    """Sub-sampled chamfer event loss (reference `chamfer_loss` +
    `chamfer_loss_bas`, `loss_utils.py:127-230`).

    The image is decimated into ``grid``² strided sub-images; per sub-image,
    pixels with |value| > threshold become (row, col, value) points split by
    sign, each GT point is matched to the nearest rendered point of the same
    polarity (3D distance over coordinates and value), and the mean of
    relu(|gt − match − band| − band) is accumulated.
    """
    d = rgb_to_grayscale(img_diff)[..., 0]
    g = rgb_to_grayscale(gt_image)[..., 0]
    hh = (d.shape[0] // grid) * grid
    ww = (d.shape[1] // grid) * grid
    sub_h, sub_w = hh // grid, ww // grid

    def subs(x):  # [grid², sub_h · sub_w]: one strided sub-image per phase
        x = x[:hh, :ww].reshape(sub_h, grid, sub_w, grid)
        return x.permute(1, 3, 0, 2).reshape(grid * grid, sub_h * sub_w)

    dv, gv = subs(d), subs(g)
    idx = torch.arange(sub_h * sub_w, device=d.device)
    coords = torch.stack([(idx // sub_w).to(torch.float32),
                          (idx % sub_w).to(torch.float32)], dim=1)
    k = min(max_points, sub_h * sub_w)

    def points(v, mask):
        order, valid = _first_hits(mask, k)
        return torch.cat([coords[order], torch.gather(v, 1, order)[..., None]],
                         dim=-1), valid

    def side(sign):
        dp, dvalid = points(dv, sign * dv > threshold)
        gp, gvalid = points(gv, sign * gv > threshold)
        dist2 = torch.sum((dp[:, :, None, :] - gp[:, None, :, :]) ** 2, dim=-1)
        dist2 = torch.where(dvalid[:, :, None], dist2,
                            torch.full_like(dist2, float("inf")))
        nearest = torch.argmin(dist2, dim=1)  # per GT point, the first minimum
        matched = torch.gather(dp, 1, nearest[..., None].expand(-1, -1, 3))
        resid = (torch.abs(gp - matched - band) if sign > 0
                 else torch.abs(matched - gp - band))
        pen = torch.clamp(resid - band, min=0.0)
        ok = gvalid & (dvalid.sum(dim=1, keepdim=True) > 0)
        denom = torch.clamp(ok.sum(dim=1) * 3, min=1)
        return torch.where(ok[..., None], pen,
                           torch.zeros_like(pen)).sum(dim=(1, 2)) / denom

    return torch.mean(0.5 * (side(1.0) + side(-1.0)))


def filtered_event_l1(network_output, gt):
    """Neighborhood-tolerant event L1 (after `l1_filter_loss_gray_event`,
    `loss_utils.py:79-100`): the absolute grayscale difference box-filtered
    over a 1×2 window (÷2), then averaged; padded by the one column the
    window needs (the JAX package's cleaned-up border, not the
    reference's)."""
    if network_output.shape[-1] == 3:
        network_output = rgb_to_grayscale(network_output)
    if gt.shape[-1] == 3:
        gt = rgb_to_grayscale(gt)
    abs_diff = torch.abs(network_output - gt)[..., 0]
    padded = F.pad(abs_diff, (0, 1))
    return torch.mean((padded[:, :-1] + padded[:, 1:]) / 2.0)


def soft_threshold(x, contrast: float = 0.3, width: float = 10.0):
    """Differentiable event-threshold gate (reference
    `differentialable_threld`, `loss_utils.py:231-232`):
    ``sign(x)·sigmoid(w·(|x| − C))``."""
    return torch.sign(x) / (1.0 + torch.exp(width * (contrast - torch.abs(x))))


def normalize_image(image):
    """Min-max normalize to [0, 1] (reference `normalize_image`,
    `loss_utils.py:34-39`)."""
    lo, hi = torch.min(image), torch.max(image)
    return (image - lo) / torch.clamp(hi - lo, min=1e-12)
