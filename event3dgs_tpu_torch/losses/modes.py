"""Per-training-mode total losses (counterpart of
``event3dgs_tpu/losses/modes.py``): vanilla RGB, grayscale, event (with
the learnable contrast) and the event-assisted deblur mix
(`train.py:149-296`).  All take channel-last images.  :func:`deblur_mix`
lives beside the event loss (``losses/event.py``), which folds it into its
kernels in event_deblur mode.

The rgb and gray losses, (1-λ)·L1 + λ·(1-SSIM), run on a card as two
hand-written kernels (``csrc/ssim.cu``) behind one autograd Function,
:class:`PhotometricLoss`: :func:`photometric_loss_forward_kernel` and
:func:`photometric_loss_backward_kernel`, whose plain versions are
:func:`photometric_loss_plain` and :func:`photometric_loss_backward_plain`
(the SSIM map and its derivatives by ``losses/basic.ssim_terms``, blurred
by ``basic.tap_blur`` in the kernels' order).  As the event loss, they take
the render as its image or as its ``Partials`` over a background, and the
GT as its image or as a ``Frame`` of its stack, which the kernels compose
and read themselves.  CPU tensors, or ``plain``, take the plain versions
in the same Function.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from event3dgs_tpu_torch.losses.basic import (
    _GRAY_WEIGHTS,
    _gauss_window_1d,
    SSIM_C1,
    SSIM_C2,
    rgb_to_grayscale,
    ssim_terms,
    tap_blur,
)
from event3dgs_tpu_torch.losses.event import (
    Frame,
    Partials,
    _gt_operand,
    composed_backward_plain,
    deblur_mix,
    event_mixture_loss,
    frame_image,
    render_image,
)
from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.utils.device import constant

__all__ = ["rgb_total_loss", "gray_total_loss", "event_total_loss",
           "deblur_mix"]

# the SSIM window (`loss_utils.py:359-418`)
WINDOW, SIGMA = 11, 1.5
# the kernels' output tile: a block of TILE × TILE threads each
TILE = 16


def _compared(render, gt, gray: bool, background):
    """The images the loss compares: the render's (its partials composed
    over ``background``) and the GT frame (picked), in gray mode their
    luma (a one-channel GT is its own)."""
    x, y = render_image(render, background), frame_image(gt)
    if gray:
        return rgb_to_grayscale(x), rgb_to_grayscale(y)
    return x, y


def _scalars(values: int, lambda_dssim: float, device):
    """(1-λ, λ, 1/N) as float32 device constants, N = ``values`` (H·W·C):
    the kernels' constants, rounded as PyTorch rounds a Python float (1/N
    as 1.0f / float32(N))."""
    f = np.float32
    return tuple(constant(float(v), torch.float32, device) for v in (
        f(1.0 - lambda_dssim), f(lambda_dssim), f(1) / f(values)))


def photometric_loss_plain(render, gt, lambda_dssim: float = 0.2,
                           gray: bool = False, background=None,
                           maps: bool = True):
    """The rgb (or, with ``gray``, gray) mode loss in plain PyTorch:
    (1-λ)·L1 + λ·(1-SSIM) (`train.py:213-223,292-296`) → (loss, l1, the
    SSIM map's derivatives [3, H, W, C] (D_mu, D_xx, D_xy of
    ``basic.ssim_terms``) or None where λ is 0 or ``maps`` is false).  The
    render is its image [H, W, 3] or its :class:`Partials` over
    ``background``, the GT its image [H, W, 3] (gray mode: or [H, W, 1])
    or a :class:`Frame`."""
    x, y = _compared(render, gt, gray, background)
    l1 = torch.mean(torch.abs(x - y))
    loss = (1.0 - lambda_dssim) * l1
    terms = None
    if lambda_dssim > 0.0:
        m, derivatives = ssim_terms(x, y, WINDOW, SIGMA)
        loss = loss + lambda_dssim * (1.0 - torch.mean(m))
        if maps:
            terms = torch.stack(derivatives)
    return loss, l1, terms


def photometric_loss_backward_plain(grad, render, gt, maps,
                                    lambda_dssim: float = 0.2,
                                    gray: bool = False, background=None):
    """The backward kernel's plain version: the gradient of
    :func:`photometric_loss_plain`'s loss times ``grad`` (a 0-d tensor)
    with respect to the render, from the forward's ``maps`` (None where λ
    is 0) → d image [H, W, 3], or a :class:`Partials` of d rgb and d log T
    where the render came as partials (``event.composed_backward_plain``).

    With g_l1 = (grad·(1-λ))·(1/N) and g_ssim = (grad·λ)·(1/N), per value
    dx = g_l1·sgn(x − y) − g_ssim·((B(D_mu) + (2x)·B(D_xx)) + y·B(D_xy)),
    B the SSIM blur (``basic.tap_blur``, its own adjoint); in gray mode dx
    spread over the channels by the luma weights."""
    x, y = _compared(render, gt, gray, background)
    l1_w, lam, inv_n = _scalars(x.numel(), lambda_dssim, x.device)
    g_l1 = (grad * l1_w) * inv_n
    dx = g_l1 * torch.sgn(x - y)
    if lambda_dssim > 0.0:
        t1, t2, t3 = (tap_blur(d, WINDOW, SIGMA) for d in maps.unbind(0))
        g_ssim = (grad * lam) * inv_n
        dx = dx - g_ssim * ((t1 + (2 * x) * t2) + y * t3)
    if gray:
        dx = dx * constant(_GRAY_WEIGHTS, dx.dtype, dx.device)
    if isinstance(render, Partials):
        return composed_backward_plain(dx, render, background)
    return dx


def photometric_constants(pixels: int, gray: bool, lambda_dssim: float):
    """The SSIM kernels' constants, 19 float32 on the host: the window,
    the luma weights, C1, C2, 1-λ, λ and 1/N (N = pixels · C), each
    rounded as PyTorch rounds a Python float."""
    f = np.float32
    channels = 1 if gray else 3
    values = [*_gauss_window_1d(WINDOW, SIGMA),
              *(f(w) for w in _GRAY_WEIGHTS), f(SSIM_C1), f(SSIM_C2),
              f(1.0 - lambda_dssim), f(lambda_dssim),
              f(1) / f(pixels * channels)]
    return (ctypes.c_float * len(values))(*values)


def _photometric_launch(render, gt, lambda_dssim, gray, background) -> tuple:
    """The SSIM kernels' leading arguments after the checks: the host
    arrays of operand pointers and sizes (by address), H, W, gray and the
    constants; then the host arrays themselves, to keep them alive for the
    call."""
    rgb, logt = ((render.rgb, render.logt) if isinstance(render, Partials)
                 else (render, None))
    shape = tuple(rgb.shape)
    if len(shape) != 3 or shape[-1] != 3:
        raise ValueError(f"render: expected [H, W, 3], got {shape}")
    kernels.check(rgb, torch.float32, "render", shape)
    if logt is not None:
        kernels.check(logt, torch.float32, "render log T", shape[:-1])
    if background is not None:
        kernels.check(background, torch.float32, "background", (3,))
    elif logt is not None:
        raise ValueError("a render given as partials needs the background")
    (t, index), sizes = _gt_operand(gt, "gt", shape[:-1])
    if not gray and sizes[0] != 3:
        raise ValueError(f"gt: rgb mode compares three channels, got "
                         f"{sizes[0]}")
    h, w = shape[:2]
    ptrs = [rgb.data_ptr(), None if logt is None else logt.data_ptr(),
            None if background is None else background.data_ptr(),
            t.data_ptr(), None if index is None else index.data_ptr()]
    operands = (ctypes.c_void_p * len(ptrs))(*ptrs)
    sizes = (ctypes.c_longlong * len(sizes))(*sizes)
    consts = photometric_constants(h * w, gray, lambda_dssim)
    return ((ctypes.addressof(operands), ctypes.addressof(sizes), h, w,
             int(gray), consts), (operands, sizes))


def photometric_loss_forward_kernel(render, gt, lambda_dssim: float = 0.2,
                                    gray: bool = False, background=None,
                                    maps: bool = True):
    """Launch the forward kernel (``csrc/ssim.cu``) on CUDA tensors (the
    arguments of :func:`photometric_loss_plain`) → (loss [], l1 [], the
    derivative maps [3, H, W, C] or None), as the plain version gives
    them."""
    args, keep = _photometric_launch(render, gt, lambda_dssim, gray,
                                     background)
    h, w = args[2], args[3]
    dev = (render.rgb if isinstance(render, Partials) else render).device
    rows = -(-h // TILE) * -(-w // TILE)
    partials = torch.empty(rows, 2, dtype=torch.float64, device=dev)
    loss = torch.empty((), device=dev)
    l1 = torch.empty((), device=dev)
    out = (torch.empty(3, h, w, 1 if gray else 3, device=dev)
           if maps and lambda_dssim > 0.0 else None)
    kernels.launch("ssim", "e3d_photometric_loss_forward", *args,
                   partials.data_ptr(), rows, loss.data_ptr(), l1.data_ptr(),
                   None if out is None else out.data_ptr())
    del keep
    photometric_loss_forward_kernel.launches += 1
    return loss, l1, out


photometric_loss_forward_kernel.launches = 0


def photometric_loss_backward_kernel(grad, render, gt, maps,
                                     lambda_dssim: float = 0.2,
                                     gray: bool = False, background=None):
    """Launch the backward kernel (``csrc/ssim.cu``) on CUDA tensors (the
    arguments of :func:`photometric_loss_backward_plain`, ``grad`` 0-d,
    ``maps`` the forward's) → d image, or a :class:`Partials` of d rgb and
    d log T, as the plain version gives them."""
    args, keep = _photometric_launch(render, gt, lambda_dssim, gray,
                                     background)
    kernels.check(grad, torch.float32, "grad", ())
    h, w = args[2], args[3]
    if lambda_dssim > 0.0:
        kernels.check(maps, torch.float32, "maps", (3, h, w, 1 if gray else 3))
    if isinstance(render, Partials):
        out = Partials(torch.empty_like(render.rgb),
                       torch.empty_like(render.logt))
        ptrs = (out.rgb.data_ptr(), out.logt.data_ptr())
    else:
        out = torch.empty_like(render)
        ptrs = (out.data_ptr(), None)
    kernels.launch("ssim", "e3d_photometric_loss_backward", *args,
                   grad.data_ptr(),
                   maps.data_ptr() if lambda_dssim > 0.0 else None, *ptrs)
    del keep
    photometric_loss_backward_kernel.launches += 1
    return out


photometric_loss_backward_kernel.launches = 0


class PhotometricLoss(torch.autograd.Function):
    """The rgb and gray modes' loss, forward and backward one kernel each
    on a card (the plain versions on CPU tensors or with ``plain``).

    ``forward(settings, background, rgb, logt, gt, index)`` with
    ``settings`` (λ, gray, plain), the render's rgb or image and its log T
    or None, the GT image or stack and its index or None → (loss, l1, not
    differentiable); gradients flow to the render's rgb and log T (or its
    image), none to the GT, the index or the background.
    """

    @staticmethod
    def forward(ctx, settings, background, rgb, logt, gt, index):
        lambda_dssim, gray, plain = settings
        render = rgb if logt is None else Partials(rgb, logt)
        frame = gt if index is None else Frame(gt, index)
        forward = (photometric_loss_plain if plain
                   else photometric_loss_forward_kernel)
        loss, l1, maps = forward(render, frame, lambda_dssim, gray,
                                 background, maps=any(ctx.needs_input_grad))
        ctx.mark_non_differentiable(l1)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(background, rgb, logt, gt, index, maps)
        ctx.settings = settings
        return loss, l1

    @staticmethod
    def backward(ctx, g_loss, g_l1):
        if g_loss is None:
            return (None,) * 6
        background, rgb, logt, gt, index, maps = ctx.saved_tensors
        lambda_dssim, gray, plain = ctx.settings
        render = rgb if logt is None else Partials(rgb, logt)
        frame = gt if index is None else Frame(gt, index)
        backward = (photometric_loss_backward_plain if plain
                    else photometric_loss_backward_kernel)
        d = backward(g_loss, render, frame, maps, lambda_dssim, gray,
                     background)
        if isinstance(d, Partials):
            return None, None, d.rgb, d.logt, None, None
        return None, None, d, None, None, None


def photometric_loss(render, gt, lambda_dssim: float = 0.2,
                     gray: bool = False, plain: bool = False,
                     background=None):
    """(1-λ)·L1 + λ·(1-SSIM) of the render against the GT (their luma with
    ``gray``) → (loss, {"l1": l1}).  The render is its image [H, W, 3] or,
    as the train step gives it, its :class:`Partials` over
    ``background``; the GT its image [H, W, 3] (gray mode: or [H, W, 1])
    or, as the graphed step gives it, a :class:`Frame` of its stack.  For
    CUDA tensors the two kernels of :class:`PhotometricLoss`; for CPU
    tensors, or with ``plain``, its plain versions."""
    rgb, logt = ((render.rgb, render.logt) if isinstance(render, Partials)
                 else (render, None))
    stack, index = gt if isinstance(gt, Frame) else (gt, None)
    if not gray and stack.shape[-1] != 3:
        raise ValueError(f"gt: rgb mode compares three channels, got "
                         f"{stack.shape[-1]}")
    settings = (float(lambda_dssim), bool(gray),
                bool(plain or rgb.device.type == "cpu"))
    loss, l1 = PhotometricLoss.apply(
        settings, background, rgb.contiguous(),
        None if logt is None else logt.contiguous(), stack.contiguous(),
        index)
    return loss, {"l1": l1}


def rgb_total_loss(render, gt, lambda_dssim: float = 0.2, plain: bool = False,
                   background=None):
    """Vanilla 3DGS loss: (1-λ)·L1 + λ·(1-SSIM) (`train.py:292-296`), by
    :func:`photometric_loss`."""
    return photometric_loss(render, gt, lambda_dssim, False, plain,
                            background)


def gray_total_loss(render, gt, lambda_dssim: float = 0.2, plain: bool = False,
                    background=None):
    """Gray mode: (1-λ)·L1_gray + λ·(1-SSIM_gray) (`train.py:213-223`), by
    :func:`photometric_loss`."""
    return photometric_loss(render, gt, lambda_dssim, True, plain,
                            background)


def event_total_loss(render_now, render_next, render_main, gt_now, gt_next,
                     gt_main, contrast, gt_contrast: float = 0.17,
                     event_weight: float = 0.9, blurry_main=None,
                     blur_alpha: float = 0.5, plain: bool = False,
                     background=None):
    """Event mode (`train.py:149-196`; λ_dssim is forced to 0 there); with
    ``blurry_main``, event_deblur mode: :func:`deblur_mix` of it with
    ``blur_alpha`` (`train.py:197-203`), in the same two kernels on a card
    (``plain``: the plain version there too).  A render may come as its
    ``Partials`` over ``background``, a GT operand as a ``Frame`` of its
    stack (``losses/event.py``), as the train step passes them."""
    return event_mixture_loss(render_now, render_next, render_main, gt_now,
                              gt_next, gt_main, contrast,
                              gt_contrast=gt_contrast,
                              event_weight=event_weight,
                              blurry_main=blurry_main, blur_alpha=blur_alpha,
                              plain=plain, background=background)
