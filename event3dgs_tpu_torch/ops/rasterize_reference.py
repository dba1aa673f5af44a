"""Reference (slow) rasterizer: depth-sorted alpha compositing, forward only.

Counterpart of ``event3dgs_tpu/ops/rasterize_reference.py``, the oracle
the tiled kernels are held to.  No tiling, no binning: Gaussians are sorted
by depth and composited front to back over all pixels, ``chunk`` Gaussians
at a time.  Numerics follow the upstream 3DGS conventions:

- ``α = min(0.99, opacity · exp(power))`` with
  ``power = -½(a·dx² + c·dy²) - b·dx·dy``;
- contributions with ``power > 0`` or ``α < 1/255`` are skipped;
- compositing stops per pixel once transmittance would drop below 1e-4
  (the triggering Gaussian is not composited);
- a Gaussian only touches pixels whose tile lies in its 3σ tile rect.

Each chunk is recomputed in the backward pass instead of keeping its
[H·W, chunk] intermediates (:class:`RematChunk`, the JAX package's
per-chunk remat): without it a render of millions of Gaussians keeps
hundreds of GB for the backward.
The chunk's products (``cumprod`` and ``prod`` over 1 - α, never 0 since
α ≤ 0.99) take their gradients from the formula PyTorch's own backward
takes when no input is zero; PyTorch's asks the host whether one is (an
``.item()``), which a CUDA graph's capture cannot hold
(``train/fused.py``).
"""

from __future__ import annotations

import torch

from event3dgs_tpu_torch.ops.binning import TILE_H, TILE_W
from event3dgs_tpu_torch.ops.projection import ProjectedGaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def rasterize_reference(proj: ProjectedGaussians, colors, opacities,
                        background, width: int, height: int,
                        chunk: int = 256) -> torch.Tensor:
    """[height, width, 3] image composited over ``background``."""
    rgb, t = _composite_all(proj, colors, opacities, width, height, chunk)
    rgb = rgb + t[:, None] * background[None, :]
    return rgb.reshape(height, width, 3)


def rasterize_reference_partials(proj: ProjectedGaussians, colors, opacities,
                                 width: int, height: int, chunk: int = 256):
    """Pre-background partials: ([H, W, 3] rgb, [H, W] log T)."""
    rgb, t = _composite_all(proj, colors, opacities, width, height, chunk)
    logt = torch.log(torch.clamp(t, min=1e-30))
    return rgb.reshape(height, width, 3), logt.reshape(height, width)


class NonzeroCumprod(torch.autograd.Function):
    """``torch.cumprod(x, dim=1)`` of an ``x`` with no zero, whose backward
    reads nothing on the host: ``reversed_cumsum(out · grad) / x``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(1).cumsum(1).flip(1).div(x)


class NonzeroProd(torch.autograd.Function):
    """``torch.prod(x, dim=1)`` of an ``x`` with no zero, whose backward
    reads nothing on the host: ``grad · (out / x)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.prod(x, dim=1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad[:, None] * (out[:, None] / x)


def _composite_chunk(rgb, T, m2d, con, rad, c_opa, c_rgb, pxf, pyf, ptx,
                     pty):
    """One chunk of Gaussians composited over every pixel: the new
    (rgb [P, 3], T [P])."""
    mx, my = m2d[None, :, 0], m2d[None, :, 1]
    dx = mx - pxf[:, None]  # [P, K]
    dy = my - pyf[:, None]
    in_rect = (
        (ptx >= torch.floor((mx - rad) / TILE_W))
        & (ptx < torch.floor((mx + rad + TILE_W - 1) / TILE_W))
        & (pty >= torch.floor((my - rad) / TILE_H))
        & (pty < torch.floor((my + rad + TILE_H - 1) / TILE_H))
    )
    power = (-0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy)
             - con[None, :, 1] * dx * dy)
    alpha = torch.clamp(c_opa[None, :] * torch.exp(power), max=ALPHA_MAX)
    zero = torch.zeros_like(alpha)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN) | ~in_rect,
                        zero, alpha)
    # the Gaussian that would push T below T_EPS, and all behind it, are
    # dropped (a mask: no gradient flows through it)
    with torch.no_grad():
        T_incl = T[:, None] * torch.cumprod(1.0 - alpha, dim=1)
        stopped = torch.cumsum((T_incl < T_EPS).to(alpha.dtype), dim=1) > 0
    alpha = torch.where(stopped, zero, alpha)
    one_minus = 1.0 - alpha
    T_excl = torch.cat(
        [torch.ones_like(T)[:, None], NonzeroCumprod.apply(one_minus[:, :-1])],
        dim=1,
    )
    w = alpha * T[:, None] * T_excl
    return rgb + w @ c_rgb, T * NonzeroProd.apply(one_minus)


class RematChunk(torch.autograd.Function):
    """:func:`_composite_chunk` that keeps only its inputs for the backward
    pass and computes the chunk again there (JAX's ``remat``): a chunk's
    [H·W, chunk] intermediates live for one chunk at a time."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _composite_chunk(*inputs)

    @staticmethod
    def backward(ctx, g_rgb, g_t):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            out = _composite_chunk(*xs)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, (g_rgb, g_t),
                                             allow_unused=True))
        return tuple(next(grads) if n else None for n in need)


def _composite_all(proj, colors, opacities, width, height, chunk):
    """Depth-sort + composite: ([P, 3] rgb, [P] transmittance), P = H·W."""
    n = proj.mean2d.shape[0]
    dev = proj.mean2d.device
    order = torch.argsort(proj.depth, stable=True)  # +inf (culled) last
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    col = colors[order]
    opa = opacities[order] * proj.valid[order]
    radius = proj.radius[order]

    npix = height * width
    pxf = torch.arange(width, dtype=torch.float32, device=dev).repeat(height)
    pyf = torch.arange(height, dtype=torch.float32, device=dev).repeat_interleave(width)
    ptx = torch.floor(pxf / TILE_W)[:, None]
    pty = torch.floor(pyf / TILE_H)[:, None]

    rgb = torch.zeros(npix, 3, device=dev)
    T = torch.ones(npix, device=dev)
    pixels = (pxf, pyf, ptx, pty)
    for c0 in range(0, n, chunk):
        part = (mean2d[c0:c0 + chunk], conic[c0:c0 + chunk],
                radius[c0:c0 + chunk], opa[c0:c0 + chunk],
                col[c0:c0 + chunk])
        rgb, T = RematChunk.apply(rgb, T, *part, *pixels)
    return rgb, T
