"""Tiled rasterizer: binning + kernels K1 (forward) and K2/K3 (backward).

Counterpart of ``event3dgs_tpu/ops/rasterize_tiled.py``.  Numerics match
the oracle (``rasterize_reference``): α = min(0.99, o·exp(p)),
contributions with power > 0 or α < 1/255 are skipped, and a Gaussian's
support is its tile rect.  Transmittance is carried as log T.  Early stop
is per pixel at log T < ln(1e-6) (``LOG_T_SKIP``); the JAX kernel stops per
chunk instead, so ``logt`` saturates earlier here, while what either drops
from the image weighs < 1e-6.

- K1 is ``csrc/rasterize_fwd.cu``: one block per 32×32 tile reading the
  tile's depth-ordered range of ``inst_gauss`` and gathering each
  Gaussian's packed features (:func:`pack_features`'s rows, which the
  preprocess forward writes for the views it colours).  Besides the rgb and
  log T partials it writes each pixel's stop index (one past the last
  instance it evaluated).
- K2 is ``csrc/rasterize_bwd.cu``: the same tiles walked back to front from
  each pixel's stop index, rebuilding log T by subtraction; it writes nine
  gradient floats per instance slot (mean2d x/y, conic a/b/c, opacity,
  r/g/b), summed over the tile's pixels in a fixed order.
- In both, each warp owns a 16×8 sub-block of the tile and skips the
  instances whose α ≥ 1/255 region cannot reach it (:func:`warp_cull_mask`,
  ``csrc/composite.cuh``); a culled instance is one every pixel of the
  sub-block would skip, so the cull changes no result.
- K3 (``ops/segscan.py``) sums each Gaussian's slot rows.

:class:`TiledRasterize` is the ``torch.autograd.Function`` tying them
together, the counterpart of ``_build_rasterizer``'s custom VJP: gradients
flow to ``mean2d``, ``conic``, ``colors`` and ``opacities``; ``depth``,
``radius`` and ``valid`` get none.  Each kernel's wrapper launches it for
CUDA tensors; CPU tensors take its plain PyTorch version.
"""

from __future__ import annotations

import torch

from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops.binning import (
    TILE_H,
    TILE_W,
    Binning,
    bin_gaussians,
)
from event3dgs_tpu_torch.ops.expand import rect_min_q
from event3dgs_tpu_torch.ops.projection import ProjectedGaussians
from event3dgs_tpu_torch.ops.segscan import segment_sums, segment_sums_plain
from event3dgs_tpu_torch.utils.device import constant

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_SKIP = -13.8  # ln(1e-6): per-pixel early stop
FEAT = 12  # packed floats per Gaussian (see pack_features)
NGRAD = 9  # gradient floats per instance slot (K2's rows)
DEPTH_CHUNK = 16  # instances per step of the plain versions' alpha pass
SUB_W, SUB_H = 16, 8  # a warp's sub-block of the tile in K1 and K2
CULL_SLACK, CULL_EPS = 1e-3, 4e-6  # the warp cull's margins (warp_cull_mask)
_Q = TILE_H * TILE_W


def default_instance_cap(n: int) -> int:
    """The JAX package's default budget: max(8n, 16384), rounded up to a
    multiple of 1024."""
    return -(-max(8 * n, 1 << 14) // 1024) * 1024


def pack_features(mean2d, conic, colors, opacities) -> torch.Tensor:
    """[N, 12] float32 per-Gaussian rows for K1 and K2: mean x, y; the
    conic pre-scaled for the power form (−a/2, −b, −c/2); opacity; r, g, b;
    three pad floats (48-byte rows for aligned vector loads).

    The plain version of the rows that the preprocess forward kernel writes
    (``ops/preprocess.py``, ``packed``) for the views whose colours it
    computes: the train step and the colour render take those.  It packs
    the rows of the paths whose colours come from elsewhere: a render with
    ``override_colors`` (``render_depth``), the sharded exchange's
    gathered columns, and the probes and checks that pack a projection's
    outputs themselves."""
    n = mean2d.shape[0]
    scale = constant((-0.5, -1.0, -0.5), conic.dtype, conic.device)
    return torch.cat(
        [mean2d, conic * scale, opacities[:, None], colors,
         mean2d.new_zeros(n, 3)],
        dim=1,
    ).to(torch.float32).contiguous()


def _untile(x, tiles_x, tiles_y, width, height):
    """[T, Q, ...] tile-major → [H, W, ...] image (padding cropped)."""
    rest = x.shape[2:]
    x = x.reshape((tiles_y, tiles_x, TILE_H, TILE_W) + rest).transpose(1, 2)
    return x.reshape((tiles_y * TILE_H, tiles_x * TILE_W) + rest)[:height, :width]


def _retile(x, tiles_x, tiles_y):
    """[H, W, ...] image → [T, Q, ...] tile-major (padding zero)."""
    h, w = x.shape[:2]
    rest = x.shape[2:]
    pad = x.new_zeros((tiles_y * TILE_H, tiles_x * TILE_W) + rest)
    pad[:h, :w] = x
    pad = pad.reshape((tiles_y, TILE_H, tiles_x, TILE_W) + rest).transpose(1, 2)
    return pad.reshape((tiles_y * tiles_x, _Q) + rest)


def warp_cull_mask(f, ox, oy):
    """[..., 8] bool: which 16×8 sub-blocks of its tile (sub-block s at
    (16·(s % 2), 8·(s // 2)); the warps of K1 and K2) the instance with
    packed features ``f`` [..., 12] can reach, for tile origins ``ox``,
    ``oy`` broadcastable to ``f[..., 0]``.

    The kernels' arithmetic (``csrc/composite.cuh``), operation for
    operation: the conic (a, b, c) recovered from the pre-scaled one, the
    binning's per-tile test (:func:`~event3dgs_tpu_torch.ops.expand.rect_min_q`
    over the sub-block's pixel box expanded by 1 px, against
    qthr = 2·ln(255·o)) with a margin for float rounding:
    ``CULL_SLACK``·(qthr + 1), plus ``CULL_EPS`` times the largest
    magnitude of Q's terms over the box, (|a| + |b|)·X² + (|b| + |c|)·Y²
    (X, Y the box's largest |dx|, |dy|), which bounds the rounding of power
    where the terms cancel.  A NaN keeps the instance.  False only where
    every pixel of the sub-block has power > 0 or raw < 1/255.
    """
    mx = (f[..., 0] - ox)[..., None]
    my = (f[..., 1] - oy)[..., None]
    a, b, c = f[..., 2] * -2.0, f[..., 3] * -1.0, f[..., 4] * -2.0
    pd = (a > 1e-12) & (c > 1e-12) & (a * c - b * b > 1e-12)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    nba = torch.where(pd, -b / torch.where(pd, a, one), zero)[..., None]
    nbc = torch.where(pd, -b / torch.where(pd, c, one), zero)[..., None]
    a, b, c = (torch.where(pd, x, zero)[..., None] for x in (a, b, c))
    qthr = 2.0 * torch.clamp(
        torch.log(255.0 * torch.clamp(f[..., 5], min=1e-12)), min=0.0)
    limit = (qthr + CULL_SLACK * (qthr + 1.0))[..., None]
    sa, sc = a.abs() + b.abs(), b.abs() + c.abs()
    s = torch.arange(8, device=f.device)
    x0 = ((s % 2) * SUB_W).to(torch.float32)
    y0 = ((s // 2) * SUB_H).to(torch.float32)
    lx, hx = x0 - 1.0 - mx, x0 + float(SUB_W) - mx
    ly, hy = y0 - 1.0 - my, y0 + float(SUB_H) - my
    qmin = rect_min_q(lx, hx, ly, hy, a, b, c, nba, nbc)
    x = torch.maximum(lx.abs(), hx.abs())
    y = torch.maximum(ly.abs(), hy.abs())
    terms = sa * (x * x) + sc * (y * y)
    return ~(qmin > limit + CULL_EPS * terms)


class _TileGeometry:
    """Tile-local pixel coordinates and tile origins, as K1 and K2 use them."""

    def __init__(self, num_tiles, tiles_x, width, height, device):
        q = torch.arange(_Q, device=device)
        self.lx = (q % TILE_W).to(torch.float32)
        self.ly = (q // TILE_W).to(torch.float32)
        # the sub-block (warp) of each pixel
        self.sub = (q // TILE_W // SUB_H) * (TILE_W // SUB_W) + q % TILE_W // SUB_W
        t = torch.arange(num_tiles, device=device)
        self.ox = ((t % tiles_x) * TILE_W).to(torch.float32)
        self.oy = ((t // tiles_x) * TILE_H).to(torch.float32)
        self.inside = ((t[:, None] % tiles_x) * TILE_W + q % TILE_W < width) & (
            (t[:, None] // tiles_x) * TILE_H + q // TILE_W < height
        )

    def chunk(self, inst_gauss, tile_offsets, tile_counts, feat_pad, d0):
        """Instances d0 .. d0+DEPTH_CHUNK of every tile with K1's
        arithmetic: depth index j [D]; has, slot [T, D]; features
        [T, D, 12]; dx, dy, exp(power), power, raw opacity·exp(power) and
        alpha (0 where skipped) [T, D, Q]."""
        dev = feat_pad.device
        n = feat_pad.shape[0] - 1
        j = d0 + torch.arange(DEPTH_CHUNK, device=dev)
        has = j[None, :] < tile_counts[:, None]
        slot = torch.clamp(tile_offsets[:, None] + j[None, :],
                           max=max(inst_gauss.shape[0] - 1, 0))
        g = torch.where(has, inst_gauss[slot].long(), n)
        f = feat_pad[g]
        mx = f[..., 0] - self.ox[:, None]
        my = f[..., 1] - self.oy[:, None]
        dx = mx[..., None] - self.lx
        dy = my[..., None] - self.ly
        power = (f[..., 2, None] * (dx * dx) + f[..., 3, None] * (dx * dy)
                 + f[..., 4, None] * (dy * dy))
        e = torch.exp(power)
        raw = f[..., 5, None] * e
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        skip = (power > 0.0) | (raw < ALPHA_MIN) | ~has[..., None]
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
        return j, has, slot, f, dx, dy, e, power, raw, alpha


def _composite_plain(inst_gauss, tile_offsets, tile_counts, feat, tiles_x,
                     width, height):
    """K1's arithmetic on padded per-tile lists: alphas of ``DEPTH_CHUNK``
    instances at a time, vectorised over tiles and pixels, then the
    compositing in depth order.  Returns (rgb, logt, stop, pairs), ``pairs``
    counting the (pixel, instance) pairs visited before each pixel's early
    stop by what K1 (and K2, which visits the same pairs) does with them:
    int64 [4] (skipped at power > 0, skipped at raw < 1/255, composited, and
    of the skipped, those the warp cull removes: the kernels evaluate the
    visited pairs less these)."""
    dev = feat.device
    num_tiles = tile_counts.shape[0]
    tiles_y = num_tiles // tiles_x
    geo = _TileGeometry(num_tiles, tiles_x, width, height, dev)
    rgb = torch.zeros(num_tiles, _Q, 3, device=dev)
    logt = torch.zeros(num_tiles, _Q, device=dev)
    stop = torch.zeros(num_tiles, _Q, dtype=torch.int32, device=dev)
    feat_pad = torch.cat([feat, feat.new_zeros(1, FEAT)])
    power_skipped = composited = culled = torch.zeros((), dtype=torch.int64,
                                                     device=dev)
    max_count = int(tile_counts.max()) if num_tiles else 0
    for d0 in range(0, max_count, DEPTH_CHUNK):
        j, has, _, f, _, _, _, power, _, alpha = geo.chunk(
            inst_gauss, tile_offsets, tile_counts, feat_pad, d0)
        reach = warp_cull_mask(f, geo.ox[:, None], geo.oy[:, None])[..., geo.sub]
        for d in range(min(DEPTH_CHUNK, max_count - d0)):
            active = geo.inside & (logt >= LOG_T_SKIP)
            stop += (active & has[:, d, None]).to(torch.int32)
            a = torch.where(active, alpha[:, d], torch.zeros_like(logt))
            w = a * torch.exp(logt)
            rgb = rgb + w[..., None] * f[:, d, None, 6:9]
            logt = logt + torch.log1p(-a)
        # a pixel's visits are its first `stop` instances
        visited = j[None, :, None] < stop[:, None, :]
        power_skipped = power_skipped + (visited & (power > 0.0)).sum()
        composited = composited + (visited & (alpha > 0.0)).sum()
        culled = culled + (visited & ~reach).sum()
    pairs = torch.stack([power_skipped,
                         stop.sum() - power_skipped - composited, composited,
                         culled])
    untile = lambda x: _untile(x, tiles_x, tiles_y, width, height)
    return untile(rgb), untile(logt), untile(stop), pairs


def composite_forward_plain(inst_gauss, tile_offsets, tile_counts, feat,
                            tiles_x: int, width: int, height: int):
    """Plain PyTorch version of K1: ([H, W, 3] rgb, [H, W] log T,
    [H, W] int32 stop index)."""
    rgb, logt, stop, _ = _composite_plain(inst_gauss, tile_offsets,
                                          tile_counts, feat, tiles_x, width,
                                          height)
    return rgb, logt, stop.contiguous()


def launch_composite_forward(inst_gauss, tile_offsets, tile_counts, feat,
                             tiles_x: int, width: int, height: int,
                             defines=(), clock=None):
    """Check K1's arguments and launch the build of ``csrc/rasterize_fwd.cu``
    with the macros ``defines`` (none: the shipping K1) on CUDA tensors;
    ``clock``, an int64 [num_tiles, 2] tensor, takes the blocks' entry and
    exit times (a build with ``E3D_CLOCK``).  The timing-only builds are
    launched through here by ``tools/kernel_probes.py``."""
    num_tiles = tile_counts.shape[0]
    kernels.check(inst_gauss, torch.int32, "inst_gauss")
    kernels.check(tile_offsets, torch.int32, "tile_offsets", (num_tiles,))
    kernels.check(tile_counts, torch.int32, "tile_counts", (num_tiles,))
    kernels.check(feat, torch.float32, "feat", (feat.shape[0], FEAT))
    if feat.data_ptr() % 16:
        raise ValueError("feat: expected a 16-byte aligned tensor")
    dev = feat.device
    rgb = torch.empty(height, width, 3, dtype=torch.float32, device=dev)
    logt = torch.empty(height, width, dtype=torch.float32, device=dev)
    stop = torch.empty(height, width, dtype=torch.int32, device=dev)
    args = (inst_gauss.data_ptr(), tile_offsets.data_ptr(),
            tile_counts.data_ptr(), feat.data_ptr(), num_tiles, tiles_x, width,
            height, rgb.data_ptr(), logt.data_ptr(), stop.data_ptr())
    if clock is None:
        kernels.launch("rasterize_fwd", "e3d_composite_forward", *args,
                       defines=defines)
    else:
        kernels.check(clock, torch.int64, "clock", (num_tiles, 2))
        kernels.launch("rasterize_fwd", "e3d_composite_forward_clock", *args,
                       clock.data_ptr(), defines=defines)
    return rgb, logt, stop


def composite_forward_kernel(inst_gauss, tile_offsets, tile_counts, feat,
                             tiles_x: int, width: int, height: int):
    """Launch K1 (``csrc/rasterize_fwd.cu``) on CUDA tensors."""
    out = launch_composite_forward(inst_gauss, tile_offsets, tile_counts,
                                   feat, tiles_x, width, height)
    composite_forward_kernel.launches += 1
    return out


composite_forward_kernel.launches = 0


def composite_forward(inst_gauss, tile_offsets, tile_counts, feat,
                      tiles_x: int, width: int, height: int):
    """Composite every tile's depth-ordered instances: ([H, W, 3] rgb,
    [H, W] log T, [H, W] int32 stop index).  K1 for CUDA tensors, its plain
    version for CPU ones."""
    fn = composite_forward_plain if feat.device.type == "cpu" else \
        composite_forward_kernel
    return fn(inst_gauss, tile_offsets, tile_counts, feat, tiles_x, width,
              height)


def composite_backward_plain(inst_gauss, tile_offsets, tile_counts, feat,
                             tiles_x: int, width: int, height: int, g_rgb,
                             g_logt, logt, stop, n_slots: int):
    """Plain PyTorch version of K2: [n_slots, 9] gradient rows per instance
    slot (slots outside every tile's range are zero).

    Walks ``DEPTH_CHUNK`` instances at a time from the deepest chunk up,
    vectorised over tiles and pixels, with K2's per-pixel carries; the
    per-instance sums over a tile's pixels are ``torch.sum`` (another order
    than K2's butterfly, and K2 fuses its gradient products and sums into
    FMAs, so the two agree to rounding)."""
    dev = feat.device
    num_tiles = tile_counts.shape[0]
    tiles_y = num_tiles // tiles_x
    geo = _TileGeometry(num_tiles, tiles_x, width, height, dev)
    retile = lambda x: _retile(x, tiles_x, tiles_y)
    lt = retile(logt)
    carry = retile(g_logt)
    grad = retile(g_rgb)  # [T, Q, 3]
    stp = torch.where(geo.inside, torch.minimum(retile(stop),
                                                tile_counts[:, None]), 0)
    rows = torch.zeros(n_slots, NGRAD, device=dev)
    feat_pad = torch.cat([feat, feat.new_zeros(1, FEAT)])
    max_stop = int(stp.max()) if num_tiles else 0
    for d0 in reversed(range(0, max_stop, DEPTH_CHUNK)):
        j, has, slot, f, dx, dy, e, _, raw, alpha = geo.chunk(
            inst_gauss, tile_offsets, tile_counts, feat_pad, d0)
        comp = (alpha > 0.0) & (j[None, :, None] < stp[:, None, :])
        # g·c per (pixel, instance), in K2's order
        gc = (grad[:, None, :, 0] * f[..., 6, None]
              + grad[:, None, :, 1] * f[..., 7, None]
              + grad[:, None, :, 2] * f[..., 8, None])
        dalpha = torch.zeros_like(alpha)
        w = torch.zeros_like(alpha)
        for d in reversed(range(DEPTH_CHUNK)):
            cd, ad = comp[:, d], alpha[:, d]
            lt_in = lt - torch.log1p(-ad)
            t = torch.exp(lt_in)
            wd = ad * t
            da = gc[:, d] * t - carry / (1.0 - ad)
            carry = torch.where(cd, carry + wd * gc[:, d], carry)
            lt = torch.where(cd, lt_in, lt)
            w[:, d] = torch.where(cd, wd, torch.zeros_like(wd))
            dalpha[:, d] = torch.where(cd, da, torch.zeros_like(da))
        zero = torch.zeros_like(alpha)
        pas = comp & (raw < ALPHA_MAX)
        dpw = torch.where(pas, dalpha * alpha, zero)
        ca, cb, cc = f[..., 2, None], f[..., 3, None], f[..., 4, None]
        terms = [
            dpw * (2.0 * ca * dx + cb * dy),
            dpw * (2.0 * cc * dy + cb * dx),
            dpw * (-0.5 * (dx * dx)),
            dpw * (-(dx * dy)),
            dpw * (-0.5 * (dy * dy)),
            torch.where(pas, dalpha * e, zero),
            grad[:, None, :, 0] * w,
            grad[:, None, :, 1] * w,
            grad[:, None, :, 2] * w,
        ]
        chunk_rows = torch.stack([x.sum(-1) for x in terms], dim=-1)  # [T, D, 9]
        rows[slot[has]] = chunk_rows[has]
    return rows


def composite_backward_kernel(inst_gauss, tile_offsets, tile_counts, feat,
                              tiles_x: int, width: int, height: int, g_rgb,
                              g_logt, logt, stop, n_slots: int):
    """Launch K2 (``csrc/rasterize_bwd.cu``) on CUDA tensors."""
    num_tiles = tile_counts.shape[0]
    kernels.check(inst_gauss, torch.int32, "inst_gauss")
    kernels.check(tile_offsets, torch.int32, "tile_offsets", (num_tiles,))
    kernels.check(tile_counts, torch.int32, "tile_counts", (num_tiles,))
    kernels.check(feat, torch.float32, "feat", (feat.shape[0], FEAT))
    kernels.check(g_rgb, torch.float32, "g_rgb", (height, width, 3))
    kernels.check(g_logt, torch.float32, "g_logt", (height, width))
    kernels.check(logt, torch.float32, "logt", (height, width))
    kernels.check(stop, torch.int32, "stop", (height, width))
    if feat.data_ptr() % 16:
        raise ValueError("feat: expected a 16-byte aligned tensor")
    if n_slots < inst_gauss.shape[0]:
        raise ValueError(f"n_slots {n_slots} < {inst_gauss.shape[0]} slots")
    rows = torch.empty(n_slots, NGRAD, dtype=torch.float32, device=feat.device)
    kernels.launch(
        "rasterize_bwd", "e3d_composite_backward",
        inst_gauss.data_ptr(), tile_offsets.data_ptr(), tile_counts.data_ptr(),
        feat.data_ptr(), num_tiles, tiles_x, width, height, g_rgb.data_ptr(),
        g_logt.data_ptr(), logt.data_ptr(), stop.data_ptr(), rows.data_ptr(),
    )
    composite_backward_kernel.launches += 1
    return rows


composite_backward_kernel.launches = 0


def composite_backward(inst_gauss, tile_offsets, tile_counts, feat,
                       tiles_x: int, width: int, height: int, g_rgb, g_logt,
                       logt, stop, n_slots: int):
    """[n_slots, 9] per-slot gradient rows of the compositing: K2 for CUDA
    tensors, its plain version for CPU ones."""
    fn = composite_backward_plain if feat.device.type == "cpu" else \
        composite_backward_kernel
    return fn(inst_gauss, tile_offsets, tile_counts, feat, tiles_x, width,
              height, g_rgb, g_logt, logt, stop, n_slots)


def gaussian_grads(binning: Binning, rows, plain: bool = False):
    """K3: per-slot rows → [N, 9] per-Gaussian gradient sums."""
    seg = segment_sums_plain if plain else segment_sums
    offsets = binning.offsets
    return seg(rows, offsets[:-1], offsets[1:], binning.dest.shape[0],
               dest=binning.dest, order=binning.order)


class TiledRasterize(torch.autograd.Function):
    """Binning + K1 forward; K2 then K3 backward.

    ``forward(mean2d, conic, colors, opacities, depth, radius, valid,
    width, height, cap, plain, feat)`` → ([H, W, 3] rgb, [H, W] log T).
    ``feat``, the [N, 12] packed rows of the other four (as the preprocess
    forward writes them), or None: packed here.  Gradients go to mean2d,
    conic, colours and opacities, none to ``feat``.
    """

    @staticmethod
    def forward(ctx, mean2d, conic, colors, opacities, depth, radius, valid,
                width, height, cap, plain, feat):
        binning = bin_gaussians(
            mean2d, depth, radius, valid, width, height, cap,
            opacities=opacities, conic=conic, plain=plain,
        )
        if feat is None:
            feat = pack_features(mean2d, conic, colors, opacities)
        composite = composite_forward_plain if plain else composite_forward
        rgb, logt, stop = composite(binning.inst_gauss, binning.tile_offsets,
                                    binning.tile_counts, feat,
                                    binning.num_tiles_x, width, height)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(logt)  # an output: saved the checked way
            ctx.binning, ctx.feat, ctx.stop = binning, feat, stop
            ctx.size, ctx.plain = (width, height), plain
        return rgb, logt

    @staticmethod
    def backward(ctx, g_rgb, g_logt):
        (logt,) = ctx.saved_tensors
        b, feat, (width, height) = ctx.binning, ctx.feat, ctx.size
        if g_rgb is None:
            g_rgb = torch.zeros(height, width, 3, device=feat.device)
        if g_logt is None:
            g_logt = torch.zeros(height, width, device=feat.device)
        backward = composite_backward_plain if ctx.plain else composite_backward
        rows = backward(b.inst_gauss, b.tile_offsets, b.tile_counts, feat,
                        b.num_tiles_x, width, height, g_rgb.contiguous(),
                        g_logt.contiguous(), logt, ctx.stop,
                        b.inst_gauss.shape[0])
        gsum = gaussian_grads(b, rows, plain=ctx.plain)
        return (gsum[:, 0:2], gsum[:, 2:5], gsum[:, 6:9], gsum[:, 5],
                None, None, None, None, None, None, None, None)


def rasterize_tiled_partials(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    instance_cap: int | None = None,
    plain: bool = False,
    feat: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-background partials: ([H, W, 3] rgb, [H, W] log-transmittance),
    differentiable in ``proj.mean2d``, ``proj.conic``, ``colors`` and
    ``opacities``.

    ``feat`` is their [N, 12] packed rows where the preprocess wrote them
    (``preprocess(..., packed=True)``); None packs them here.  ``plain``
    runs the plain versions of K1-K6 on CUDA tensors too (for holding the
    kernels against them); CPU tensors always do.
    """
    n = proj.mean2d.shape[0]
    cap = default_instance_cap(n) if instance_cap is None else \
        -(-int(instance_cap) // 1024) * 1024
    return TiledRasterize.apply(
        proj.mean2d, proj.conic, colors, opacities, proj.depth.detach(),
        proj.radius.detach(), proj.valid, width, height, cap, plain, feat)


def rasterize_tiled(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    background: torch.Tensor,
    width: int,
    height: int,
    instance_cap: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """[H, W, 3] image: the partials composited over ``background``."""
    rgb, logt = rasterize_tiled_partials(
        proj, colors, opacities, width, height,
        instance_cap=instance_cap, plain=plain,
    )
    return rgb + torch.exp(logt)[:, :, None] * background[None, None, :]
