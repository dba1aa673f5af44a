"""The plain reference of the port's render: projection, SH colours, the
tile binning and the compositing, in plain PyTorch.

It follows the semantics that ``event3dgs_tpu_torch`` documents, written
again without its kernels, its binning or its operation order (frozen from
commit 3dea7a3; the constants and rules are copies of ``ops/projection.py``,
``ops/binning.py`` and ``ops/rasterize_tiled.py``):

- EWA projection with the 1.3× frustum clamp, +0.3 dilation, the 3σ radius
  from the largest eigenvalue, culling at view z ≤ 0.2, a singular
  covariance, off-screen rects and opacity < 1/255;
- colours max(SH(dir) + 0.5, 0) with the direction from the camera centre;
- a Gaussian's support: the 32×32 tiles of its radius rect intersected with
  the box of its α ≥ 1/255 region (+1 px), the tiles' lists in depth order
  (ties by index);
- per pixel, in depth order: α = min(0.99, o·exp(power)), skipped where
  power > 0 or o·exp(power) < 1/255, log T carried as a sum of
  log(1 − α), and the pixel stops before an instance once log T < ln 1e-6.

The compositing is vectorised over a chunk of tiles × their whole lists ×
the tile's 1,024 pixels (a cumulative sum over depth in place of the loop),
chunk after chunk; its backward recomputes each chunk under autograd
(:func:`composite_backward`).  ``dtype`` runs it all in another precision
(the benchmark's control runs it in bfloat16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_CULL_Z = 0.2
PROJ_EPS = 1e-7
DILATION = 0.3
TILE = 32
Q = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
LOG_T_SKIP = -13.8
# (tile, depth, pixel) elements per chunk of the compositing (its autograd
# keeps about ten floats an element)
CHUNK_ELEMENTS = 96 * 1024 * 1024

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """One view: world_view, full_proj [4, 4]; center [3]; tan_fovx,
    tan_fovy (0-d); width, height."""

    world_view: torch.Tensor
    full_proj: torch.Tensor
    center: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int


def camera(views, i: int, dtype=torch.float32) -> Camera:
    """View ``i`` of a ``scenes.recipes.Views`` batch."""
    return Camera(views.world_view[i].to(dtype), views.full_proj[i].to(dtype),
                  views.center[i].to(dtype), views.tan_fovx[i].to(dtype),
                  views.tan_fovy[i].to(dtype), views.width, views.height)


class Projected(NamedTuple):
    mean2d: torch.Tensor  # [N, 2] pixels
    conic: torch.Tensor  # [N, 3] (a, b, c) of the inverse 2D covariance
    depth: torch.Tensor  # [N] view z
    radius: torch.Tensor  # [N] 3σ radius in pixels, 0 where culled
    valid: torch.Tensor  # [N] bool


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotations of [N, 4] scalar-first quaternions."""
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(-1, 3, 3)


def project(means, scales, rotations, opacities, cam: Camera) -> Projected:
    """EWA projection of activated Gaussians into one view."""
    ones = torch.ones_like(means[:, :1])
    hom = torch.cat([means, ones], dim=1)
    view = hom @ cam.world_view
    clip = hom @ cam.full_proj
    tz = view[:, 2]
    in_front = tz > NEAR_CULL_Z
    inv_w = 1.0 / (clip[:, 3] + PROJ_EPS)
    mean2d = torch.stack([((clip[:, 0] * inv_w + 1.0) * cam.width - 1.0) * 0.5,
                          ((clip[:, 1] * inv_w + 1.0) * cam.height - 1.0) * 0.5],
                         dim=1)
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    z = torch.where(in_front, tz, torch.ones_like(tz))
    tx = torch.clamp(view[:, 0] / z, -1.3 * cam.tan_fovx, 1.3 * cam.tan_fovx) * z
    ty = torch.clamp(view[:, 1] / z, -1.3 * cam.tan_fovy, 1.3 * cam.tan_fovy) * z
    zeros = torch.zeros_like(z)
    J = torch.stack([fx / z, zeros, -fx * tx / (z * z),
                     zeros, fy / z, -fy * ty / (z * z)], dim=1).reshape(-1, 2, 3)
    T = J @ cam.world_view[:3, :3].T  # rows of J times the view rotation
    L = quat_matrix(rotations) * scales[:, None, :]  # R · diag(s)
    M = T @ L
    cov = M @ M.transpose(1, 2)
    a = cov[:, 0, 0] + DILATION
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + DILATION
    det = a * c - b * b
    det_ok = det > 0.0
    sdet = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / sdet, -b / sdet, a / sdet], dim=1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    on_screen = ((mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < cam.width)
                 & (mean2d[:, 1] + radius > 0) & (mean2d[:, 1] - radius < cam.height))
    valid = in_front & det_ok & on_screen & (opacities.detach() >= ALPHA_MIN)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    depth = torch.where(valid, tz, torch.full_like(tz, float("inf")))
    return Projected(mean2d, conic, depth, radius.detach(), valid)


def sh_colors(features, means, center) -> torch.Tensor:
    """[N, 3] max(SH(dir)·features + 0.5, 0) at degree 3 ([N, 16, 3])."""
    d = means - center[None, :]
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    x, y, z = d.unbind(1)
    xx, yy, zz = x * x, y * y, z * z
    basis = torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ], dim=1)
    return torch.clamp((features * basis[:, :, None]).sum(1) + 0.5, min=0.0)


class TileLists(NamedTuple):
    """Each tile's Gaussians in depth order."""

    gauss: torch.Tensor  # [P] int64 Gaussian of each (tile, Gaussian) pair
    start: torch.Tensor  # [T] int64 first pair of each tile
    count: torch.Tensor  # [T] int64 pairs of each tile
    tiles_x: int
    tiles_y: int


def tile_lists(p: Projected, opacities, width: int, height: int) -> TileLists:
    """The tiles each Gaussian supports (radius rect ∩ the α ≥ 1/255 box,
    +1 px), and each tile's list in depth order, ties by index."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    mean2d, conic = p.mean2d.detach().float(), p.conic.detach().float()
    radius, op = p.radius.float(), opacities.detach().float()
    ca, cb, cc = conic.unbind(1)
    det = ca * cc - cb * cb
    ok = det > 1e-12
    sdet = torch.where(ok, det, torch.ones_like(det))
    t2 = 2.0 * torch.clamp(torch.log(255.0 * torch.clamp(op, min=1e-12)), min=0.0)
    wx = torch.where(ok, torch.sqrt(torch.clamp(t2 * cc / sdet, min=0.0)) + 1.0, radius)
    wy = torch.where(ok, torch.sqrt(torch.clamp(t2 * ca / sdet, min=0.0)) + 1.0, radius)
    mx, my = mean2d.unbind(1)

    def bound(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n).long()

    x0 = torch.maximum(bound(mx - radius, tiles_x), bound(mx - wx, tiles_x))
    y0 = torch.maximum(bound(my - radius, tiles_y), bound(my - wy, tiles_y))
    x1 = torch.minimum(bound(mx + radius + TILE - 1, tiles_x),
                       bound(mx + wx + TILE - 1, tiles_x))
    y1 = torch.minimum(bound(my + radius + TILE - 1, tiles_y),
                       bound(my + wy + TILE - 1, tiles_y))
    w = torch.clamp(x1 - x0, min=0)
    count = torch.where(p.valid, w * torch.clamp(y1 - y0, min=0), 0)
    key = torch.where(count > 0, p.depth.detach().float(),
                      torch.full_like(mx, float("inf")))
    order = torch.sort(key, stable=True).indices
    c = count[order]
    g = torch.repeat_interleave(order, c)
    first = torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
    k = torch.arange(g.shape[0], device=g.device) - first
    tile = (y0[g] + k // w[g]) * tiles_x + x0[g] + k % w[g]
    by_tile = torch.sort(tile, stable=True).indices
    counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return TileLists(g[by_tile], torch.cumsum(counts, 0) - counts, counts,
                     tiles_x, tiles_y)


def features(p: Projected, colors, opacities) -> torch.Tensor:
    """[N, 9] what the compositing reads of each Gaussian: mean x, y; conic
    a, b, c; opacity; r, g, b."""
    return torch.cat([p.mean2d, p.conic, opacities[:, None], colors], dim=1)


def chunks(lists: TileLists, budget: int = CHUNK_ELEMENTS):
    """Groups of tiles (by rising list length) whose padded (tile, depth,
    pixel) elements stay within ``budget`` (a tile alone may exceed it)."""
    order = torch.sort(lists.count, stable=True).indices
    counts = lists.count[order].tolist()
    out, first = [], 0
    for i in range(1, len(counts) + 1):
        if i == len(counts) or (i - first + 1) * max(counts[i], 1) * Q > budget:
            out.append(order[first:i])
            first = i
    return out


def composite_chunk(feat, lists: TileLists, tiles, stats: bool = False):
    """The compositing of the tiles ``tiles`` [T'] → (rgb [T', Q, 3],
    log T [T', Q]), and with ``stats`` (composited pairs, instances with
    a composited pair) of the pixels inside the image are counted by the
    caller from the returned masks: (rgb, logt, composited [T', L, Q] bool)."""
    dev = feat.device
    n = feat.shape[0]
    count = lists.count[tiles]
    L = max(int(count.max()), 1)
    j = torch.arange(L, device=dev)
    has = j[None, :] < count[:, None]
    slot = torch.clamp(lists.start[tiles][:, None] + j[None, :],
                       max=max(lists.gauss.shape[0] - 1, 0))
    g = torch.where(has, lists.gauss[slot], n)
    f = torch.cat([feat, feat.new_zeros(1, feat.shape[1])])[g]  # [T', L, 9]
    q = torch.arange(Q, device=dev)
    px = ((tiles % lists.tiles_x) * TILE)[:, None] + q % TILE
    py = ((tiles // lists.tiles_x) * TILE)[:, None] + q // TILE
    dx = f[..., 0, None] - px[:, None, :].to(feat.dtype)
    dy = f[..., 1, None] - py[:, None, :].to(feat.dtype)
    power = (-0.5 * (f[..., 2, None] * dx * dx + f[..., 4, None] * dy * dy)
             - f[..., 3, None] * dx * dy)
    raw = f[..., 5, None] * torch.exp(power)
    keep = (power <= 0.0) & (raw >= ALPHA_MIN) & has[..., None]
    alpha = torch.where(keep, torch.clamp(raw, max=ALPHA_MAX),
                        torch.zeros_like(raw))
    l1m = torch.log1p(-alpha)
    before = torch.cumsum(l1m, dim=1) - l1m
    active = before >= LOG_T_SKIP
    w = torch.where(active, alpha * torch.exp(before), torch.zeros_like(alpha))
    rgb = torch.einsum("tlq,tlc->tqc", w, f[..., 6:9])
    logt = torch.where(active, l1m, torch.zeros_like(l1m)).sum(1)
    if stats:
        return rgb, logt, active & keep
    return rgb, logt


def _untile(x, lists: TileLists, width: int, height: int):
    """[T, Q, ...] → [H, W, ...]."""
    rest = x.shape[2:]
    x = x.reshape((lists.tiles_y, lists.tiles_x, TILE, TILE) + rest).transpose(1, 2)
    return x.reshape((lists.tiles_y * TILE, lists.tiles_x * TILE) + rest)[:height, :width]


def _retile(x, lists: TileLists):
    """[H, W, ...] → [T, Q, ...] (zero padding)."""
    h, w = x.shape[:2]
    rest = x.shape[2:]
    pad = x.new_zeros((lists.tiles_y * TILE, lists.tiles_x * TILE) + rest)
    pad[:h, :w] = x
    pad = pad.reshape((lists.tiles_y, TILE, lists.tiles_x, TILE) + rest).transpose(1, 2)
    return pad.reshape((lists.tiles_y * lists.tiles_x, Q) + rest)


@torch.no_grad()
def composite(feat, lists: TileLists, width: int, height: int,
              budget: int = CHUNK_ELEMENTS):
    """(rgb [H, W, 3], log T [H, W]) of a view."""
    T = lists.count.shape[0]
    rgb = feat.new_zeros(T, Q, 3)
    logt = feat.new_zeros(T, Q)
    for tiles in chunks(lists, budget):
        r, lt = composite_chunk(feat, lists, tiles)
        rgb[tiles], logt[tiles] = r, lt
    return _untile(rgb, lists, width, height), _untile(logt, lists, width, height)


def composite_backward(feat, lists: TileLists, g_rgb, g_logt,
                       budget: int = CHUNK_ELEMENTS) -> torch.Tensor:
    """The gradient [N, 9] of Σ g_rgb·rgb + g_logt·logt with respect to
    ``feat``: each chunk recomputed under autograd."""
    leaf = feat.detach().requires_grad_(True)
    gr, gl = _retile(g_rgb, lists), _retile(g_logt, lists)
    for tiles in chunks(lists, budget):
        with torch.enable_grad():
            r, lt = composite_chunk(leaf, lists, tiles)
            torch.autograd.backward([r, lt], [gr[tiles], gl[tiles]])
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


@torch.no_grad()
def pair_counts(feat, lists: TileLists, width: int, height: int,
                budget: int = CHUNK_ELEMENTS) -> dict:
    """What the view's compositing needs, counted from these inputs: the
    (pixel, instance) pairs composited before each pixel's stop (inside
    the image), and the (tile, Gaussian) instances with one such pair."""
    composited = used = 0
    inside_x = torch.arange(lists.tiles_x * TILE, device=feat.device) < width
    inside_y = torch.arange(lists.tiles_y * TILE, device=feat.device) < height
    inside = _retile((inside_y[:, None] & inside_x[None, :]).float(), lists) > 0
    for tiles in chunks(lists, budget):
        _, _, hit = composite_chunk(feat, lists, tiles, stats=True)
        hit = hit & inside[tiles][:, None, :]
        composited += int(hit.sum())
        used += int(hit.any(dim=2).sum())
    return {"composited": composited, "instances": used,
            "listed": int(lists.count.sum()), "tiles": int(lists.count.shape[0])}


def activated(raw: dict, dtype=torch.float32):
    """(means, features [N, K, 3], opacities [N], scales, rotations) of raw
    parameters, in ``dtype``."""
    c = {k: v.to(dtype) for k, v in raw.items()}
    return (c["xyz"], torch.cat([c["features_dc"], c["features_rest"]], dim=1),
            torch.sigmoid(c["opacity"][:, 0]), torch.exp(c["scaling"]),
            c["rotation"])


@torch.no_grad()
def render(raw: dict, cam: Camera, background, dtype=torch.float32,
           budget: int = CHUNK_ELEMENTS) -> torch.Tensor:
    """[H, W, 3] float32 image of one view over ``background``."""
    means, feats, opac, scales, rots = activated(raw, dtype)
    p = project(means, scales, rots, opac, cam)
    colors = sh_colors(feats, means, cam.center)
    lists = tile_lists(p, opac, cam.width, cam.height)
    rgb, logt = composite(features(p, colors, opac), lists, cam.width,
                          cam.height, budget)
    img = rgb + torch.exp(logt)[..., None] * background.to(dtype)
    return img.float()

