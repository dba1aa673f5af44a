"""The per-Gaussian preprocess of a step's renders: projection and SH
colours over the V views (1 to 3) it renders, forward and backward, as two
CUDA kernels (``csrc/preprocess.cu``).

The JAX package has no Pallas kernel here: ``project_gaussians``
(``event3dgs_tpu/ops/projection.py``) and ``gaussian_colors``
(``event3dgs_tpu/ops/render.py``) are elementwise code that XLA fuses, and
autodiff takes their gradients.  In plain PyTorch the same work is some 800
launches a render and direction, so the port runs it as one forward and one
backward kernel, the upstream CUDA rasterizer's ``preprocessCUDA`` /
``BACKWARD::preprocess`` pair, over all the views of a step at once.  The
kernels read the feature leaves ``features_dc`` [N, 1, 3] and
``features_rest`` [N, K-1, 3] where they lie and apply the step's [K] SH
mask themselves, so the step builds no concatenated or masked features,
and the backward writes the two leaves' gradient once, as one [N, K, 3]
tensor, summed over the views.  The forward also adds the render's mean2d
tap to the first view's means and, asked with ``packed``, writes each
coloured view's [N, 12] packed rows, which the compositing kernels K1 and
K2 read (:func:`~event3dgs_tpu_torch.ops.rasterize_tiled.pack_features`'s
layout): the train step and the render pack no rows of their own.

- :func:`preprocess_forward_plain` is the plain forward: per camera the
  port's :func:`~event3dgs_tpu_torch.ops.projection.project_gaussians` and
  :func:`~event3dgs_tpu_torch.ops.render.gaussian_colors` on
  ``concatenate(dc, rest) * cmask``, the tap added to the first view's
  means, and ``pack_features`` of what they return.  The forward kernel
  repeats their operations in their order, so on the card it equals them
  bit for bit.
- :func:`preprocess_backward_plain` is the analytic backward in plain
  tensor code: :func:`view_backward_plain`, the backward kernel's formulas
  line for line, at each view, the views' gradients added from the last
  view to the first (as autograd adds those of renders made one after
  another, so that a step's gradients equal the per-render step's bit for
  bit), the features' then multiplied by the mask and split into dc and
  rest.
  A Gaussian that is not ``valid`` in a view gets a zero gradient from it
  (the rasterizers give it none; autograd of the plain forward can give
  0·inf = NaN there).
- :class:`Preprocess` is the ``torch.autograd.Function`` around them;
  :func:`preprocess_views` (V views, the feature leaves and the mask) and
  :func:`preprocess` (one view, [N, K, 3] features, which the kernels read
  as two strided views of themselves) are its entries.  The tap's gradient
  is the first view's mean2d gradient; the packed rows take none (their
  gradients reach mean2d, conic, colours and the opacities through the
  rasterizer's own inputs).  CPU tensors take
  the plain versions, CUDA tensors the kernels, or the plain versions with
  ``plain=True``.  On CUDA a failed build or launch raises; nothing falls
  back.
"""

from __future__ import annotations

import ctypes

import torch

from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.core.sh import SH_C1, SH_C2, SH_C3, SH_C4, sh_basis
from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.ops.projection import (
    DILATION,
    NEAR_CULL_Z,
    PROJ_EPS,
    ProjectedGaussians,
    project_gaussians,
    rotation_entries,
    row_norm,
)
from event3dgs_tpu_torch.ops.rasterize_tiled import FEAT, pack_features

MAX_COEFFS = 25  # SH degree 4: the kernels' widest feature row
MAX_VIEWS = 3  # the views one launch takes: the event modes' three renders


def masked_features(features_dc, features_rest, cmask=None):
    """The [N, K, 3] features of the leaves, times the [K] mask where one is
    given: what the kernels read (None without features)."""
    if features_dc is None:
        return None
    features = torch.cat([features_dc, features_rest], dim=1)
    return features if cmask is None else features * cmask[None, :, None]


def _check_packed(packed: bool, features_dc, opacities):
    if packed and features_dc is not None and opacities is None:
        raise ValueError("packed rows need the opacities")


def preprocess_forward_plain(means3d, scales, rotations, cameras,
                             scaling_modifier: float = 1.0, opacities=None,
                             features_dc=None, features_rest=None,
                             cmask=None, sh_degree: int = 0, mean2d_tap=None,
                             packed: bool = False):
    """Plain PyTorch version of the forward kernel: per camera of
    ``cameras``, (:class:`ProjectedGaussians`, [N, 3] colours or None
    without features), the [N, 2] ``mean2d_tap`` (or None) added to the
    first camera's mean2d; with ``packed`` a third entry, the view's [N,
    12] packed rows (``pack_features`` of its mean2d, conic, colours and
    the opacities; None without features)."""
    from event3dgs_tpu_torch.ops.render import gaussian_colors

    _check_packed(packed, features_dc, opacities)
    features = masked_features(features_dc, features_rest, cmask)
    out = []
    for v, cam in enumerate(cameras):
        proj = project_gaussians(means3d, scales, rotations, cam,
                                 scaling_modifier=scaling_modifier,
                                 opacities=opacities)
        if v == 0 and mean2d_tap is not None:
            proj = proj._replace(mean2d=proj.mean2d + mean2d_tap)
        colors = None if features is None else gaussian_colors(
            sh_degree, features, means3d, cam.camera_center)
        if not packed:
            out.append((proj, colors))
            continue
        out.append((proj, colors, None if colors is None else pack_features(
            proj.mean2d, proj.conic, colors, opacities)))
    return out


def sh_basis_grad(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """∂B_k/∂(x, y, z) of :func:`~event3dgs_tpu_torch.core.sh.sh_basis` at
    ``dirs`` [N, 3], the basis taken as a function of three free
    coordinates: [N, (deg+1)², 3]."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    zero = torch.zeros_like(x)
    xx, yy, zz = x * x, y * y, z * z
    rows = [(zero, zero, zero)]
    if deg >= 1:
        c = SH_C1
        rows += [(zero, -c + zero, zero), (zero, zero, c + zero),
                 (-c + zero, zero, zero)]
    if deg >= 2:
        c = SH_C2
        rows += [(c[0] * y, c[0] * x, zero), (zero, c[1] * z, c[1] * y),
                 (-2.0 * c[2] * x, -2.0 * c[2] * y, 4.0 * c[2] * z),
                 (c[3] * z, zero, c[3] * x),
                 (2.0 * c[4] * x, -2.0 * c[4] * y, zero)]
    if deg >= 3:
        c = SH_C3
        rows += [
            (c[0] * 6.0 * x * y, c[0] * 3.0 * (xx - yy), zero),
            (c[1] * y * z, c[1] * x * z, c[1] * x * y),
            (c[2] * -2.0 * x * y, c[2] * (4.0 * zz - xx - 3.0 * yy),
             c[2] * 8.0 * y * z),
            (c[3] * -6.0 * x * z, c[3] * -6.0 * y * z,
             c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (c[4] * (4.0 * zz - 3.0 * xx - yy), c[4] * -2.0 * x * y,
             c[4] * 8.0 * x * z),
            (c[5] * 2.0 * x * z, c[5] * -2.0 * y * z, c[5] * (xx - yy)),
            (c[6] * 3.0 * (xx - yy), c[6] * -6.0 * x * y, zero),
        ]
    if deg >= 4:
        c = SH_C4
        rows += [
            (c[0] * y * (3.0 * xx - yy), c[0] * x * (xx - 3.0 * yy), zero),
            (c[1] * 6.0 * x * y * z, c[1] * 3.0 * z * (xx - yy),
             c[1] * y * (3.0 * xx - yy)),
            (c[2] * y * (7.0 * zz - 1.0), c[2] * x * (7.0 * zz - 1.0),
             c[2] * 14.0 * x * y * z),
            (zero, c[3] * z * (7.0 * zz - 3.0), c[3] * y * (21.0 * zz - 3.0)),
            (zero, zero, c[4] * z * (140.0 * zz - 60.0)),
            (c[5] * z * (7.0 * zz - 3.0), zero, c[5] * x * (21.0 * zz - 3.0)),
            (c[6] * 2.0 * x * (7.0 * zz - 1.0),
             c[6] * -2.0 * y * (7.0 * zz - 1.0), c[6] * 14.0 * z * (xx - yy)),
            (c[7] * 3.0 * z * (xx - yy), c[7] * -6.0 * x * y * z,
             c[7] * x * (xx - 3.0 * yy)),
            (c[8] * 4.0 * x * (xx - 3.0 * yy), c[8] * 4.0 * y * (yy - 3.0 * xx),
             zero),
        ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)


def view_backward_plain(means3d, scales, rotations, camera: Camera, valid,
                        g_mean2d=None, g_conic=None, g_colors=None,
                        scaling_modifier: float = 1.0, features=None,
                        sh_degree: int = 0):
    """The backward kernel's formulas at one view, in plain PyTorch: from
    the gradients of mean2d [N, 2], conic [N, 3] and colours [N, 3] (None:
    zero), the gradients of the means [N, 3], scales [N, 3], quaternions
    [N, 4] and features ([N, K, 3], the features as the view saw them, or
    None without ``features``); zero where ``valid`` [N] is False.  The
    forward's intermediates are recomputed."""
    W, P = camera.world_view, camera.full_proj
    m0, m1, m2 = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    zero = torch.zeros_like(m0)

    def xform(M, j):
        return m0 * M[0, j] + m1 * M[1, j] + m2 * M[2, j] + M[3, j]

    tv0, tv1, tz = xform(W, 0), xform(W, 1), xform(W, 2)
    pc0, pc1, pcw = xform(P, 0), xform(P, 1), xform(P, 3)
    inv_w = 1.0 / (pcw + PROJ_EPS)
    fx = camera.width / (2.0 * camera.tan_fovx)
    fy = camera.height / (2.0 * camera.tan_fovy)
    # a valid Gaussian lies past the near plane; elsewhere 1 keeps the
    # arithmetic finite (its gradient is masked to zero at the end)
    safe_tz = torch.where(tz > NEAR_CULL_Z, tz, torch.ones_like(tz))
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    rx, ry = tv0 / safe_tz, tv1 / safe_tz
    cx = torch.clamp(rx, -lim_x, lim_x)
    cy = torch.clamp(ry, -lim_y, lim_y)
    txz, tyz = cx * safe_tz, cy * safe_tz
    inv_z = 1.0 / safe_tz
    inv_z2 = inv_z * inv_z
    au, bu = fx * inv_z, -fx * txz * inv_z2
    av, bv = fy * inv_z, -fy * tyz * inv_z2
    u = [au * W[k, 0] + bu * W[k, 2] for k in range(3)]
    v = [av * W[k, 1] + bv * W[k, 2] for k in range(3)]

    nq = row_norm(rotations)
    qn = rotations / nq
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    R = rotation_entries(qw, qx, qy, qz)
    s = [scales[:, j] * scaling_modifier for j in range(3)]
    Tu = [sum(u[k] * R[k][j] for k in range(3)) for j in range(3)]
    Tv = [sum(v[k] * R[k][j] for k in range(3)) for j in range(3)]
    wu = [s[j] * Tu[j] for j in range(3)]
    wv = [s[j] * Tv[j] for j in range(3)]
    a = sum(w * w for w in wu) + DILATION
    b = sum(wu[j] * wv[j] for j in range(3))
    c = sum(w * w for w in wv) + DILATION
    det = a * c - b * b

    # conic = (c, -b, a) / det
    gA, gB, gC = (zero, zero, zero) if g_conic is None else \
        (g_conic[:, 0], g_conic[:, 1], g_conic[:, 2])
    inv_det = 1.0 / det
    ddet = -(gA * c - gB * b + gC * a) * inv_det * inv_det
    da = gC * inv_det + ddet * c
    db = -gB * inv_det - 2.0 * b * ddet
    dc = gA * inv_det + ddet * a
    # a = |wu|² + 0.3, b = wu·wv, c = |wv|² + 0.3; wu_j = s_j Tu_j
    dwu = [2.0 * wu[j] * da + wv[j] * db for j in range(3)]
    dwv = [2.0 * wv[j] * dc + wu[j] * db for j in range(3)]
    g_scales = torch.stack([(dwu[j] * Tu[j] + dwv[j] * Tv[j])
                            * scaling_modifier for j in range(3)], dim=-1)
    dTu = [dwu[j] * s[j] for j in range(3)]
    dTv = [dwv[j] * s[j] for j in range(3)]
    # Tu_j = Σ_k u_k R_kj
    du = [dTu[0] * R[k][0] + dTu[1] * R[k][1] + dTu[2] * R[k][2]
          for k in range(3)]
    dv = [dTv[0] * R[k][0] + dTv[1] * R[k][1] + dTv[2] * R[k][2]
          for k in range(3)]
    dR = [[u[k] * dTu[j] + v[k] * dTv[j] for j in range(3)] for k in range(3)]
    # the rotation's entries from the normalised quaternion, then q/|q|
    dqn = torch.stack([
        2.0 * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0]
               - qx * dR[1][2] - qy * dR[2][0] + qx * dR[2][1]),
        2.0 * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0]
               - 2.0 * qx * dR[1][1] - qw * dR[1][2] + qz * dR[2][0]
               + qw * dR[2][1] - 2.0 * qx * dR[2][2]),
        2.0 * (-2.0 * qy * dR[0][0] + qx * dR[0][1] + qw * dR[0][2]
               + qx * dR[1][0] + qz * dR[1][2] - qw * dR[2][0]
               + qz * dR[2][1] - 2.0 * qy * dR[2][2]),
        2.0 * (-2.0 * qz * dR[0][0] - qw * dR[0][1] + qx * dR[0][2]
               + qw * dR[1][0] - 2.0 * qz * dR[1][1] + qy * dR[1][2]
               + qx * dR[2][0] + qy * dR[2][1]),
    ], dim=-1)
    dot = (dqn * qn).sum(-1, keepdim=True)
    g_rotations = (dqn - qn * dot) / nq

    # u_k = au W[k, 0] + bu W[k, 2], v_k = av W[k, 1] + bv W[k, 2]
    dau = sum(du[k] * W[k, 0] for k in range(3))
    dbu = sum(du[k] * W[k, 2] for k in range(3))
    dav = sum(dv[k] * W[k, 1] for k in range(3))
    dbv = sum(dv[k] * W[k, 2] for k in range(3))
    # au = fx/z, bu = -fx txz/z², av = fy/z, bv = -fy tyz/z²
    dinv_z2 = -fx * txz * dbu - fy * tyz * dbv
    dinv_z = fx * dau + fy * dav + 2.0 * inv_z * dinv_z2
    dtxz = -fx * inv_z2 * dbu
    dtyz = -fy * inv_z2 * dbv
    dtz = -dinv_z * inv_z * inv_z + dtxz * cx + dtyz * cy
    # txz = clamp(tv0 / z) z: no gradient through the clamp where it clips
    drx = torch.where((rx >= -lim_x) & (rx <= lim_x), dtxz * safe_tz, zero)
    dry = torch.where((ry >= -lim_y) & (ry <= lim_y), dtyz * safe_tz, zero)
    dtv0, dtv1 = drx / safe_tz, dry / safe_tz
    dtz = dtz - (dtv0 * rx + dtv1 * ry)

    # mean2d = ((pc · inv_w + 1) size - 1) / 2
    dpc0 = dpc1 = dpcw = zero
    if g_mean2d is not None:
        gx = g_mean2d[:, 0] * 0.5 * camera.width
        gy = g_mean2d[:, 1] * 0.5 * camera.height
        dpc0, dpc1 = gx * inv_w, gy * inv_w
        dpcw = -(gx * pc0 + gy * pc1) * inv_w * inv_w
    g_means = torch.stack([
        dtv0 * W[k, 0] + dtv1 * W[k, 1] + dtz * W[k, 2] + dpc0 * P[k, 0]
        + dpc1 * P[k, 1] + dpcw * P[k, 3] for k in range(3)], dim=-1)

    g_features = None
    if features is not None:
        g_features = torch.zeros_like(features)
        if g_colors is not None:
            ncoef = (sh_degree + 1) ** 2
            d = means3d - camera.camera_center[None, :]
            nrm = row_norm(d)
            dirs = d / nrm
            basis = sh_basis(sh_degree, dirs)
            rgb = features[:, 0, :] * basis[:, 0, None]
            for k in range(1, ncoef):
                rgb = rgb + features[:, k, :] * basis[:, k, None]
            # colour = max(rgb + 0.5, 0)
            drgb = torch.where(rgb + 0.5 >= 0.0, g_colors,
                               torch.zeros_like(g_colors))
            g_features[:, :ncoef] = drgb[:, None, :] * basis[:, :, None]
            dB = (drgb[:, None, :] * features[:, :ncoef]).sum(-1)
            gd = (dB[:, :, None] * sh_basis_grad(sh_degree, dirs)).sum(1)
            # dirs = d / |d|
            g_means = g_means + (
                gd - dirs * (gd * dirs).sum(-1, keepdim=True)) / nrm
        g_features = torch.where(valid[:, None, None], g_features,
                                 torch.zeros_like(g_features))
    live = valid[:, None]
    mask = lambda g: torch.where(live, g, torch.zeros_like(g))
    return mask(g_means), mask(g_scales), mask(g_rotations), g_features


def preprocess_backward_plain(means3d, scales, rotations, cameras, valid,
                              g_mean2d, g_conic, g_colors,
                              scaling_modifier: float = 1.0,
                              features_dc=None, features_rest=None,
                              cmask=None, sh_degree: int = 0):
    """Plain PyTorch version of the backward kernel.  ``valid``,
    ``g_mean2d``, ``g_conic`` and ``g_colors`` hold one entry per camera
    of ``cameras`` (a gradient None: zero).  Returns the gradients of the
    means, scales and quaternions and of the two feature leaves (None
    without features): :func:`view_backward_plain` at each view, added
    from the last view to the first, (g_2 + g_1) + g_0, the order in which
    autograd adds the gradients of renders made one after another; the
    features' sum then times the mask."""
    features = masked_features(features_dc, features_rest, cmask)
    total = None
    for v, cam in reversed(list(enumerate(cameras))):
        grads = view_backward_plain(
            means3d, scales, rotations, cam, valid[v], g_mean2d[v],
            g_conic[v], None if features is None else g_colors[v],
            scaling_modifier, features, sh_degree)
        total = list(grads) if total is None else [
            None if a is None else a + b for a, b in zip(total, grads)]
    g_means, g_scales, g_rotations, g_features = total
    if g_features is None:
        return g_means, g_scales, g_rotations, None, None
    if cmask is not None:
        g_features = g_features * cmask[None, :, None]
    return (g_means, g_scales, g_rotations, g_features[:, :1],
            g_features[:, 1:])


def _check_camera(camera: Camera):
    """The camera's fields as the kernels read them: float32 CUDA tensors
    (world_view and full_proj [4, 4], camera_center [3], the tangents
    0-dimensional), contiguous."""
    for f, shape in (("world_view", (4, 4)), ("full_proj", (4, 4)),
                     ("camera_center", (3,)), ("tan_fovx", ()),
                     ("tan_fovy", ())):
        kernels.check(getattr(camera, f), torch.float32, f"camera.{f}", shape)
    return [camera.world_view.data_ptr(), camera.full_proj.data_ptr(),
            camera.camera_center.data_ptr(), camera.tan_fovx.data_ptr(),
            camera.tan_fovy.data_ptr()]


def _check_views(cameras) -> int:
    if not 1 <= len(cameras) <= MAX_VIEWS:
        raise ValueError(f"expected 1 to {MAX_VIEWS} cameras, got "
                         f"{len(cameras)}")
    return len(cameras)


def _rows(t, shape, what: str):
    """(tensor, row stride in floats) of a float32 CUDA tensor of ``shape``
    as a kernel reads it: where it lies when each row (its trailing
    dimensions) is contiguous, as in a slice of a wider tensor (a feature
    leaf of [N, K, 3] features, a gradient of the rasterizer's [N, 9]
    sums), else a contiguous copy."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{what}: expected a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    width = t[0].numel() if len(t) else 0
    if len(t) and (not t[0].is_contiguous()
                   or (len(t) > 1 and t.stride(0) < width)):
        t = t.contiguous()
    return t, max(t.stride(0), width)


def _check_features(features_dc, features_rest, cmask, n: int,
                    sh_degree: int):
    """The feature leaves and mask as the kernels read them: (dc, its row
    stride, rest, its row stride, K, mask pointer), or None without
    features."""
    if features_dc is None:
        return None
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    k = 1 + (features_rest.shape[1] if features_rest.dim() == 3 else -1)
    if not (sh_degree + 1) ** 2 <= k <= MAX_COEFFS:
        raise ValueError(f"features: expected {(sh_degree + 1) ** 2} <= K <= "
                         f"{MAX_COEFFS} coefficients, got {k}")
    dc, ld_dc = _rows(features_dc, (n, 1, 3), "features_dc")
    rest, ld_rest = _rows(features_rest, (n, k - 1, 3), "features_rest")
    if cmask is not None:
        kernels.check(cmask, torch.float32, "cmask", (k,))
    return (dc, ld_dc, rest, ld_rest, k,
            None if cmask is None else cmask.data_ptr())


def _check_gaussians(means3d, scales, rotations) -> int:
    n = means3d.shape[0]
    kernels.check(means3d, torch.float32, "means3d", (n, 3))
    kernels.check(scales, torch.float32, "scales", (n, 3))
    kernels.check(rotations, torch.float32, "rotations", (n, 4))
    return n


def preprocess_forward_kernel(means3d, scales, rotations, cameras,
                              scaling_modifier: float = 1.0, opacities=None,
                              features_dc=None, features_rest=None,
                              cmask=None, sh_degree: int = 0, mean2d_tap=None,
                              packed: bool = False):
    """Launch the forward kernel (``csrc/preprocess.cu``) on CUDA tensors:
    one launch for all of ``cameras``, the arguments and outputs of
    :func:`preprocess_forward_plain` (the packed rows 16-byte aligned)."""
    n = _check_gaussians(means3d, scales, rotations)
    views = _check_views(cameras)
    _check_packed(packed, features_dc, opacities)
    if opacities is not None:
        kernels.check(opacities, torch.float32, "opacities", (n,))
    if mean2d_tap is not None:
        kernels.check(mean2d_tap, torch.float32, "mean2d_tap", (n, 2))
    feats = _check_features(features_dc, features_rest, cmask, n, sh_degree)
    cams = [_check_camera(c) for c in cameras]
    dev = means3d.device
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device=dev)
    colored = feats is not None
    out = [(ProjectedGaussians(mean2d=empty(n, 2), depth=empty(n),
                               conic=empty(n, 3), radius=empty(n),
                               valid=empty(n, dtype=torch.bool)),
            empty(n, 3) if colored else None,
            empty(n, FEAT) if colored and packed else None) for _ in cameras]
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = (ctypes.c_void_p * (12 * views))(*(
        x for cam, (proj, colors, feat) in zip(cams, out)
        for x in (*cam, *(t.data_ptr() for t in proj), ptr(colors),
                  ptr(feat))))
    sizes = (ctypes.c_int * (2 * views))(
        *(s for c in cameras for s in (c.width, c.height)))
    dc, ld_dc, rest, ld_rest, k, mask = feats or (None, 3, None, 0, 1, None)
    kernels.launch(
        "preprocess", "e3d_preprocess_forward",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        ptr(opacities), ptr(mean2d_tap),
        None if dc is None else dc.data_ptr(), ld_dc,
        None if rest is None or k == 1 else rest.data_ptr(), ld_rest, k,
        mask, -1 if feats is None else sh_degree, n, float(scaling_modifier),
        views, ctypes.addressof(ptrs), ctypes.addressof(sizes))
    preprocess_forward_kernel.launches += 1
    return out if packed else [entry[:2] for entry in out]


preprocess_forward_kernel.launches = 0


def preprocess_backward_kernel(means3d, scales, rotations, cameras, valid,
                               g_mean2d, g_conic, g_colors,
                               scaling_modifier: float = 1.0,
                               features_dc=None, features_rest=None,
                               cmask=None, sh_degree: int = 0, out=None):
    """Launch the backward kernel (``csrc/preprocess.cu``) on CUDA tensors:
    one launch for all of ``cameras``, the arguments of
    :func:`preprocess_backward_plain`.  The kernel writes both leaves'
    gradients as one [N, K, 3] tensor, ``out`` where given (contiguous
    float32), and returns its views ``out[:, :1]`` and ``out[:, 1:]``."""
    n = _check_gaussians(means3d, scales, rotations)
    views = _check_views(cameras)
    feats = _check_features(features_dc, features_rest, cmask, n, sh_degree)
    cams = [_check_camera(c) for c in cameras]
    for v in range(views):
        kernels.check(valid[v], torch.bool, f"valid[{v}]", (n,))
    rows = [[(None, 0) if g[v] is None
             else _rows(g[v], (n, w), f"{what}[{v}]") for g, w, what in (
                 (g_mean2d, 2, "g_mean2d"), (g_conic, 3, "g_conic"),
                 (g_colors if feats is not None else [None] * views, 3,
                  "g_colors"))]
            for v in range(views)]
    dev = means3d.device
    g_means = torch.empty(n, 3, device=dev)
    g_scales = torch.empty(n, 3, device=dev)
    g_rotations = torch.empty(n, 4, device=dev)
    g_dc = g_rest = None
    k = 1 if feats is None else feats[4]
    if feats is not None:
        if out is None:
            out = torch.empty(n, k, 3, device=dev)
        else:
            kernels.check(out, torch.float32, "out", (n, k, 3))
        g_dc, g_rest = out[:, :1], out[:, 1:]
    ptrs = (ctypes.c_void_p * (9 * views))(*(
        x for v in range(views) for x in (
            *cams[v], valid[v].data_ptr(),
            *(None if t is None else t.data_ptr() for t, _ in rows[v]))))
    ints = (ctypes.c_int * (5 * views))(*(
        x for v in range(views) for x in (
            cameras[v].width, cameras[v].height, *(r[1] for r in rows[v]))))
    dc, ld_dc, rest, ld_rest, _, mask = feats or (None, 3, None, 0, 1, None)
    kernels.launch(
        "preprocess", "e3d_preprocess_backward",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        None if dc is None else dc.data_ptr(), ld_dc,
        None if rest is None or k == 1 else rest.data_ptr(), ld_rest, k,
        mask, -1 if feats is None else sh_degree, n, float(scaling_modifier),
        views, ctypes.addressof(ptrs), ctypes.addressof(ints),
        g_means.data_ptr(), g_scales.data_ptr(), g_rotations.data_ptr(),
        None if out is None else out.data_ptr(), 3 * k)
    preprocess_backward_kernel.launches += 1
    return g_means, g_scales, g_rotations, g_dc, g_rest


preprocess_backward_kernel.launches = 0


def preprocess_forward(*args, **kw):
    """The forward kernel for CUDA tensors, its plain version for CPU
    ones (arguments of :func:`preprocess_forward_plain`)."""
    fn = preprocess_forward_plain if args[0].device.type == "cpu" else \
        preprocess_forward_kernel
    return fn(*args, **kw)


def preprocess_backward(*args, **kw):
    """The backward kernel for CUDA tensors, its plain version for CPU
    ones (arguments of :func:`preprocess_backward_plain`)."""
    fn = preprocess_backward_plain if args[0].device.type == "cpu" else \
        preprocess_backward_kernel
    return fn(*args, **kw)


class Preprocess(torch.autograd.Function):
    """Projection and SH colours over V views, forward and backward.

    ``forward(means3d, scales, rotations, opacities, features, features_dc,
    features_rest, cmask, mean2d_tap, cameras, scaling_modifier, sh_degree,
    packed, plain)`` takes the features as one [N, K, 3] tensor
    (``features``) or as the two leaves, and returns per view (mean2d,
    depth, conic, radius, valid[, colours[, packed rows]]), one flat tuple;
    gradients flow to the means, scales, rotations and features, and to
    the tap (the first view's mean2d gradient), none to the opacities, the
    mask, depth, radius, valid and the packed rows.  One launch of each
    kernel serves all the views.
    """

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, features,
                features_dc, features_rest, cmask, mean2d_tap, cameras,
                scaling_modifier, sh_degree, packed, plain):
        if features is not None:
            features_dc, features_rest = features[:, :1], features[:, 1:]
        fwd = preprocess_forward_plain if plain else preprocess_forward
        views = fwd(means3d, scales, rotations, cameras, scaling_modifier,
                    opacities, features_dc, features_rest, cmask, sh_degree,
                    mean2d_tap=mean2d_tap, packed=packed)
        if not packed:
            views = [(proj, colors, None) for proj, colors in views]
        ctx.mark_non_differentiable(*(t for proj, _, feat in views for t in (
            proj.depth, proj.radius, proj.valid,
            *(() if feat is None else (feat,)))))
        ctx.set_materialize_grads(False)
        saved = (features,) if features is not None else (features_dc,
                                                          features_rest)
        ctx.save_for_backward(means3d, scales, rotations, cmask, *saved,
                              *(proj.valid for proj, _, _ in views))
        ctx.cameras, ctx.plain = cameras, plain
        ctx.whole = features is not None
        ctx.tapped = mean2d_tap is not None
        ctx.scaling_modifier, ctx.sh_degree = scaling_modifier, sh_degree
        return tuple(t for proj, colors, feat in views for t in (
            *proj, *(() if colors is None else (colors,)),
            *(() if feat is None else (feat,))))

    @staticmethod
    def backward(ctx, *grads):
        means3d, scales, rotations, cmask, *rest = ctx.saved_tensors
        views = len(ctx.cameras)
        valid = rest[-views:]
        if ctx.whole:
            features = rest[0]
            dc, fr = features[:, :1], features[:, 1:]
        else:
            dc, fr = rest[0], rest[1]
        # a view's outputs: mean2d, depth, conic, radius, valid[, colours[,
        # packed rows]]
        per = len(grads) // views
        g = [grads[v * per:(v + 1) * per] for v in range(views)]
        args = (means3d, scales, rotations, ctx.cameras, valid,
                [x[0] for x in g], [x[2] for x in g],
                [x[5] if per > 5 else None for x in g], ctx.scaling_modifier,
                dc, fr, cmask, ctx.sh_degree)
        if ctx.plain or means3d.device.type == "cpu":
            g_means, g_scales, g_rotations, g_dc, g_rest = \
                preprocess_backward_plain(*args)
            g_features = (torch.cat([g_dc, g_rest], dim=1) if ctx.whole
                          else None)
        else:  # the whole features are contiguous here (_apply)
            g_features = torch.empty_like(features) if ctx.whole else None
            g_means, g_scales, g_rotations, g_dc, g_rest = \
                preprocess_backward_kernel(*args, out=g_features)
        if ctx.whole:
            g_dc = g_rest = None
        # mean2d = projection + tap: the tap's gradient is mean2d's
        g_tap = g[0][0] if ctx.tapped else None
        return (g_means, g_scales, g_rotations, None, g_features, g_dc,
                g_rest, None, g_tap, None, None, None, None, None)


def _apply(means3d, scales, rotations, opacities, features, features_dc,
           features_rest, cmask, mean2d_tap, cameras, scaling_modifier,
           sh_degree, packed, plain):
    _check_views(cameras)
    _check_packed(packed, features if features is not None else features_dc,
                  opacities)
    if means3d.device.type != "cpu" and not plain:
        means3d, scales, rotations = (t.contiguous() for t in (
            means3d, scales, rotations))
        if opacities is not None:
            opacities = opacities.contiguous()
        if features is not None:
            features = features.contiguous()
        if mean2d_tap is not None:
            mean2d_tap = mean2d_tap.contiguous()
    out = Preprocess.apply(means3d, scales, rotations, opacities, features,
                           features_dc, features_rest, cmask, mean2d_tap,
                           tuple(cameras), float(scaling_modifier),
                           int(sh_degree), bool(packed), bool(plain))
    per = len(out) // len(cameras)
    views = [out[v * per:(v + 1) * per] for v in range(len(cameras))]
    return [(ProjectedGaussians(*x[:5]), x[5] if per > 5 else None,
             x[6] if per > 6 else None)[:3 if packed else 2] for x in views]


def preprocess_views(means3d, scales, rotations, cameras,
                     scaling_modifier: float = 1.0, opacities=None,
                     features_dc=None, features_rest=None, cmask=None,
                     sh_degree: int = 0, plain: bool = False,
                     mean2d_tap=None, packed: bool = False):
    """Project N Gaussians into each of ``cameras`` (1 to 3) and, with the
    feature leaves ``features_dc`` [N, 1, 3] and ``features_rest`` [N,
    K-1, 3], evaluate their SH colours at ``sh_degree`` on the features
    times ``cmask`` ([K], a device tensor, or None): per camera
    (:class:`ProjectedGaussians`, [N, 3] colours or None), differentiable
    in the means, scales, rotations and both leaves.  ``mean2d_tap`` ([N,
    2], or None) is added to the first camera's mean2d and takes its
    gradient.  With ``packed`` each camera's entry has a third item, its
    [N, 12] packed rows for the tiled rasterizer (``pack_features``' rows
    of the tapped mean2d, the conic, the colours and ``opacities``; None
    without features).  One kernel launch for all the views, forward and
    backward (the plain versions with ``plain``, or for CPU tensors)."""
    return _apply(means3d, scales, rotations, opacities, None, features_dc,
                  features_rest, cmask, mean2d_tap, cameras, scaling_modifier,
                  sh_degree, packed, plain)


def preprocess(means3d, scales, rotations, camera: Camera,
               scaling_modifier: float = 1.0, opacities=None, features=None,
               sh_degree: int = 0, plain: bool = False, mean2d_tap=None,
               packed: bool = False):
    """Project N Gaussians into ``camera`` and, with ``features`` [N, K, 3],
    evaluate their SH colours at ``sh_degree``:
    (:class:`ProjectedGaussians`, [N, 3] colours or None), differentiable
    in the means, scales, rotations and features (whose gradient the
    backward kernel writes as one [N, K, 3] tensor), and in ``mean2d_tap``
    as :func:`preprocess_views` takes it; with ``packed`` also the packed
    rows.  The kernels for CUDA tensors (the plain versions with
    ``plain``), the plain versions for CPU ones."""
    (out,) = _apply(means3d, scales, rotations, opacities, features, None,
                    None, None, mean2d_tap, [camera], scaling_modifier,
                    sh_degree, packed, plain)
    return out
