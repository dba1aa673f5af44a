"""The per-Gaussian preprocess of a render: projection and SH colours,
forward and backward, as two CUDA kernels (``csrc/preprocess.cu``).

The JAX package has no Pallas kernel here: ``project_gaussians``
(``event3dgs_tpu/ops/projection.py``) and ``gaussian_colors``
(``event3dgs_tpu/ops/render.py``) are elementwise code that XLA fuses, and
autodiff takes their gradients.  In plain PyTorch the same work is some 800
launches a render and direction, so the port runs it as one forward and one
backward kernel, the upstream CUDA rasterizer's ``preprocessCUDA`` /
``BACKWARD::preprocess`` pair.

- :func:`preprocess_forward_plain` is the plain forward: the port's
  :func:`~event3dgs_tpu_torch.ops.projection.project_gaussians` and
  :func:`~event3dgs_tpu_torch.ops.render.gaussian_colors`.  The forward
  kernel repeats their operations in their order, so on the card it equals
  them bit for bit.
- :func:`preprocess_backward_plain` is the analytic backward in plain
  tensor code, the backward kernel's formulas line for line.  A Gaussian
  that is not ``valid`` gets a zero gradient (the rasterizers give it
  none; autograd of the plain forward can give 0·inf = NaN there).
- :class:`Preprocess` is the ``torch.autograd.Function`` around them and
  :func:`preprocess` its entry: CPU tensors take the plain versions, CUDA
  tensors the kernels, or the plain versions with ``plain=True``.  On CUDA
  a failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

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

MAX_COEFFS = 25  # SH degree 4: the kernels' widest feature row


def preprocess_forward_plain(means3d, scales, rotations, camera: Camera,
                             scaling_modifier: float = 1.0, opacities=None,
                             features=None, sh_degree: int = 0):
    """Plain PyTorch version of the forward kernel:
    (:class:`ProjectedGaussians`, [N, 3] colours or None without
    ``features``)."""
    from event3dgs_tpu_torch.ops.render import gaussian_colors

    proj = project_gaussians(means3d, scales, rotations, camera,
                             scaling_modifier=scaling_modifier,
                             opacities=opacities)
    colors = None if features is None else gaussian_colors(
        sh_degree, features, means3d, camera.camera_center)
    return proj, colors


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


def preprocess_backward_plain(means3d, scales, rotations, camera: Camera,
                              valid, g_mean2d=None, g_conic=None,
                              g_colors=None, scaling_modifier: float = 1.0,
                              features=None, sh_degree: int = 0):
    """Plain PyTorch version of the backward kernel: from the gradients of
    mean2d [N, 2], conic [N, 3] and colours [N, 3] (None: zero), the
    gradients of the means [N, 3], scales [N, 3], quaternions [N, 4] and
    features ([N, K, 3], or None without ``features``); zero where
    ``valid`` [N] is False.  The forward's intermediates are recomputed."""
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


def _check_camera(camera: Camera):
    """The camera's fields as the kernels read them: float32 CUDA tensors
    (world_view and full_proj [4, 4], camera_center [3], the tangents
    0-dimensional), contiguous."""
    for f, shape in (("world_view", (4, 4)), ("full_proj", (4, 4)),
                     ("camera_center", (3,)), ("tan_fovx", ()),
                     ("tan_fovy", ())):
        kernels.check(getattr(camera, f), torch.float32, f"camera.{f}", shape)
    return (camera.world_view.data_ptr(), camera.full_proj.data_ptr(),
            camera.camera_center.data_ptr(), camera.tan_fovx.data_ptr(),
            camera.tan_fovy.data_ptr())


def _check_features(features, n: int, sh_degree: int) -> int:
    """K of [N, K, 3] features that a kernel of degree ``sh_degree`` reads."""
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    kernels.check(features, torch.float32, "features")
    k = features.shape[1] if features.dim() == 3 else 0
    if features.shape != (n, k, 3) or not (
            (sh_degree + 1) ** 2 <= k <= MAX_COEFFS):
        raise ValueError(f"features: expected [{n}, K, 3] with "
                         f"{(sh_degree + 1) ** 2} <= K <= {MAX_COEFFS}, got "
                         f"{tuple(features.shape)}")
    return k


def preprocess_forward_kernel(means3d, scales, rotations, camera: Camera,
                              scaling_modifier: float = 1.0, opacities=None,
                              features=None, sh_degree: int = 0):
    """Launch the forward kernel (``csrc/preprocess.cu``) on CUDA tensors."""
    n = means3d.shape[0]
    kernels.check(means3d, torch.float32, "means3d", (n, 3))
    kernels.check(scales, torch.float32, "scales", (n, 3))
    kernels.check(rotations, torch.float32, "rotations", (n, 4))
    if opacities is not None:
        kernels.check(opacities, torch.float32, "opacities", (n,))
    k = 0 if features is None else _check_features(features, n, sh_degree)
    cam = _check_camera(camera)
    dev = means3d.device
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device=dev)
    proj = ProjectedGaussians(mean2d=empty(n, 2), depth=empty(n),
                              conic=empty(n, 3), radius=empty(n),
                              valid=empty(n, dtype=torch.bool))
    colors = None if features is None else empty(n, 3)
    ptr = lambda t: None if t is None else t.data_ptr()
    kernels.launch(
        "preprocess", "e3d_preprocess_forward",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        ptr(opacities), ptr(features), k,
        -1 if features is None else sh_degree, *cam, n, camera.width,
        camera.height, float(scaling_modifier), *(t.data_ptr() for t in proj),
        ptr(colors),
    )
    preprocess_forward_kernel.launches += 1
    return proj, colors


preprocess_forward_kernel.launches = 0


def _grad_rows(g, n: int, width: int, what: str):
    """(pointer, row stride) of an [N, width] gradient whose rows may be
    strided (slices of the rasterizer's [N, 9] sums); (None, 0) for None."""
    if g is None:
        return None, 0
    if g.device.type != "cuda" or g.dtype != torch.float32:
        raise ValueError(f"{what}: expected a float32 CUDA tensor, got "
                         f"{g.dtype} on {g.device}")
    if tuple(g.shape) != (n, width):
        raise ValueError(f"{what}: expected shape {(n, width)}, got "
                         f"{tuple(g.shape)}")
    if g.stride(1) != 1 or (n > 1 and g.stride(0) < width):
        g = g.contiguous()
    return g.data_ptr(), max(g.stride(0), width)


def preprocess_backward_kernel(means3d, scales, rotations, camera: Camera,
                               valid, g_mean2d=None, g_conic=None,
                               g_colors=None, scaling_modifier: float = 1.0,
                               features=None, sh_degree: int = 0):
    """Launch the backward kernel (``csrc/preprocess.cu``) on CUDA
    tensors."""
    n = means3d.shape[0]
    kernels.check(means3d, torch.float32, "means3d", (n, 3))
    kernels.check(scales, torch.float32, "scales", (n, 3))
    kernels.check(rotations, torch.float32, "rotations", (n, 4))
    kernels.check(valid, torch.bool, "valid", (n,))
    k = 0 if features is None else _check_features(features, n, sh_degree)
    cam = _check_camera(camera)
    rows = [_grad_rows(g, n, w, what) for g, w, what in (
        (g_mean2d, 2, "g_mean2d"), (g_conic, 3, "g_conic"),
        (g_colors if features is not None else None, 3, "g_colors"))]
    dev = means3d.device
    g_means = torch.empty(n, 3, device=dev)
    g_scales = torch.empty(n, 3, device=dev)
    g_rotations = torch.empty(n, 4, device=dev)
    g_features = None if features is None else torch.empty_like(features)
    kernels.launch(
        "preprocess", "e3d_preprocess_backward",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        valid.data_ptr(), None if features is None else features.data_ptr(),
        k, -1 if features is None else sh_degree, *cam, n, camera.width,
        camera.height, float(scaling_modifier),
        *(x for r in rows for x in r), g_means.data_ptr(),
        g_scales.data_ptr(), g_rotations.data_ptr(),
        None if g_features is None else g_features.data_ptr(),
    )
    preprocess_backward_kernel.launches += 1
    return g_means, g_scales, g_rotations, g_features


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
    """Projection and SH colours, forward and backward.

    ``forward(means3d, scales, rotations, opacities, features, camera,
    scaling_modifier, sh_degree, plain)`` → (mean2d, depth, conic, radius,
    valid[, colours]); gradients flow to the means, scales, rotations and
    features, none to the opacities, depth, radius and valid.
    """

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, features, camera,
                scaling_modifier, sh_degree, plain):
        fwd = preprocess_forward_plain if plain else preprocess_forward
        proj, colors = fwd(means3d, scales, rotations, camera,
                           scaling_modifier, opacities, features, sh_degree)
        ctx.mark_non_differentiable(proj.depth, proj.radius, proj.valid)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, rotations, features,
                              proj.valid)
        ctx.camera, ctx.plain = camera, plain
        ctx.scaling_modifier, ctx.sh_degree = scaling_modifier, sh_degree
        return tuple(proj) if colors is None else (*proj, colors)

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, g_radius, g_valid,
                 g_colors=None):
        means3d, scales, rotations, features, valid = ctx.saved_tensors
        bwd = preprocess_backward_plain if ctx.plain else preprocess_backward
        g_means, g_scales, g_rotations, g_features = bwd(
            means3d, scales, rotations, ctx.camera, valid, g_mean2d, g_conic,
            g_colors, ctx.scaling_modifier, features, ctx.sh_degree)
        return (g_means, g_scales, g_rotations, None, g_features, None, None,
                None, None)


def preprocess(means3d, scales, rotations, camera: Camera,
               scaling_modifier: float = 1.0, opacities=None, features=None,
               sh_degree: int = 0, plain: bool = False):
    """Project N Gaussians into ``camera`` and, with ``features`` [N, K, 3],
    evaluate their SH colours at ``sh_degree``:
    (:class:`ProjectedGaussians`, [N, 3] colours or None), differentiable
    in the means, scales, rotations and features.  The kernels for CUDA
    tensors (the plain versions with ``plain``), the plain versions for CPU
    ones."""
    if means3d.device.type != "cpu" and not plain:
        means3d, scales, rotations = (t.contiguous() for t in (
            means3d, scales, rotations))
        if opacities is not None:
            opacities = opacities.contiguous()
        if features is not None:
            features = features.contiguous()
    out = Preprocess.apply(means3d, scales, rotations, opacities, features,
                           camera, float(scaling_modifier), int(sh_degree),
                           bool(plain))
    return ProjectedGaussians(*out[:5]), (out[5] if len(out) > 5 else None)
