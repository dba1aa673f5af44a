"""Camera and projection math (counterpart of ``event3dgs_tpu/core/transforms.py``).

The matrices are built once per camera, so they are computed on the host in
float64 and cast by the caller (``core/camera.py``).  Conventions are the
reference's and the JAX package's:

- ``world_to_view`` returns the W2C matrix in *row-vector* convention (the
  transpose of the usual column-vector W2C); points transform as
  ``p_hom @ M``;
- the perspective projection maps z into [0, 1] and is also returned in
  row-vector convention.
"""

from __future__ import annotations

import numpy as np
import torch


def fov2focal(fov, pixels):
    """Focal length in pixels from field-of-view (reference `graphics_utils.py:73`)."""
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal, pixels):
    """Field-of-view from focal length in pixels (reference `graphics_utils.py:76`)."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def world_to_view(R, t, translate=None, scale=1.0) -> torch.Tensor:
    """The (transposed) world-to-camera matrix, float64 on the host.

    Args:
        R: [..., 3, 3] camera rotation as stored by the scene readers
            (transposed relative to the COLMAP qvec).
        t: [..., 3] camera translation (COLMAP tvec).
        translate: optional [3] scene recentering of the camera center.
        scale: optional scalar rescaling of the camera center.

    Returns:
        [..., 4, 4] float64 tensor; ``p_hom @ M`` maps world to camera.
    """
    R = torch.as_tensor(np.asarray(R, np.float64))
    t = torch.as_tensor(np.asarray(t, np.float64))
    batch = R.shape[:-2]
    w2c = torch.zeros(batch + (4, 4), dtype=torch.float64)
    w2c[..., :3, :3] = R.transpose(-1, -2)
    w2c[..., :3, 3] = t
    w2c[..., 3, 3] = 1.0
    if translate is not None or scale != 1.0:
        shift = torch.zeros(3, dtype=torch.float64)
        if translate is not None:
            shift = torch.as_tensor(np.asarray(translate, np.float64))
        c2w = torch.linalg.inv(w2c)
        c2w[..., :3, 3] = (c2w[..., :3, 3] + shift) * scale
        w2c = torch.linalg.inv(c2w)
    return w2c.transpose(-1, -2).contiguous()


def perspective_projection(znear, zfar, fov_x, fov_y) -> torch.Tensor:
    """Perspective projection with z in [0, 1], row-vector form, float64.

    Reference `utils/graphics_utils.py:51-71`; symmetric frustum, so the
    off-center terms are zero.
    """
    tan_x = torch.as_tensor(np.tan(np.asarray(fov_x, np.float64) / 2.0))
    tan_y = torch.as_tensor(np.tan(np.asarray(fov_y, np.float64) / 2.0))
    zn, zf = float(znear), float(zfar)
    batch = torch.broadcast_shapes(tan_x.shape, tan_y.shape)
    P = torch.zeros(batch + (4, 4), dtype=torch.float64)
    P[..., 0, 0] = 1.0 / tan_x
    P[..., 1, 1] = 1.0 / tan_y
    P[..., 2, 2] = zf / (zf - zn)
    P[..., 2, 3] = -(zf * zn) / (zf - zn)
    P[..., 3, 2] = 1.0
    return P.transpose(-1, -2).contiguous()


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] scalar-first quaternions (normalized here, differentiably,
    as reference `general_utils.py:78-99`) → [..., 3, 3] rotations."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)),
        (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)),
        (2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)),
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def build_covariance(scaling, rotation, scaling_modifier=1.0):
    """[..., 3, 3] covariances Σ = (R S)(R S)ᵀ from [..., 3] activated
    scales and [..., 4] scalar-first quaternions (unnormalized ok), the
    scales times ``scaling_modifier`` (reference `general_utils.py:101-110`,
    `gaussian_model.py:27-31`)."""
    L = quat_to_rotmat(rotation) * (scaling * scaling_modifier)[..., None, :]
    return L @ L.transpose(-1, -2)


def covariance_to_symm6(cov):
    """Symmetric [..., 3, 3] → [..., 6] (xx, xy, xz, yy, yz, zz), the
    reference's `strip_symmetric` layout (`general_utils.py:64-76`)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def symm6_to_covariance(sym):
    """Inverse of :func:`covariance_to_symm6`."""
    xx, xy, xz, yy, yz, zz = sym.unbind(-1)
    rows = [torch.stack(r, dim=-1) for r in
            ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))]
    return torch.stack(rows, dim=-2)


def inverse_sigmoid(x):
    """log(x / (1-x)), the inverse of the opacity activation
    (`general_utils.py:18`); tensors stay tensors, numbers become numpy."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1.0 - x))
    x = np.asarray(x, np.float32)
    return np.log(x / (np.float32(1.0) - x))
