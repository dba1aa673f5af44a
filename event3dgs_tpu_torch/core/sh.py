"""Real spherical harmonics, degrees 0-4 (counterpart of ``event3dgs_tpu/core/sh.py``).

Standard real-SH normalization constants (identical to PlenOctree / 3DGS;
reference `utils/sh_utils.py:26-54`), sign conventions as in the reference
(the degree-1 terms are (-y, +z, -x)).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions: [..., 3] → [..., (deg+1)**2]."""
    if not (0 <= deg <= 4):
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    basis = [torch.full(dirs.shape[:-1], SH_C0, dtype=dirs.dtype,
                        device=dirs.device)]
    if deg >= 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if deg >= 3:
        basis += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if deg >= 4:
        basis += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(basis, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Contract SH coefficients against the basis at unit directions.

    Args:
        deg: degree in [0, 4].
        sh: [..., C, K] coefficients with K >= (deg+1)**2 (channel-major).
        dirs: [..., 3] unit directions.

    Returns:
        [..., C] colors (before the +0.5 shift and clamp of the renderer).
    """
    ncoef = (deg + 1) ** 2
    basis = sh_basis(deg, dirs)
    return (sh[..., :ncoef] * basis[..., None, :]).sum(dim=-1)


def rgb_to_sh(rgb):
    """Mean color → degree-0 SH coefficient (`sh_utils.py:114`)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    """Inverse of :func:`rgb_to_sh` (`sh_utils.py:117`)."""
    return sh * SH_C0 + 0.5
