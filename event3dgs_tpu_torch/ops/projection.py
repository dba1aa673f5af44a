"""Gaussian preprocess: frustum culling + EWA projection to screen space.

Counterpart of ``event3dgs_tpu/ops/projection.py``: the same component-wise
math over flat [N] vectors (standard 3DGS forward conventions: local affine
Jacobian, +0.3 screen-space dilation, 3σ radius from the largest
eigenvalue), as plain tensor code on the camera's device.  This is the
plain version of the forward kernel of ``ops/preprocess.py``, which repeats
its operations in their order; the quaternion's norm is summed in index
order (:func:`row_norm`) so that the two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from event3dgs_tpu_torch.core.camera import Camera

# Culling / numeric conventions shared with the upstream kernel family.
NEAR_CULL_Z = 0.2  # view-space z below which Gaussians are culled
PROJ_EPS = 1e-7  # added to the homogeneous w before division
DILATION = 0.3  # screen-space covariance dilation (antialiasing floor)


class ProjectedGaussians(NamedTuple):
    """Screen-space per-Gaussian data (all [N] or [N, k])."""

    mean2d: torch.Tensor  # [N, 2] pixel coordinates (x, y)
    depth: torch.Tensor  # [N] view-space z (culled → +inf)
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] 3σ radius in pixels (float; 0 for culled)
    valid: torch.Tensor  # [N] bool visibility after culling


def ndc2pix(v, size):
    """NDC [-1, 1] → continuous pixel coordinate, 3DGS convention."""
    return ((v + 1.0) * size - 1.0) * 0.5


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """[N, 1] Euclidean norms of the rows of ``x`` [N, k], the squares
    summed in index order (``torch.linalg.norm`` leaves its order to the
    reduction kernel)."""
    sq = x[:, 0] * x[:, 0]
    for k in range(1, x.shape[1]):
        sq = sq + x[:, k] * x[:, k]
    return torch.sqrt(sq)[:, None]


def rotation_entries(qw, qx, qy, qz):
    """The rotation matrix of a unit quaternion as nine [N] entries, rows
    of three (reference `general_utils.py:78-99`)."""
    return (
        (1.0 - 2.0 * (qy * qy + qz * qz),
         2.0 * (qx * qy - qw * qz),
         2.0 * (qx * qz + qw * qy)),
        (2.0 * (qx * qy + qw * qz),
         1.0 - 2.0 * (qx * qx + qz * qz),
         2.0 * (qy * qz - qw * qx)),
        (2.0 * (qx * qz - qw * qy),
         2.0 * (qy * qz + qw * qx),
         1.0 - 2.0 * (qx * qx + qy * qy)),
    )


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    camera: Camera,
    scaling_modifier: float = 1.0,
    opacities: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project N Gaussians into a single camera's screen space.

    Args:
        means3d: [N, 3] world-space centers.
        scales: [N, 3] activated (positive) scales.
        rotations: [N, 4] quaternions (unnormalized ok).
        camera: a single (unbatched) :class:`Camera`.
        scaling_modifier: global scale multiplier.
        opacities: optional [N] activated opacities; Gaussians with
            opacity < 1/255 are culled (they can never pass the
            rasterizer's minimum-alpha cutoff, so this is exact).
    """
    m0, m1, m2 = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    W = camera.world_view  # (4, 4), row-vector convention
    P = camera.full_proj

    def xform(M, j):
        return m0 * M[0, j] + m1 * M[1, j] + m2 * M[2, j] + M[3, j]

    tv0, tv1 = xform(W, 0), xform(W, 1)
    tz = xform(W, 2)
    in_front = tz > NEAR_CULL_Z

    pc0, pc1, pcw = xform(P, 0), xform(P, 1), xform(P, 3)
    inv_w = 1.0 / (pcw + PROJ_EPS)
    mean2d = torch.stack(
        [ndc2pix(pc0 * inv_w, camera.width), ndc2pix(pc1 * inv_w, camera.height)],
        dim=-1,
    )

    # EWA: cov2d = (J W) Σ (J W)ᵀ with Σ = L Lᵀ, L = R·diag(s); u, v are the
    # two rows of J·W_rot, so a = |Lᵀu|², b = (Lᵀu)·(Lᵀv), c = |Lᵀv|².
    fx = camera.width / (2.0 * camera.tan_fovx)
    fy = camera.height / (2.0 * camera.tan_fovy)

    # Clamp the view-space ray to 1.3× the frustum so the affine
    # approximation stays sane for off-screen Gaussians.
    safe_tz = torch.where(in_front, tz, torch.ones_like(tz))
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    txz = torch.clamp(tv0 / safe_tz, -lim_x, lim_x) * safe_tz
    tyz = torch.clamp(tv1 / safe_tz, -lim_y, lim_y) * safe_tz

    inv_z = 1.0 / safe_tz
    inv_z2 = inv_z * inv_z
    au = fx * inv_z
    bu = -fx * txz * inv_z2
    av = fy * inv_z
    bv = -fy * tyz * inv_z2
    # row i of the world→view rotation is column i of the stored matrix
    u_ = [au * W[i, 0] + bu * W[i, 2] for i in range(3)]
    v_ = [av * W[i, 1] + bv * W[i, 2] for i in range(3)]

    qn = rotations / row_norm(rotations)
    R9 = rotation_entries(qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3])
    s_ = [scales[:, j] * scaling_modifier for j in range(3)]
    wu = [s_[j] * sum(u_[i] * R9[i][j] for i in range(3)) for j in range(3)]
    wv = [s_[j] * sum(v_[i] * R9[i][j] for i in range(3)) for j in range(3)]
    a = sum(w * w for w in wu) + DILATION
    b = sum(wu[j] * wv[j] for j in range(3))
    c = sum(w * w for w in wv) + DILATION

    det = a * c - b * b
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / safe_det, -b / safe_det, a / safe_det], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    on_screen = (
        (mean2d[:, 0] + radius > 0)
        & (mean2d[:, 0] - radius < camera.width)
        & (mean2d[:, 1] + radius > 0)
        & (mean2d[:, 1] - radius < camera.height)
    )
    valid = in_front & det_ok & on_screen
    if opacities is not None:
        valid = valid & (opacities.detach() >= 1.0 / 255.0)

    depth = torch.where(valid, tz, torch.full_like(tz, float("inf")))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius, valid=valid
    )
