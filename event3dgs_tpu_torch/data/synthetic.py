"""Synthetic test scenes: a known Gaussian "world" + camera paths + GT renders.

Counterpart of ``event3dgs_tpu/data/synthetic.py``: a procedurally
generated cluster of colored Gaussians is rendered with the port's
renderer from a camera orbit to produce ground-truth intensity frames;
training then starts from a perturbed point cloud and must recover the
scene.  The points come from the same numpy RNG stream as the JAX
package's, so both packages build the same scene from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from event3dgs_tpu_torch.core.camera import Camera, make_camera, stack_cameras
from event3dgs_tpu_torch.core.sh import rgb_to_sh
from event3dgs_tpu_torch.utils.device import resolve_device


class SyntheticScene(NamedTuple):
    cameras: Camera  # batched camera [V]
    images: torch.Tensor  # [V, H, W, 3] GT renders
    points: np.ndarray  # [N, 3] init point cloud (perturbed truth)
    colors: np.ndarray  # [N, 3] init colors
    extent: float  # nerf++-style scene radius
    true_model: dict  # the generating gaussian parameters


def orbit_poses(n_views: int, radius: float = 4.0, height: float = 0.6,
                arc: float = 2.0 * np.pi) -> list[tuple[np.ndarray, np.ndarray]]:
    """(R_c2w, t_w2c) of cameras on a circular orbit looking at the origin
    (COLMAP convention: camera z towards the origin, y down)."""
    poses = []
    for i in range(n_views):
        theta = arc * i / n_views
        pos = np.array([radius * np.sin(theta), height,
                        -radius * np.cos(theta)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        r_c2w = np.stack([right, up2, fwd], axis=1)  # columns = camera axes
        # the reference stores R = R_c2w (transposed w2c rotation), t = w2c
        poses.append((r_c2w, -r_c2w.T @ pos))
    return poses


def orbit_cameras(
    n_views: int,
    radius: float = 4.0,
    height: float = 0.6,
    width: int = 128,
    img_height: int = 96,
    fov_x: float = 1.0,
    fov_y: float = 0.8,
    arc: float = 2.0 * np.pi,
    device=None,
) -> list[Camera]:
    """Cameras on a circular orbit, all looking at the origin."""
    return [make_camera(r, t, fov_x, fov_y, width, img_height, device=device)
            for r, t in orbit_poses(n_views, radius, height, arc)]


def make_synthetic_scene(
    n_gaussians: int = 120,
    n_views: int = 24,
    width: int = 128,
    height: int = 96,
    seed: int = 0,
    init_noise: float = 0.03,
    arc: float = 2.0 * np.pi,
    device=None,
    rasterizer: str = "reference",
) -> SyntheticScene:
    """Generate the scene and render its GT images on ``device`` (the card
    unless the caller asks for the CPU).  ``rasterizer="tiled"`` renders
    through the ported kernels, the default oracle as the JAX package."""
    from event3dgs_tpu_torch.ops import render

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_gaussians, 3)) * np.array([0.9, 0.6, 0.9])
    cols = rng.uniform(0.1, 1.0, size=(n_gaussians, 3))
    scales = np.exp(rng.uniform(np.log(0.04), np.log(0.14),
                                size=(n_gaussians, 1)))
    scales = np.tile(scales, (1, 3)) * rng.uniform(0.7, 1.4,
                                                   size=(n_gaussians, 3))
    quats = rng.normal(size=(n_gaussians, 4))
    opac = rng.uniform(0.55, 0.95, size=n_gaussians)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    feats = torch.zeros((n_gaussians, 16, 3), dtype=torch.float32, device=dev)
    feats[:, 0, :] = rgb_to_sh(f32(cols))
    means, scales_t, quats_t, opac_t = f32(pts), f32(scales), f32(quats), f32(opac)

    cams = orbit_cameras(n_views, width=width, img_height=height, arc=arc,
                         device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        images = torch.stack([
            render(means, feats, opac_t, scales_t, quats_t, cam, bg,
                   sh_degree=0, rasterizer=rasterizer).image
            for cam in cams
        ]).clamp(0.0, 1.0)

    centers = np.stack([c.camera_center.cpu().numpy() for c in cams])
    center = centers.mean(axis=0, keepdims=True)
    extent = float(np.max(np.linalg.norm(centers - center, axis=1)) * 1.1)

    init_pts = pts + rng.normal(size=pts.shape) * init_noise
    return SyntheticScene(
        cameras=stack_cameras(cams),
        images=images,
        points=init_pts,
        colors=cols,
        extent=extent,
        true_model=dict(means=pts, colors=cols, scales=scales, quats=quats,
                        opacities=opac),
    )
