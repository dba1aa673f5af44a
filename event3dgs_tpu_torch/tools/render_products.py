"""Render products: view sets, pose interpolation, blur and event
synthesis, depth and point depth, ``transforms_train.json`` (counterpart of
``event3dgs_tpu/tools/render_products.py``; reference `render.py:45-420`).

- render train/test camera sets to PNG folders;
- camera-pose interpolation (normalized-lerp on quaternions + linear
  translation, `render.py:32-44,98-106`);
- synthetic motion blur: average of ``blur_steps`` interpolated renders over
  a shutter window (`render_set_blurry:222-293`);
- event-stream synthesis: densely interpolated renders through the DVS
  simulator (`render_set_event:136-215`);
- depth and point-depth products (`render_set_depth/point`);
- `transforms_train.json` export (`render.py:110-128`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from event3dgs_tpu_torch.core.camera import Camera, make_camera
from event3dgs_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec
from event3dgs_tpu_torch.events.simulate import (
    generate_event_frames,
    save_event_result,
    simulate_event_camera,
)
from event3dgs_tpu_torch.models import activated
from event3dgs_tpu_torch.ops.preprocess import preprocess
from event3dgs_tpu_torch.ops.render import render, render_depth
from event3dgs_tpu_torch.utils.image_io import save_image


def _render_view(params, cam: Camera, sh_degree, bg, rasterizer="reference"):
    act = activated(params)
    return render(
        act.means3d, act.features, act.opacities, act.scales, act.rotations,
        cam, bg, sh_degree=sh_degree, rasterizer=rasterizer,
    ).image


def nlerp_pose(R0, t0, R1, t1, alpha: float):
    """Normalized-lerp between two camera poses (`render.py:32-44`)."""
    q0, q1 = rotmat2qvec(R0), rotmat2qvec(R1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    q = (1 - alpha) * q0 + alpha * q1
    q /= np.linalg.norm(q)
    t = (1 - alpha) * np.asarray(t0) + alpha * np.asarray(t1)
    return qvec2rotmat(q), t


def slerp_pose(R0, t0, R1, t1, alpha: float):
    """Spherical-lerp between two camera poses (reference `Slerp`,
    `render.py:37-44`), with the sign flip for quaternion double cover and
    linear translation interpolation."""
    q0, q1 = rotmat2qvec(R0), rotmat2qvec(R1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    cos_fi = np.clip(np.dot(q0, q1), -1.0, 1.0)
    fi = np.arccos(cos_fi)
    s = np.sin(fi)
    if s < 1e-6:  # nearly parallel: nlerp limit
        q = (1 - alpha) * q0 + alpha * q1
    else:
        q = np.sin(fi * (1 - alpha)) / s * q0 + np.sin(fi * alpha) / s * q1
    q /= np.linalg.norm(q)
    t = (1 - alpha) * np.asarray(t0) + alpha * np.asarray(t1)
    return qvec2rotmat(q), t


def interpolated_cameras(cam_infos, steps: int, width: int, height: int,
                         device=None):
    """Camera chain with ``steps`` in-between poses per source interval."""
    cams, tags = [], []
    for i in range(len(cam_infos) - 1):
        a, b = cam_infos[i], cam_infos[i + 1]
        for s in range(steps):
            alpha = s / steps
            R, t = nlerp_pose(a.R, a.T, b.R, b.T, alpha)
            cams.append(make_camera(R, t, a.fov_x, a.fov_y, width, height,
                                    device=device))
            tags.append((i, s))
    last = cam_infos[-1]
    cams.append(make_camera(last.R, last.T, last.fov_x, last.fov_y, width,
                            height, device=device))
    tags.append((len(cam_infos) - 1, 0))
    return cams, tags


@torch.no_grad()
def render_set(params, cameras: Camera, out_dir: str, sh_degree=3, bg=None,
               gt_images=None, rasterizer="reference"):
    """Render a camera batch to ``renders/`` (+ ``gt/``), the reference's
    ``render_set`` layout."""
    if bg is None:
        bg = torch.zeros(3, device=params.device)
    rdir = os.path.join(out_dir, "renders")
    os.makedirs(rdir, exist_ok=True)
    n = cameras.batch_shape[0]
    for i in range(n):
        img = _render_view(params, cameras[i], sh_degree, bg, rasterizer)
        save_image(os.path.join(rdir, f"{i:05d}.png"),
                   np.clip(img.cpu().numpy(), 0, 1))
    if gt_images is not None:
        gdir = os.path.join(out_dir, "gt")
        os.makedirs(gdir, exist_ok=True)
        for i in range(n):
            save_image(os.path.join(gdir, f"{i:05d}.png"),
                       np.asarray(gt_images[i]))


@torch.no_grad()
def render_depth_set(params, cameras: Camera, out_dir: str, bg=None,
                     rasterizer="reference"):
    """Depth maps scaled by /10 like the reference PNGs
    (`render_set_depth:322-342`), as ``depth_%05d.png``."""
    if bg is None:
        bg = torch.zeros(3, device=params.device)
    os.makedirs(out_dir, exist_ok=True)
    act = activated(params)
    for i in range(cameras.batch_shape[0]):
        out = render_depth(act.means3d, act.opacities, act.scales,
                           act.rotations, cameras[i], bg, rasterizer=rasterizer)
        save_image(os.path.join(out_dir, f"depth_{i:05d}.png"),
                   np.clip(out.image[..., 0].cpu().numpy() / 10.0, 0, 1))


@torch.no_grad()
def point_depth_map(params, cam: Camera, opacity_threshold=0.8) -> torch.Tensor:
    """Min-splat z-buffer of high-opacity Gaussian centers
    (`render_point`/`generate_depth_map`, `gaussian_renderer/__init__.py:
    194-378`): [H, W] camera distances, ``inf`` where no center lands.

    A scatter-min over the flat pixel index; the minimum does not depend on
    the order of the writes, so the map is the same on every run.  Pixel
    coordinates are truncated towards zero and clipped to the image, as the
    JAX package's ``astype(int32)`` then ``clip`` does (clipping first keeps
    the cast defined for coordinates outside the int range).
    """
    act = activated(params)
    proj, _ = preprocess(act.means3d, act.scales, act.rotations, cam,
                         opacities=act.opacities)
    keep = proj.valid & (act.opacities > opacity_threshold)
    dist = torch.linalg.norm(act.means3d - cam.camera_center[None], dim=-1)
    xi = torch.clamp(proj.mean2d[:, 0], 0, cam.width - 1).to(torch.int64)
    yi = torch.clamp(proj.mean2d[:, 1], 0, cam.height - 1).to(torch.int64)
    n_pix = cam.width * cam.height
    flat_idx = torch.where(keep, yi * cam.width + xi, n_pix)
    depth = torch.full((n_pix + 1,), torch.inf, device=dist.device)
    depth.scatter_reduce_(0, flat_idx, torch.where(keep, dist, torch.inf),
                          "amin")
    return depth[:-1].reshape(cam.height, cam.width)


@torch.no_grad()
def render_blurry_set(params, cam_infos, out_dir: str, width, height,
                      sh_degree=3, blur_steps: int = 18,
                      shutter_fraction: float = 0.5, bg=None,
                      rasterizer="reference"):
    """Synthetic motion blur: mean of interpolated renders over a shutter
    window (`render_set_blurry:222-293`, 18 steps), as
    ``blurry_%05d.png``."""
    dev = params.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(cam_infos) - 1):
        a, b = cam_infos[i], cam_infos[i + 1]
        acc = None
        for s in range(blur_steps):
            alpha = shutter_fraction * s / blur_steps
            R, t = nlerp_pose(a.R, a.T, b.R, b.T, alpha)
            cam = make_camera(R, t, a.fov_x, a.fov_y, width, height, device=dev)
            img = _render_view(params, cam, sh_degree, bg, rasterizer)
            acc = img if acc is None else acc + img
        save_image(os.path.join(out_dir, f"blurry_{i:05d}.png"),
                   np.clip((acc / blur_steps).cpu().numpy(), 0, 1))


@torch.no_grad()
def render_event_set(params, cam_infos, out_dir: str, width, height,
                     sh_degree=3, interpolation: int = 3, dt: float = 1000.0,
                     dvs_params=None, bg=None, rasterizer="reference"):
    """Event synthesis: interpolated render chain → DVS sim → ``raw.dat`` +
    event frames (`render_set_event:136-215`).

    The chain renders on the model's device and each frame comes to the
    host once, for its ``render_%05d.png`` and the DVS simulator (numpy, on
    the host, as in the JAX package); the ``frames/`` accumulation images
    are built on the model's device.  Returns the event buffer."""
    dev = params.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    os.makedirs(out_dir, exist_ok=True)
    cams, _ = interpolated_cameras(cam_infos, interpolation, width, height,
                                   device=dev)
    frames = []
    for i, cam in enumerate(cams):
        img = np.clip(
            _render_view(params, cam, sh_degree, bg, rasterizer).cpu().numpy(),
            0, 1)
        frames.append(img)
        save_image(os.path.join(out_dir, f"render_{i:05d}.png"), img)
    buf = simulate_event_camera(frames, dt=dt, params=dvs_params)
    save_event_result(buf, out_dir, width=width, height=height)
    generate_event_frames(
        buf, width, height, int(dt * interpolation),
        out_dir=os.path.join(out_dir, "frames"), device=dev,
    )
    return buf


def export_transforms_json(cam_infos, out_path: str):
    """``transforms_train.json`` export (`render.py:110-128`)."""
    frames = []
    for i, ci in enumerate(cam_infos):
        w2c = np.eye(4)
        w2c[:3, :3] = ci.R.T
        w2c[:3, 3] = ci.T
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1  # COLMAP → OpenGL axes
        frames.append(
            {"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()}
        )
    payload = {"camera_angle_x": cam_infos[0].fov_x, "frames": frames}
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
