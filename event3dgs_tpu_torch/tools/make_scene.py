"""Synthesize a `train_colmap_easy`-style COLMAP scene on disk.

Counterpart of ``event3dgs_tpu/tools/make_scene.py``: a known Gaussian
world rendered with the port's renderer along a camera orbit, written out
with the reference's 4-folder dataset contract
(`scene/dataset_readers.py:134-227`):

    <out>/
      sparse/0/{cameras.bin, images.bin, points3D.bin, points3D.ply}
      images/        train intensity frames (gray loss GT)
      images_event/  event-timed intensity frames (event-pair loss GT)
      renders/       held-out ground truth (eval protocol, `eval.py:118-152`)

All folders share the COLMAP poses; the init point cloud is the true
point set perturbed by `init_noise`.  The numpy RNG stream is the JAX
package's, so both packages write the same scene from the same seed.
Usage:

    python -m event3dgs_tpu_torch.tools.make_scene -o /tmp/train_colmap_easy \\
        --views 100 --width 400 --height 400 --gaussians 400 [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from event3dgs_tpu_torch.data.colmap import (
    ColmapCamera,
    ColmapImage,
    rotmat2qvec,
    write_model,
)
from event3dgs_tpu_torch.data.ply import store_point_cloud
from event3dgs_tpu_torch.utils.image_io import save_image


def synthesize_scene(
    out_dir: str,
    n_views: int = 100,
    width: int = 400,
    height: int = 400,
    n_gaussians: int = 400,
    seed: int = 0,
    init_noise: float = 0.05,
    arc: float = 2.0 * np.pi,
    white_background: bool = False,
    blur_steps: int = 0,
    scale_min: float = 0.04,
    scale_max: float = 0.14,
    rasterizer: str = "reference",
    init_fraction: float = 1.0,
    device=None,
) -> dict:
    """Write the scene under ``out_dir``, rendering on ``device`` (the card
    unless the caller asks for the CPU).  Returns its size and the true
    model."""
    from event3dgs_tpu_torch.core.camera import make_camera
    from event3dgs_tpu_torch.core.sh import rgb_to_sh
    from event3dgs_tpu_torch.core.transforms import fov2focal
    from event3dgs_tpu_torch.data.synthetic import orbit_poses
    from event3dgs_tpu_torch.ops import render
    from event3dgs_tpu_torch.tools.render_products import slerp_pose
    from event3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_gaussians, 3)) * np.array([0.9, 0.6, 0.9])
    cols = rng.uniform(0.1, 1.0, size=(n_gaussians, 3))
    # Splat size statistics: see the JAX tool's note on the reference's
    # 20 px screen-size prune (photographic statistics for long schedules:
    # --gaussians 6000 --scale_min 0.004 --scale_max 0.015).
    scales = np.exp(rng.uniform(np.log(scale_min), np.log(scale_max),
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

    fov_x, fov_y = 1.0, 1.0 if width == height else 0.8
    poses = orbit_poses(n_views, 4.0, 0.6, arc)  # (R_c2w, t_w2c)

    for sub in ("sparse/0", "images", "images_event", "renders",
                "images_blurry"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    # a white background keeps the event loss's log-intensity differences
    # bounded (a black one makes log(I+eps) singular at silhouettes)
    bg = (torch.ones if white_background else torch.zeros)(3, device=dev)

    @torch.no_grad()
    def render_pose(r, t):
        cam = make_camera(r, t, fov_x, fov_y, width, height, device=dev)
        img = render(means, feats, opac_t, scales_t, quats_t, cam, bg,
                     sh_degree=0, rasterizer=rasterizer).image
        return np.clip(img.cpu().numpy(), 0.0, 1.0)

    rendered = []
    for i, (r, t) in enumerate(poses):
        img = render_pose(r, t)
        rendered.append(img)
        name = f"r_{i:05d}.png"
        for folder in ("images", "images_event", "renders"):
            save_image(os.path.join(out_dir, folder, name), img)

    # blurry captures for the deblur mode: the mean of interpolated-pose
    # renders over the shutter (off by default; --blur_steps 6 when the
    # deblur recipe needs the folder)
    for i in range(n_views if blur_steps > 0 else 0):
        r0, t0 = poses[i]
        r1, t1 = poses[(i + 1) % n_views]
        acc = np.zeros_like(rendered[0])
        for s in range(blur_steps):
            acc += render_pose(*slerp_pose(r0, t0, r1, t1, s / blur_steps))
        save_image(os.path.join(out_dir, "images_blurry", f"r_{i:05d}.png"),
                   acc / blur_steps)

    # COLMAP model: shared PINHOLE intrinsics, per-view extrinsics; the
    # loader stores R = qvec2rotmat(qvec).T, so qvec encodes R_c2w.T
    colmap_cams = {
        1: ColmapCamera(
            id=1, model="PINHOLE", width=width, height=height,
            params=np.array([fov2focal(fov_x, width), fov2focal(fov_y, height),
                             width / 2.0, height / 2.0]),
        )
    }
    colmap_images = {
        i + 1: ColmapImage(id=i + 1, qvec=rotmat2qvec(r_c2w.T), tvec=tvec,
                           camera_id=1, name=f"r_{i:05d}.png")
        for i, (r_c2w, tvec) in enumerate(poses)
    }

    sparse = os.path.join(out_dir, "sparse", "0")
    init_pts = pts + rng.normal(size=pts.shape) * init_noise
    init_rgb = np.clip(cols * 255.0, 0, 255)
    if init_fraction < 1.0:
        # sparse initialization (densification stress): keep a random
        # fraction of the true points
        keep = rng.choice(n_gaussians,
                          size=max(int(round(n_gaussians * init_fraction)), 1),
                          replace=False)
        init_pts, init_rgb = init_pts[keep], init_rgb[keep]
    write_model(colmap_cams, colmap_images, (init_pts, init_rgb), sparse)
    store_point_cloud(os.path.join(sparse, "points3D.ply"), init_pts, init_rgb)
    return dict(
        n_views=n_views, width=width, height=height, n_gaussians=n_gaussians,
        true_model=dict(means=pts, colors=cols, scales=scales, quats=quats,
                        opacities=opac),
    )


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Synthesize a train_colmap_easy-style COLMAP scene")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--views", type=int, default=100)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--gaussians", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_noise", type=float, default=0.05)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--blur_steps", type=int, default=0)
    p.add_argument("--scale_min", type=float, default=0.04)
    p.add_argument("--scale_max", type=float, default=0.14)
    p.add_argument("--arc", type=float, default=2.0 * np.pi)
    p.add_argument("--init_fraction", type=float, default=1.0,
                   help="fraction of true points kept in the init cloud "
                        "(sparse-init densification stress)")
    p.add_argument("--rasterizer", type=str, default="reference",
                   choices=["reference", "tiled"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    meta = synthesize_scene(
        args.output, args.views, args.width, args.height, args.gaussians,
        args.seed, args.init_noise, arc=args.arc,
        white_background=args.white_background, blur_steps=args.blur_steps,
        scale_min=args.scale_min, scale_max=args.scale_max,
        rasterizer=args.rasterizer, init_fraction=args.init_fraction,
        device=args.device,
    )
    print(f"wrote {meta['n_views']}-view scene to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
