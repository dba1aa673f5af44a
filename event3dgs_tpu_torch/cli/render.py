"""Render entry point (counterpart of ``event3dgs_tpu/cli/render.py``).

    python -m event3dgs_tpu_torch.cli.render -m <model_path> [--skip_train]
        [--skip_test] [--depth] [--point] [--blurrySpeed K]
        [--event --interpolationN 3 --dt 1000] [--export_transforms]
        [--iteration N] [--rasterizer tiled|reference] [--device cuda|cpu]

Renders the train and test camera sets of a trained model to
``<model>/{train,test}/ours_<iteration>/{renders,gt}/``, and on request the
train set's depth maps (``depth/``), point-depth maps (``point/``),
motion-blurred frames (``blurry/``, when ``--blurrySpeed`` > 0), its
synthesized event stream (``event/``: the ``--interpolationN`` chain's
``render_*.png``, ``raw.dat`` from the DVS simulator at ``--dt`` µs per
frame, and the accumulation ``frames/``) and
``<model>/transforms_train.json``.  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from event3dgs_tpu_torch.cli.common import load_trained_model
from event3dgs_tpu_torch.data.scene import (
    build_camera_batch,
    detect_scene_type,
    load_images_array,
    read_blender_scene,
    read_colmap_scene,
    resolve_resolution,
)
from event3dgs_tpu_torch.tools.render_products import (
    export_transforms_json,
    point_depth_map,
    render_blurry_set,
    render_depth_set,
    render_event_set,
    render_set,
)
from event3dgs_tpu_torch.utils.device import resolve_device
from event3dgs_tpu_torch.utils.image_io import save_image


def build_parser():
    p = argparse.ArgumentParser(description="Render a trained model")
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--depth", action="store_true")
    p.add_argument("--point", action="store_true")
    p.add_argument("--event", action="store_true")
    p.add_argument("--blurrySpeed", type=int, default=0)
    p.add_argument("--interpolationN", type=int, default=3)
    p.add_argument("--dt", type=float, default=1000.0)
    p.add_argument("--export_transforms", action="store_true")
    p.add_argument(
        "--rasterizer", type=str, default="tiled",
        choices=["tiled", "reference"],
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def point_depth_image(d: np.ndarray) -> np.ndarray:
    """A point-depth map as a PNG image: empty pixels take the farthest
    depth, depths normalised to [0, 1] and inverted (near is bright)."""
    finite = np.isfinite(d)
    if finite.any():
        d = np.where(finite, d, d[finite].max())
        d = (d - d.min()) / max(d.max() - d.min(), 1e-9)
    else:
        d = np.zeros_like(d)
    return 1.0 - d


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, it, params = load_trained_model(args.model_path, args.iteration,
                                         device)
    m = cfg.model
    print(f"Rendering {args.model_path} @ iteration {it} "
          f"({int(params.alive.sum())} gaussians) on {device}")

    if detect_scene_type(m.source_path) == "colmap":
        info = read_colmap_scene(m.source_path, images_dir=m.images,
                                 gray=m.gray, deblur=m.deblur, event=m.event)
    else:
        info = read_blender_scene(m.source_path, m.white_background)

    bg = (torch.ones if m.white_background else torch.zeros)(3, device=device)
    base = os.path.join(args.model_path, "train", f"ours_{it}")
    w, h = resolve_resolution(
        info.train_cameras[0].width, info.train_cameras[0].height, m.resolution
    )
    sets = []
    if not args.skip_train:
        sets.append(("train", info.train_cameras))
    if not args.skip_test and info.test_cameras:
        sets.append(("test", info.test_cameras))
    for name, cam_infos in sets:
        cams = build_camera_batch(cam_infos, m.resolution, device=device)
        gt = load_images_array(cam_infos, m.resolution, m.white_background)
        out = os.path.join(args.model_path, name, f"ours_{it}")
        render_set(params, cams, out, m.sh_degree, bg, gt,
                   rasterizer=args.rasterizer)
        print(f"wrote {out}/renders")
    if args.depth or args.point:
        train_cams = build_camera_batch(info.train_cameras, m.resolution,
                                        device=device)
    if args.depth:
        render_depth_set(params, train_cams, os.path.join(base, "depth"), bg,
                         rasterizer=args.rasterizer)
        print("wrote depth maps")
    if args.point:
        pdir = os.path.join(base, "point")
        os.makedirs(pdir, exist_ok=True)
        for i in range(train_cams.batch_shape[0]):
            d = point_depth_map(params, train_cams[i]).cpu().numpy()
            save_image(os.path.join(pdir, f"point_{i:05d}.png"),
                       point_depth_image(d))
        print("wrote point-depth maps")
    if args.blurrySpeed > 0:
        render_blurry_set(
            params, info.train_cameras, os.path.join(base, "blurry"),
            w, h, m.sh_degree, bg=bg, rasterizer=args.rasterizer,
        )
        print("wrote blurry set")
    if args.event:
        render_event_set(
            params, info.train_cameras, os.path.join(base, "event"),
            w, h, m.sh_degree, interpolation=args.interpolationN,
            dt=args.dt, bg=bg, rasterizer=args.rasterizer,
        )
        print("wrote event synthesis")
    if args.export_transforms:
        export_transforms_json(
            info.train_cameras,
            os.path.join(args.model_path, "transforms_train.json"),
        )
        print("wrote transforms_train.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
