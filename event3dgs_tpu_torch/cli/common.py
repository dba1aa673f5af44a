"""Shared CLI plumbing: argument parsing and scene/state assembly
(counterpart of ``event3dgs_tpu/cli/common.py``).

The flags and their defaults are the JAX package's, so a command line and
the ``cfg.json`` it writes work with either package; ``--device`` is the
port's own (``cuda`` by default, ``cpu`` for the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from event3dgs_tpu_torch.data.ply import load_gaussian_ply
from event3dgs_tpu_torch.data.scene import (
    build_camera_batch,
    camera_to_json,
    detect_scene_type,
    load_images_array,
    read_blender_scene,
    read_colmap_scene,
)
from event3dgs_tpu_torch.losses.event import raw_contrast_init
from event3dgs_tpu_torch.models.gaussians import init_from_point_cloud
from event3dgs_tpu_torch.train.checkpoint import find_max_iteration
from event3dgs_tpu_torch.train.state import SceneData, init_train_state
from event3dgs_tpu_torch.utils.config import (
    EventConfig,
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    TrainConfig,
)


def add_model_args(p: argparse.ArgumentParser):
    """Reference `ModelParams` flags (`arguments/__init__.py:47-61`)."""
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--gray", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--event", action="store_true")
    p.add_argument("--deblur", action="store_true")
    p.add_argument("--capacity", type=int, default=0)


def add_pipeline_args(p: argparse.ArgumentParser):
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--rasterizer", type=str, default="tiled",
                   choices=["tiled", "reference"])
    p.add_argument("--gauss_mode", type=str, default="exact",
                   choices=["exact", "partials"],
                   help="gauss-axis compositing strategy of the multi-GPU "
                        "loop: exact (projected-splat exchange) or partials "
                        "(depth-ordered merge of per-shard images, "
                        "approximate on orbit rigs)")
    p.add_argument("--fused_steps", type=int, default=1,
                   help="steps per chunk between host events (log, "
                        "densify, save, test): on a CUDA card a chunk "
                        "replays a CUDA graph of the step once per step; 1 "
                        "runs one eager step per iteration")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")


def add_optimization_args(p: argparse.ArgumentParser):
    """Reference `OptimizationParams` flags (`arguments/__init__.py:75-94`)."""
    d = OptimizationConfig()
    for f in (
        "iterations position_lr_init position_lr_final position_lr_delay_mult "
        "position_lr_max_steps feature_lr opacity_lr scaling_lr rotation_lr "
        "percent_dense lambda_dssim densification_interval "
        "opacity_reset_interval densify_from_iter densify_until_iter "
        "densify_grad_threshold"
    ).split():
        default = getattr(d, f)
        p.add_argument(f"--{f}", type=type(default), default=default)
    p.add_argument("--random_background", action="store_true")


def add_event_args(p: argparse.ArgumentParser):
    """Event-mode knobs the reference hardcodes."""
    d = EventConfig()
    for f in (
        "contrast_init contrast_lr gt_contrast event_weight blur_alpha "
        "event_lambda_dssim"
    ).split():
        p.add_argument(f"--{f}", type=float, default=getattr(d, f))
    p.add_argument("--event_opacity_reset_interval", type=int,
                   default=d.opacity_reset_interval)
    p.add_argument("--contrast_parameterization", choices=("identity", "softplus"),
                   default=d.contrast_parameterization)


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(
            sh_degree=args.sh_degree,
            source_path=os.path.abspath(args.source_path) if args.source_path else "",
            model_path=args.model_path,
            images=args.images,
            resolution=args.resolution,
            white_background=args.white_background,
            eval=args.eval,
            gray=args.gray,
            random=args.random,
            event=args.event,
            deblur=args.deblur,
            capacity=args.capacity,
        ),
        pipeline=PipelineConfig(
            rasterizer=args.rasterizer,
            gauss_mode=args.gauss_mode,
            fused_steps=args.fused_steps,
        ),
        optimization=OptimizationConfig(**{
            f: getattr(args, f) for f in OptimizationConfig.__dataclass_fields__
            if hasattr(args, f)
        }),
        event=EventConfig(
            contrast_init=args.contrast_init,
            contrast_lr=args.contrast_lr,
            gt_contrast=args.gt_contrast,
            event_weight=args.event_weight,
            blur_alpha=args.blur_alpha,
            event_lambda_dssim=args.event_lambda_dssim,
            opacity_reset_interval=args.event_opacity_reset_interval,
            contrast_parameterization=args.contrast_parameterization,
        ),
    )


def mode_from_config(cfg: TrainConfig) -> str:
    m = cfg.model
    if m.event and m.deblur:
        return "event_deblur"
    if m.event:
        return "event"
    if m.gray:
        return "gray"
    return "rgb"


def load_scene_and_state(cfg: TrainConfig, device: torch.device):
    """Scene dir → (SceneInfo, SceneData, TrainState, extent), the data
    and state on ``device``."""
    m = cfg.model
    if detect_scene_type(m.source_path) == "colmap":
        info = read_colmap_scene(m.source_path, images_dir=m.images,
                                 gray=m.gray, deblur=m.deblur, event=m.event)
    else:
        info = read_blender_scene(m.source_path, m.white_background)

    def cams(infos):
        return build_camera_batch(infos, m.resolution, device=device)

    def images(infos):
        arr = load_images_array(infos, m.resolution, m.white_background)
        return torch.tensor(arr, dtype=torch.float32, device=device)

    data = SceneData(
        cameras=cams(info.train_cameras),
        images=images(info.train_cameras),
        event_cameras=cams(info.event_cameras) if info.event_cameras else None,
        event_images=images(info.event_cameras) if info.event_cameras else None,
        blurry_images=(images(info.blurry_cameras) if info.blurry_cameras
                       else None),
        test_cameras=cams(info.test_cameras) if info.test_cameras else None,
        test_images=images(info.test_cameras) if info.test_cameras else None,
    )

    pcd = info.point_cloud
    n_pts = len(pcd.points)
    capacity = m.capacity or max(1 << max(n_pts * 4 - 1, 1).bit_length(), 1 << 14)
    params = init_from_point_cloud(np.asarray(pcd.points), np.asarray(pcd.colors),
                                   capacity, max_sh_degree=m.sh_degree,
                                   device=device)
    state = init_train_state(
        params, spatial_lr_scale=info.radius,
        contrast_init=raw_contrast_init(cfg.event.contrast_init,
                                        cfg.event.contrast_parameterization),
        max_sh_degree=m.sh_degree,
    )
    return info, data, state, info.radius


def prepare_output_dir(cfg: TrainConfig, info) -> str:
    """Create the model dir and write cfg.json, cameras.json and input.ply
    (reference `prepare_output_and_logger` + `Scene.__init__`)."""
    import shutil
    import uuid

    model_path = cfg.model.model_path or os.path.join(
        "./output", str(uuid.uuid4())[:10])
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump([camera_to_json(i, c) for i, c in enumerate(info.train_cameras)], f)
    if info.ply_path and os.path.exists(info.ply_path):
        shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
    return model_path


def claim_accelerator(device: torch.device) -> None:
    """Start the card's CUDA context on ``device`` before long host work
    (dataset loads), at the JAX package's call sites, so a card that cannot
    be used fails there and not after the load.  Nothing on the CPU."""
    if device.type == "cuda":
        torch.zeros(1, device=device).sum().item()


def load_run_config(model_path: str) -> TrainConfig:
    """Re-load a run's persisted ``cfg.json`` (the JAX package's format)."""
    with open(os.path.join(model_path, "cfg.json")) as f:
        return TrainConfig.from_json(f.read())


def load_trained_model(model_path: str, iteration: int, device):
    """A run's config, the iteration to load (the newest saved one when
    ``iteration`` ≤ 0) and its PLY as Gaussian params on ``device``."""
    cfg = load_run_config(model_path)
    it = iteration if iteration > 0 else find_max_iteration(model_path)
    ply = os.path.join(model_path, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    params = load_gaussian_ply(ply, max_sh_degree=cfg.model.sh_degree,
                               device=device)
    return cfg, it, params
