"""Train state and scene-data containers (counterpart of
``event3dgs_tpu/train/state.py``).

The whole optimization state — Gaussian parameters, their Adam state, the
learnable event contrast ``c`` with its Adam state, the densify stats and
the step counter — is one :class:`TrainState`.  Unlike the reference
(which forgets ``c`` on checkpoint, `gaussian_model.py:61-75`), the
contrast is part of the state and is checkpointed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.models.densify import DensifyStats, init_stats
from event3dgs_tpu_torch.models.gaussians import (
    GaussianParams,
    grow_params,
    trainable_dict,
)
from event3dgs_tpu_torch.models.optimizer import AdamState, adam_init


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt_state: AdamState
    contrast: torch.Tensor  # [] learnable event contrast c (raw)
    contrast_opt: AdamState
    stats: DensifyStats
    step: torch.Tensor  # [] int32 iteration counter, on the CPU
    spatial_lr_scale: float = 1.0
    max_sh_degree: int = 3

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


class SceneData(NamedTuple):
    """Training data on the training device (one resolution per stack):
    train images, event-timed frames, blurry captures and held-out test
    renders (`scene/dataset_readers.py:134-227`)."""

    cameras: Camera  # batched [V]
    images: torch.Tensor  # [V, H, W, 3]
    event_cameras: Optional[Camera] = None  # batched [Ve]
    event_images: Optional[torch.Tensor] = None  # [Ve, H, W, 3]
    blurry_images: Optional[torch.Tensor] = None  # [V, H, W, 3]
    test_cameras: Optional[Camera] = None
    test_images: Optional[torch.Tensor] = None

    @property
    def num_views(self) -> int:
        return self.images.shape[0]


def init_train_state(params: GaussianParams, spatial_lr_scale: float,
                     contrast_init: float = 0.17,
                     max_sh_degree: int = 3) -> TrainState:
    dev = params.device
    contrast = torch.tensor(contrast_init, dtype=torch.float32, device=dev)
    return TrainState(
        params=params,
        opt_state=adam_init(trainable_dict(params)),
        contrast=contrast,
        contrast_opt=adam_init(contrast),
        stats=init_stats(params.capacity, device=dev),
        # on the host: the step picks learning rates and the SH degree
        step=torch.zeros((), dtype=torch.int32),
        spatial_lr_scale=float(spatial_lr_scale),
        max_sh_degree=max_sh_degree,
    )


def grow_state(state: TrainState, new_capacity: int) -> TrainState:
    """Grow every capacity-sized buffer: parameters through
    :func:`grow_params`, Adam moments and densify stats zero-padded."""
    pad = new_capacity - state.params.capacity

    def zpad(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    opt = state.opt_state
    return state.replace(
        params=grow_params(state.params, new_capacity),
        opt_state=AdamState(mu={k: zpad(v) for k, v in opt.mu.items()},
                            nu={k: zpad(v) for k, v in opt.nu.items()},
                            count=opt.count),
        stats=DensifyStats(*(zpad(getattr(state.stats, f.name))
                             for f in dataclasses.fields(DensifyStats))),
    )


def map_tensors(fn, tree):
    """``fn`` over every tensor of a state tree (the dataclasses of a
    :class:`TrainState`, dicts and tensors); other values pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def copy_tree_(dst, src) -> None:
    """Copy every tensor of the state tree ``src`` into the matching tensor
    of ``dst`` (same structure and shapes), in place; a tensor that is
    already ``dst``'s is skipped."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            copy_tree_(v, src[k])
    elif dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        for f in dataclasses.fields(dst):
            copy_tree_(getattr(dst, f.name), getattr(src, f.name))


def active_sh_degree(step: int, max_degree: int) -> int:
    """SH degree grows by one every 1000 iterations (`train.py:99-100`)."""
    return min(int(step) // 1000, max_degree)


def sh_coeff_mask(active_degree: int, n_coeffs: int, device=None) -> torch.Tensor:
    """[K] float mask of the SH coefficients enabled at ``active_degree``
    (multiplying the features by it equals evaluating at that degree)."""
    idx = torch.arange(n_coeffs, device=device)
    return (idx < (active_degree + 1) ** 2).to(torch.float32)


def nerfpp_extent(cameras: Camera) -> float:
    """Scene radius: 1.1 × max camera distance from the camera centroid
    (reference `getNerfppNorm`, `scene/dataset_readers.py:47-68`)."""
    centers = cameras.camera_center.detach().cpu().numpy()
    center = centers.mean(axis=0, keepdims=True)
    return float(np.max(np.linalg.norm(centers - center, axis=1)) * 1.1)
