"""Gaussian parameters in fixed-capacity buffers with an ``alive`` mask.

Counterpart of ``event3dgs_tpu/models/gaussians.py``.  Parameter semantics
match the reference (`scene/gaussian_model.py:26-42,95-118`): ``scaling``
in log-space (exp activation), ``opacity`` in logit-space (sigmoid),
quaternion ``rotation`` normalized on use, SH features split into DC and
rest.  Dead (non-alive) slots render with opacity 0.

Training uses the six trainable fields (:data:`TRAINABLE_FIELDS`) as a dict
of leaf tensors (:func:`trainable_dict`, :func:`with_trainable`); the
``alive`` mask is bookkeeping and never optimized.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from event3dgs_tpu_torch.core.sh import rgb_to_sh
from event3dgs_tpu_torch.core.transforms import inverse_sigmoid
from event3dgs_tpu_torch.utils.device import resolve_device

FIELDS = (
    "xyz",
    "features_dc",
    "features_rest",
    "scaling",
    "rotation",
    "opacity",
    "alive",
)


@dataclasses.dataclass
class GaussianParams:
    """Raw (pre-activation) parameters in fixed-capacity buffers."""

    xyz: torch.Tensor  # [C, 3]
    features_dc: torch.Tensor  # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor  # [C, 3] log-space
    rotation: torch.Tensor  # [C, 4] quaternion (unnormalized)
    opacity: torch.Tensor  # [C, 1] logit-space
    alive: torch.Tensor  # [C] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_coeffs(self) -> int:
        return 1 + self.features_rest.shape[1]

    @property
    def device(self) -> torch.device:
        return self.xyz.device


class ActivatedGaussians(NamedTuple):
    """Activated parameters as consumed by the renderer."""

    means3d: torch.Tensor  # [C, 3]
    features: torch.Tensor  # [C, K, 3]
    opacities: torch.Tensor  # [C] (zeroed for dead slots)
    scales: torch.Tensor  # [C, 3]
    rotations: torch.Tensor  # [C, 4]


def activated(params: GaussianParams) -> ActivatedGaussians:
    """Apply activations; dead slots get opacity 0 so they never render."""
    return ActivatedGaussians(
        means3d=params.xyz,
        features=torch.cat([params.features_dc, params.features_rest], dim=1),
        opacities=torch.sigmoid(params.opacity[:, 0]) * params.alive,
        scales=torch.exp(params.scaling),
        rotations=params.rotation,
    )


def num_alive(params: GaussianParams) -> int:
    return int(params.alive.sum())


def params_from_numpy(fields: dict, device=None) -> GaussianParams:
    """Build the port's params from the JAX ``GaussianParams`` fields.

    ``fields`` maps each field name of :data:`FIELDS` to a numpy array (for
    example ``{f: np.asarray(getattr(jax_params, f)) for f in FIELDS}``);
    float fields become float32 tensors and ``alive`` a bool tensor on
    ``device``.
    """
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise ValueError(f"missing Gaussian fields: {missing}")
    out = {}
    for f in FIELDS:
        dtype = bool if f == "alive" else np.float32
        out[f] = torch.tensor(np.asarray(fields[f], dtype), device=dev)
    return GaussianParams(**out)


# The six trainable leaves (the reference's six Adam param groups,
# `gaussian_model.py:154-161`); `alive` is bookkeeping, never optimized.
TRAINABLE_FIELDS = FIELDS[:-1]


def trainable_dict(params: GaussianParams) -> dict:
    """The trainable fields as a dict (excludes the alive mask)."""
    return {f: getattr(params, f) for f in TRAINABLE_FIELDS}


def with_trainable(params: GaussianParams, tree: dict) -> GaussianParams:
    """A copy of ``params`` with the trainable fields of ``tree``."""
    return dataclasses.replace(params, **tree)


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbors (host-side, scipy
    ``cKDTree``), standing in for the reference's `simple-knn` extension
    (`scene/gaussian_model.py:20,134`); used once at init."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 4:
        return np.full(pts.shape[0], 1e-4)
    dists, _ = cKDTree(pts).query(pts, k=4)  # neighbor 0 is the point itself
    return np.mean(dists[:, 1:] ** 2, axis=1)


def grow_params(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """Grow the capacity buffers, keeping every slot.

    New slots are dead, with identity rotations (a zero quaternion would
    NaN the normalization) and the init opacity fill, as the JAX package's
    ``grow_params``.
    """
    c = params.capacity
    if new_capacity <= c:
        raise ValueError(f"new capacity {new_capacity} <= current {c}")
    pad = new_capacity - c

    def zpad(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    rot_pad = params.rotation.new_zeros(pad, 4)
    rot_pad[:, 0] = 1.0
    opa_pad = params.opacity.new_full((pad, 1), float(inverse_sigmoid(0.1)))
    return GaussianParams(
        xyz=zpad(params.xyz),
        features_dc=zpad(params.features_dc),
        features_rest=zpad(params.features_rest),
        scaling=zpad(params.scaling),
        rotation=torch.cat([params.rotation, rot_pad]),
        opacity=torch.cat([params.opacity, opa_pad]),
        alive=zpad(params.alive),
    )


def init_from_point_cloud(points: np.ndarray, colors: np.ndarray,
                          capacity: int, max_sh_degree: int = 3,
                          device=None) -> GaussianParams:
    """Initialize Gaussians from an SfM point cloud (reference
    `create_from_pcd`, `scene/gaussian_model.py:124-147`): DC features from
    the point colors, isotropic log-scales from the clamped 3-NN mean
    squared distance, identity rotations and opacity 0.1.  Points beyond
    ``capacity`` are dropped; spare slots are dead."""
    n = min(points.shape[0], capacity)
    k = (max_sh_degree + 1) ** 2
    dist2 = np.maximum(mean_sq_dist_3nn(points[:n]), 1e-7)
    log_scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def alloc(shape, fill=0.0):
        return np.full((capacity,) + shape, fill, np.float32)

    xyz = alloc((3,))
    xyz[:n] = points[:n]
    f_dc = alloc((1, 3))
    f_dc[:n, 0] = rgb_to_sh(np.asarray(colors[:n], np.float32))
    scaling = alloc((3,))
    scaling[:n] = log_scales
    rotation = alloc((4,))
    rotation[:, 0] = 1.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    return params_from_numpy(dict(
        xyz=xyz, features_dc=f_dc, features_rest=alloc((k - 1, 3)),
        scaling=scaling, rotation=rotation,
        opacity=alloc((1,), fill=float(inverse_sigmoid(0.1))), alive=alive,
    ), device)
