"""Gaussian model: fixed-capacity parameter buffers, optimizer,
densification."""

from event3dgs_tpu_torch.models.densify import (
    DensifyStats,
    densify_and_prune,
    init_stats,
    reset_opacity,
    update_stats,
)
from event3dgs_tpu_torch.models.gaussians import (
    TRAINABLE_FIELDS,
    ActivatedGaussians,
    GaussianParams,
    activated,
    grow_params,
    init_from_point_cloud,
    num_alive,
    params_from_numpy,
    trainable_dict,
    with_trainable,
)
from event3dgs_tpu_torch.models.optimizer import AdamState, adam_init, adam_update

__all__ = [
    "TRAINABLE_FIELDS",
    "ActivatedGaussians",
    "AdamState",
    "DensifyStats",
    "GaussianParams",
    "activated",
    "adam_init",
    "adam_update",
    "densify_and_prune",
    "grow_params",
    "init_from_point_cloud",
    "init_stats",
    "num_alive",
    "params_from_numpy",
    "reset_opacity",
    "trainable_dict",
    "update_stats",
    "with_trainable",
]
