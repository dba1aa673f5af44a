"""Depth-quantile Gaussian partitioning for the ``gauss`` axis (partials
compositing strategy only).

Counterpart of ``event3dgs_tpu/parallel/partition.py`` (numpy on the host,
as there).  The partials merge (``parallel.compose``) is exact only when
the shards are depth-separable per view; this module reorders the
capacity dimension of the whole train state so shard k (slot range
[k·C/K, (k+1)·C/K)) holds the k-th depth quantile of the alive Gaussians
by a scene-static proxy, the distance from the camera-position centroid.

Known limits, as measured in the JAX package: on forward-facing and
layered rigs the quantile shards are depth-separated per view; on
inward-facing rigs (full orbits) they are concentric shells every ray
crosses twice, and no shard order composites them exactly (~1e-2 max
pixel error on a 48-Gaussian orbit).  The exact strategy
(``parallel.exchange``) needs no partition.

Runs on the host at init and at densification boundaries; a permutation of
the capacity dim relabels slots, which changes neither rendering nor
optimization.  Dead slots are spread evenly so every shard keeps free
capacity for densification.
"""

from __future__ import annotations

import numpy as np
import torch

from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.train.state import map_tensors


def depth_proxy(xyz: np.ndarray, cameras: Camera) -> np.ndarray:
    """[C] per-Gaussian scene-static depth proxy (rig-centroid distance)."""
    centers = cameras.camera_center.detach().cpu().numpy()
    centroid = centers.reshape(-1, 3).mean(axis=0)
    return np.linalg.norm(np.asarray(xyz) - centroid[None, :], axis=1)


def depth_partition_perm(
    xyz: np.ndarray,
    alive: np.ndarray,
    cameras: Camera,
    n_shards: int,
) -> np.ndarray:
    """Permutation ``perm`` with ``new_leaf = leaf[perm]`` laying out slots
    so shard k holds the k-th depth quantile of the alive Gaussians.

    Alive Gaussians are sorted by the depth proxy and dealt into shards in
    contiguous quantile blocks; dead slots fill each shard up to C/K.
    """
    c = xyz.shape[0]
    if c % n_shards:
        raise ValueError(f"capacity {c} not divisible by {n_shards} shards")
    per = c // n_shards
    alive = np.asarray(alive, bool)
    alive_idx = np.flatnonzero(alive)
    dead_idx = np.flatnonzero(~alive)
    proxy = depth_proxy(xyz, cameras)
    alive_sorted = alive_idx[np.argsort(proxy[alive_idx], kind="stable")]

    bounds = np.linspace(0, alive_sorted.size, n_shards + 1).round().astype(int)
    perm = np.empty(c, np.int64)
    d = 0  # next dead slot to hand out
    for k in range(n_shards):
        grp = alive_sorted[bounds[k]: bounds[k + 1]]
        if grp.size > per:
            raise ValueError(
                f"shard {k} quantile ({grp.size}) exceeds shard capacity {per}")
        n_dead = per - grp.size
        fill = dead_idx[d: d + n_dead]
        d += n_dead
        perm[k * per: (k + 1) * per] = np.concatenate([grp, fill])
    return perm


def permute_capacity_dim(tree, perm: np.ndarray, capacity: int):
    """Apply a slot permutation to every [C, ...] tensor of a state tree."""

    def apply(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] == capacity:
            return leaf[torch.as_tensor(perm, device=leaf.device)]
        return leaf

    return map_tensors(apply, tree)


def repartition_by_depth(state, cameras: Camera, n_shards: int):
    """Reorder a full (unsharded) TrainState's Gaussian slots into
    depth-quantile shard order: params, Adam moments and densify stats
    permuted together.  Re-shard afterwards (``shard_train_state``)."""
    xyz = state.params.xyz.detach().cpu().numpy()
    alive = state.params.alive.cpu().numpy()
    perm = depth_partition_perm(xyz, alive, cameras, n_shards)
    return permute_capacity_dim(state, perm, state.params.capacity)
