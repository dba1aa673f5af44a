"""Training-state checkpoints and the inference PLY (counterpart of
``event3dgs_tpu/train/checkpoint.py``).

- **Full train state** (``chkpnt{N}.npz`` + a ``.json`` sidecar): every
  tensor of :class:`TrainState` — parameters and alive mask, Adam moments,
  densify stats, step, the learnable event contrast and its Adam state —
  under the JAX package's key names (``params/xyz``,
  ``opt_state/mu/xyz``, ``contrast_opt/count``, ``stats/denom``, ``step``,
  ...), so a checkpoint written by either package loads in the other.
- **Inference artifact**: ``point_cloud/iteration_{N}/point_cloud.ply``
  with the reference schema (:func:`save_point_cloud`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from event3dgs_tpu_torch.data.ply import save_gaussian_ply
from event3dgs_tpu_torch.models.densify import DensifyStats
from event3dgs_tpu_torch.models.gaussians import FIELDS, GaussianParams
from event3dgs_tpu_torch.models.optimizer import AdamState
from event3dgs_tpu_torch.train.state import TrainState


def _flatten(state: TrainState) -> dict[str, torch.Tensor]:
    """``{"params/xyz": tensor, ...}``: the JAX package's leaf paths."""
    out = {f"params/{f}": getattr(state.params, f) for f in FIELDS}
    for name in ("opt_state", "contrast_opt"):
        adam = getattr(state, name)
        for moment in ("mu", "nu"):
            tree = getattr(adam, moment)
            if isinstance(tree, dict):
                out.update({f"{name}/{moment}/{k}": v for k, v in tree.items()})
            else:
                out[f"{name}/{moment}"] = tree
        out[f"{name}/count"] = adam.count
    out["contrast"] = state.contrast
    for f in dataclasses.fields(DensifyStats):
        out[f"stats/{f.name}"] = getattr(state.stats, f.name)
    out["step"] = state.step
    return out


def save_checkpoint(path: str, state: TrainState, iteration: int) -> None:
    """Write the full train state to ``path`` (npz + ``path.json`` meta)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten(state).items()}
    np.savez_compressed(path, **arrays)
    meta = {
        "iteration": iteration,
        "capacity": state.params.capacity,
        "spatial_lr_scale": state.spatial_lr_scale,
        "max_sh_degree": state.max_sh_degree,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, template: TrainState) -> tuple[TrainState, int]:
    """Restore a checkpoint into the structure (and devices) of
    ``template``; shapes must match (same capacity)."""
    data = np.load(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    loaded = {}
    for key, leaf in _flatten(template).items():
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key} shape {arr.shape} != template "
                f"{tuple(leaf.shape)} (capacity mismatch? saved capacity "
                f"{meta['capacity']})")
        loaded[key] = torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)

    def adam(name, keys):
        def moment(m):
            if isinstance(getattr(getattr(template, name), m), dict):
                return {k: loaded[f"{name}/{m}/{k}"] for k in keys}
            return loaded[f"{name}/{m}"]
        return AdamState(mu=moment("mu"), nu=moment("nu"),
                         count=loaded[f"{name}/count"])

    state = template.replace(
        params=GaussianParams(**{f: loaded[f"params/{f}"] for f in FIELDS}),
        opt_state=adam("opt_state", template.opt_state.mu),
        contrast=loaded["contrast"],
        contrast_opt=adam("contrast_opt", ()),
        stats=DensifyStats(**{f.name: loaded[f"stats/{f.name}"]
                              for f in dataclasses.fields(DensifyStats)}),
        step=loaded["step"],
    )
    return state, int(meta["iteration"])


def save_point_cloud(model_path: str, iteration: int, state: TrainState) -> str:
    """Write the inference PLY at the reference layout
    (`scene/__init__.py:95-98`)."""
    out = os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    save_gaussian_ply(out, state.params)
    return out


def find_max_iteration(model_path: str) -> int:
    """Latest saved iteration (reference `searchForMaxIteration`,
    `utils/system_utils.py:26-28`)."""
    d = os.path.join(model_path, "point_cloud")
    iters = [
        int(f.split("_")[-1]) for f in os.listdir(d) if f.startswith("iteration_")
    ]
    if not iters:
        raise FileNotFoundError(f"no saved iterations under {d}")
    return max(iters)
