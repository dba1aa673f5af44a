"""Adaptive density control as masked updates of fixed-capacity buffers.

Counterpart of ``event3dgs_tpu/models/densify.py``, the reference's
densify/clone/split/prune policy (`scene/gaussian_model.py:258-407`,
driven from `train.py:316-327`):

- **stats**: accumulate the norm of each Gaussian's screen-space (2D mean)
  gradient and a visit count; track the max on-screen radius.
- **clone**: small Gaussians (max scale ≤ percent_dense·extent) with mean
  grad ≥ threshold are duplicated.
- **split**: large ones are replaced by two children sampled from the
  Gaussian itself with scales divided by 1.6.
- **prune**: opacity < min_opacity, or (past the first opacity reset)
  screen radius > 20 px or world scale > 0.1·extent.

New Gaussians claim dead slots by rank (k-th candidate → k-th free slot);
candidates beyond the free slots are dropped and counted, so the caller can
grow capacity and run again.  Adam moments of claimed slots are zeroed.

The split samples are an argument (``normals``, [2, C, 3] standard
normals): a ``jax.random`` draw has no torch counterpart, so the caller
draws them (the training loop from a seeded ``torch.Generator``) and parity
tests hand both packages the same samples.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from event3dgs_tpu_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from event3dgs_tpu_torch.models.gaussians import TRAINABLE_FIELDS, GaussianParams
from event3dgs_tpu_torch.models.optimizer import AdamState
from event3dgs_tpu_torch.utils.device import constant


@dataclasses.dataclass
class DensifyStats:
    grad_accum: torch.Tensor  # [C] accumulated ‖∂L/∂mean2d‖
    denom: torch.Tensor  # [C] visit counts
    max_radii2d: torch.Tensor  # [C] max on-screen radius seen


def init_stats(capacity: int, device=None) -> DensifyStats:
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
    return DensifyStats(grad_accum=z(), denom=z(), max_radii2d=z())


@torch.no_grad()
def update_stats(stats: DensifyStats, mean2d_grad, radii, visibility,
                 grad_scale: tuple[float, float] = (1.0, 1.0)) -> DensifyStats:
    """Per-iteration stats accumulation (`train.py:317-320`).

    ``grad_scale`` must be ``(0.5*W, 0.5*H)`` of the render: the reference
    CUDA backward emits mean2D gradients pre-scaled by the NDC→pixel
    Jacobian halves, which makes its 2e-4 densify threshold
    resolution-independent; the tap gradient here is in pixels.
    """
    vis = visibility.to(torch.float32)
    scale = constant(grad_scale, mean2d_grad.dtype, mean2d_grad.device)
    gnorm = torch.linalg.norm(mean2d_grad * scale, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(stats.max_radii2d, radii * vis),
    )


class DensifyResult(NamedTuple):
    params: GaussianParams
    opt_state: AdamState
    stats: DensifyStats
    overflow: torch.Tensor  # [] candidates dropped for lack of capacity


def _rank_match_scatter(dest, dest_free, src, src_mask):
    """Write the k-th True item of ``src`` into the k-th free slot of
    ``dest`` → (new dest, claimed [C] bool, dropped count).

    Each candidate has its own target (the dropped ones a spare row past
    the end), so the scatter writes every slot at most once and repeats
    bit for bit.
    """
    c = dest.shape[0]
    free_order = torch.argsort((~dest_free).to(torch.int8), stable=True)
    n_free = dest_free.sum()
    cand_rank = torch.cumsum(src_mask.to(torch.int64), 0) - 1
    ok = src_mask & (cand_rank < n_free)
    target = torch.where(ok, free_order[torch.clamp(cand_rank, 0, c - 1)],
                         c + torch.arange(src.shape[0], device=dest.device))
    out = torch.cat([dest, dest.new_zeros((src.shape[0],) + dest.shape[1:])])
    out[target] = src
    claimed = torch.zeros(c + src.shape[0], dtype=torch.bool,
                          device=dest.device)
    claimed[target] = ok
    return out[:c], claimed[:c], src_mask.sum() - ok.sum()


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    opt_state: AdamState,
    stats: DensifyStats,
    normals: torch.Tensor,  # [2, C, 3] standard normal split samples
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,  # 0 disables the screen/world-size prune
    percent_dense: float = 0.01,
) -> DensifyResult:
    """One densification step (reference `densify_and_prune` +
    `densify_and_clone` + `densify_and_split`, N=2)."""
    c = params.capacity
    alive = params.alive

    grads = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads) * alive

    scales = torch.exp(params.scaling)
    max_scale = scales.max(dim=-1).values
    dense_limit = percent_dense * extent

    hot = grads >= grad_threshold
    clone_sel = alive & hot & (max_scale <= dense_limit)
    split_sel = alive & hot & (max_scale > dense_limit)

    opacity_act = torch.sigmoid(params.opacity[:, 0])
    prune = opacity_act < min_opacity
    use_size_prune = max_screen_size > 0
    if use_size_prune:
        prune = prune | (stats.max_radii2d > max_screen_size) | (
            max_scale > 0.1 * extent)
    new_alive = alive & ~split_sel & ~prune  # split originals die

    # candidate banks, each [C]: clones first, then the two split children
    rot = quat_to_rotmat(params.rotation)
    sp_scaling = torch.log(scales / (0.8 * 2.0))
    sp_xyz = [params.xyz + (rot * (normals[i] * scales)[:, None, :]).sum(-1)
              for i in range(2)]

    def bank(field):
        base = getattr(params, field)
        if field == "xyz":
            return torch.cat([base, sp_xyz[0], sp_xyz[1]])
        if field == "scaling":
            return torch.cat([base, sp_scaling, sp_scaling])
        return torch.cat([base, base, base])

    # children whose source the post-densify prune would delete at once
    # are not created
    child_opacity_ok = opacity_act >= min_opacity
    if use_size_prune:
        child_scale_ok = torch.exp(sp_scaling).max(dim=-1).values <= 0.1 * extent
        cand_ok = torch.cat([child_opacity_ok & (max_scale <= 0.1 * extent),
                             child_opacity_ok & child_scale_ok,
                             child_opacity_ok & child_scale_ok])
    else:
        cand_ok = torch.cat([child_opacity_ok] * 3)
    cand_mask = torch.cat([clone_sel, split_sel, split_sel]) & cand_ok

    free = ~new_alive
    fields = {}
    for field in TRAINABLE_FIELDS:
        fields[field], claimed, dropped = _rank_match_scatter(
            getattr(params, field), free, bank(field), cand_mask)
    new_params = GaussianParams(alive=new_alive | claimed, **fields)

    def zero_claimed(tree):
        return {k: torch.where(claimed.reshape((c,) + (1,) * (v.dim() - 1)),
                               torch.zeros_like(v), v) for k, v in tree.items()}

    new_opt = AdamState(mu=zero_claimed(opt_state.mu),
                        nu=zero_claimed(opt_state.nu), count=opt_state.count)
    return DensifyResult(params=new_params, opt_state=new_opt,
                         stats=init_stats(c, device=alive.device),
                         overflow=dropped)


@torch.no_grad()
def reset_opacity(params: GaussianParams, opt_state: AdamState,
                  ceiling: float = 0.01) -> tuple[GaussianParams, AdamState]:
    """Clamp every opacity to ≤ ``ceiling`` and zero its Adam moments
    (reference `reset_opacity`, `gaussian_model.py:210-213`)."""
    act = torch.sigmoid(params.opacity)
    new_params = dataclasses.replace(
        params, opacity=inverse_sigmoid(torch.clamp(act, max=ceiling)))

    def zero_op(tree):
        return {k: torch.zeros_like(v) if k == "opacity" else v
                for k, v in tree.items()}

    return new_params, AdamState(mu=zero_op(opt_state.mu),
                                 nu=zero_op(opt_state.nu),
                                 count=opt_state.count)
