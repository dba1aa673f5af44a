"""Hand-rolled Adam with per-leaf learning rates and moment surgery.

Counterpart of ``event3dgs_tpu/models/optimizer.py``.  The reference uses
torch Adam with six parameter groups and ``eps=1e-15``
(`scene/gaussian_model.py:154-163`) and edits the optimizer state on
densification.  ``torch.optim.Adam`` is not used here: it rounds the update
differently from the JAX package, and densification reaches into the
moments.  The update is

    m ← β1·m + (1-β1)·g        v ← β2·v + (1-β2)·g²
    p ← p - lr · (m/(1-β1ᵗ)) / (√(v/(1-β2ᵗ)) + eps)

in float32 with one shared step count t.  Parameters and moments are a
dict of tensors or a single tensor (the event contrast); every call returns
new tensors and leaves its inputs untouched.
"""

from __future__ import annotations

import dataclasses

import torch

from event3dgs_tpu_torch.utils.device import constant


def _map(fn, *trees):
    """``fn`` over matching dicts of tensors, or over single tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass
class AdamState:
    mu: object  # dict of tensors like the params, or one tensor
    nu: object
    count: torch.Tensor  # [] int32 step count


def adam_init(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p)
    dev = next(iter(params.values())).device if isinstance(params, dict) \
        else params.device
    return AdamState(mu=_map(zeros, params), nu=_map(zeros, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr_tree, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step → (new_params, new_state).

    ``lr_tree`` matches ``params``: a dict of learning rates, or one rate.
    """
    count = state.count + 1
    t = count.to(torch.float32)
    c1 = 1.0 - constant(b1, torch.float32, t.device) ** t
    c2 = 1.0 - constant(b2, torch.float32, t.device) ** t
    mu = _map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1.0 - b2) * g * g, state.nu, grads)

    def step(p, m, v, lr):
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps)

    if not isinstance(params, dict):
        return step(params, mu, nu, lr_tree), AdamState(mu, nu, count)
    new = {k: step(params[k], mu[k], nu[k], lr_tree[k]) for k in params}
    return new, AdamState(mu=mu, nu=nu, count=count)
