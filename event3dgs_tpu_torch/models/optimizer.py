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
dict of tensors or a single tensor (the event contrast).

- :func:`adam_update_plain` is the update in plain tensor code, about 15
  launches a leaf on a card.
- :func:`adam_update_kernel` runs the update of several groups (the six
  leaves and the contrast of a train step) as one CUDA kernel
  (``csrc/adam.cu``) that repeats the plain operations in their order and
  equals them bit for bit; only the step counts' increments run before it.
- :func:`adam_update_groups` and :func:`adam_update` (one group) take
  the plain version for CPU tensors and the kernel for CUDA tensors; on
  CUDA a failed build or launch raises, nothing falls back.  They return
  new tensors and leave their inputs untouched; given ``out``,
  :func:`adam_update_groups` writes the new parameters and moments into
  it instead (in place where ``out`` holds the inputs themselves, as the
  graph-ready train step does).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from event3dgs_tpu_torch.ops import kernels
from event3dgs_tpu_torch.utils.device import constant

MAX_SEGMENTS = 8  # csrc/adam.cu: the tensors one launch updates


def _map(fn, *trees):
    """``fn`` over matching dicts of tensors, or over single tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The tensors of a dict of tensors (in its order), or the one tensor."""
    return list(tree.values()) if isinstance(tree, dict) else [tree]


@dataclasses.dataclass
class AdamState:
    mu: object  # dict of tensors like the params, or one tensor
    nu: object
    count: torch.Tensor  # [] int32 step count


class AdamGroup(NamedTuple):
    """One :class:`AdamState`'s update: ``params`` and ``grads`` a dict of
    tensors or one tensor, ``lr`` matching ``params`` (a number, or a
    one-element float32 tensor on their device, per leaf)."""

    params: object
    grads: object
    state: AdamState
    lr: object


def adam_init(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p)
    dev = next(iter(params.values())).device if isinstance(params, dict) \
        else params.device
    return AdamState(mu=_map(zeros, params), nu=_map(zeros, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update_plain(params, grads, state: AdamState, lr_tree,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step in plain tensor code → (new_params, new_state).

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


def grad_rows(g: torch.Tensor, shape) -> tuple[torch.Tensor, int, int]:
    """How the kernel reads the gradient ``g`` of a leaf of ``shape``:
    (``g`` or a contiguous copy of it, the floats of a row, the floats
    between rows).  Rows run along the first dimension (one row for a 0-d
    or one-row leaf).  A strided slice of a wider gradient, as the feature
    gradients are, is read where it lies; another layout is copied."""
    if g.dtype != torch.float32:
        raise ValueError(f"grad: expected float32, got {g.dtype}")
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"grad: expected shape {tuple(shape)}, got "
                         f"{tuple(g.shape)}")
    if g.dim() == 0 or g.shape[0] <= 1:
        return g.contiguous(), g.numel(), g.numel()
    width, rows_contiguous = 1, True
    for size, stride in reversed(list(zip(g.shape[1:], g.stride()[1:]))):
        rows_contiguous &= size == 1 or stride == width
        width *= size
    if not rows_contiguous or g.stride(0) < width:
        g = g.contiguous()
    return g, width, g.stride(0)


def _segment(p, g, m, v, p_out, m_out, v_out, lr, count):
    """One leaf's segment of the kernel's table: (9 pointers, [floats, row
    width, g's row stride], the float learning rate, g as read)."""
    dev = p.device
    for t, what in ((p, "param"), (m, "mu"), (v, "nu"), (p_out, "param out"),
                    (m_out, "mu out"), (v_out, "nu out")):
        kernels.check(t, torch.float32, what, p.shape)
        if t.device != dev:
            raise ValueError(f"{what}: on {t.device}, the param on {dev}")
    if g.device != dev:
        raise ValueError(f"grad: on {g.device}, the param on {dev}")
    g, width, stride = grad_rows(g, p.shape)
    if isinstance(lr, torch.Tensor):
        if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
            raise ValueError(f"lr: expected one float32 on {dev}, got "
                             f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    ptrs = [t.data_ptr() for t in (p, g, m, v, p_out, m_out, v_out)]
    return (ptrs + [lr_ptr, count.data_ptr()], [p.numel(), width, stride],
            lr_value, g)


def group_leaves(params, grads, state, lrs, new_p, new_s) -> list:
    """Per leaf of ``params`` (by key for a dict): (p, g, m, v, p_out,
    m_out, v_out, lr)."""
    trees = (params, grads, state.mu, state.nu, new_p, new_s.mu, new_s.nu,
             lrs)
    if not isinstance(params, dict):
        return [trees]
    return [tuple(t[k] for t in trees) for k in params]


@torch.no_grad()
def adam_update_kernel(groups, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-15, out=None) -> list:
    """One Adam step of each of ``groups`` (:class:`AdamGroup`, CUDA
    tensors) in one launch of ``csrc/adam.cu`` → [(new_params,
    new_state)].  Each group's count is incremented first (one PyTorch op
    each) into a new tensor, or into ``out``'s: ``out`` is a list of
    (params, AdamState) per group, like the group's, to write into."""
    segs, results = [], []
    for i, (params, grads, state, lrs) in enumerate(groups):
        if out is None:
            new_p = _map(torch.empty_like, params)
            new_s = AdamState(mu=_map(torch.empty_like, state.mu),
                              nu=_map(torch.empty_like, state.nu),
                              count=torch.empty_like(state.count))
        else:
            new_p, new_s = out[i]
        for c, what in ((state.count, "count"), (new_s.count, "count out")):
            kernels.check(c, torch.int32, what, ())
        for leaf in group_leaves(params, grads, state, lrs, new_p, new_s):
            if leaf[0].numel():
                segs.append(_segment(*leaf, new_s.count))
        results.append((new_p, new_s))
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"{len(segs)} tensors for a launch of at most "
                         f"{MAX_SEGMENTS}")
    for (_, _, state, _), (_, new_s) in zip(groups, results):
        torch.add(state.count, 1, out=new_s.count)
    if segs:
        ptrs = (ctypes.c_void_p * (9 * len(segs)))(
            *(x for s in segs for x in s[0]))
        sizes = (ctypes.c_longlong * (3 * len(segs)))(
            *(x for s in segs for x in s[1]))
        lrs = (ctypes.c_float * len(segs))(*(s[2] for s in segs))
        kernels.launch("adam", "e3d_adam_update", ctypes.addressof(ptrs),
                       ctypes.addressof(sizes), ctypes.addressof(lrs),
                       len(segs), b1, 1.0 - b1, b2, 1.0 - b2, eps)
        adam_update_kernel.launches += 1
    return results


adam_update_kernel.launches = 0


def _copy_into(dst, src) -> None:
    """Copy a dict of tensors (by key) or a tensor into ``dst``."""
    if isinstance(dst, dict):
        for k, d in dst.items():
            d.copy_(src[k])
    else:
        dst.copy_(src)


@torch.no_grad()
def adam_update_groups(groups, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-15, out=None) -> list:
    """One Adam step of each of ``groups`` (:class:`AdamGroup` or tuples of
    its fields) → [(new_params, new_state)]: the kernel, in one launch, for
    CUDA tensors, the plain version for CPU ones.  With ``out`` (a list of
    (params, AdamState) per group, like the group's) the new values are
    written into it and it is returned; where it holds the group's own
    tensors the update is in place."""
    groups = [AdamGroup(*g) for g in groups]
    if leaves(groups[0].params)[0].device.type != "cpu":
        return adam_update_kernel(groups, b1, b2, eps, out)
    new = [adam_update_plain(*g, b1=b1, b2=b2, eps=eps) for g in groups]
    if out is None:
        return new
    for (p, s), (np_, ns) in zip(out, new):
        for d, t in ((p, np_), (s.mu, ns.mu), (s.nu, ns.nu),
                     (s.count, ns.count)):
            _copy_into(d, t)
    return [(p, s) for p, s in out]


def adam_update(params, grads, state: AdamState, lr_tree, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step → (new_params, new_state): :func:`adam_update_groups`
    of one group.

    ``lr_tree`` matches ``params``: a dict of learning rates, or one rate.
    """
    (res,) = adam_update_groups([AdamGroup(params, grads, state, lr_tree)],
                                b1, b2, eps)
    return res
