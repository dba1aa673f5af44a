"""Device selection for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.

    The port never falls back to the CPU on its own: the CPU is used only
    when the caller asks for it (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA card is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of the Python number or flat sequence ``values`` on
    ``device``, made once per (values, dtype, device) and shared: callers
    must not write to it.

    Building a CUDA tensor from Python values is a copy from the host,
    which a CUDA graph's stream capture forbids, so the train step takes
    its constants from here, where the steps before a capture have made
    them.  They are kept for the life of the process: a captured graph
    reads them by address.
    """
    if isinstance(values, (list, tuple)):
        values = tuple(float(v) for v in values)
    return _constant(values, dtype, torch.device(device))
