"""Learning-rate schedules (counterpart of ``event3dgs_tpu/core/schedules.py``).

The reference's Plenoxels-style exponential decay with an optional sine
warm-up (`utils/general_utils.py:29-62`).  The JAX package evaluates it in
float32 inside the jitted step; here it is evaluated on the host in numpy
float32, the same rounding, and returned as a Python float.
"""

from __future__ import annotations

import numpy as np


def exponential_lr(
    step,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> float:
    """Log-linear interpolation from lr_init to lr_final with optional delay.

    Matches reference `general_utils.py:47-62`: returns 0 for negative steps
    or an all-zero schedule; when ``lr_delay_steps > 0`` the rate is scaled by
    a reverse-cosine ease-in starting at ``lr_delay_mult``.
    """
    f32 = np.float32
    step = f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1))
        )
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return 0.0 if step < 0 else float(f32(delay_rate * log_lerp))
