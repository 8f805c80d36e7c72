"""Learning-rate schedules (port of `gaussianmesh_tpu/utils/lr.py`).

`expon_lr` is the reference's log-lerp schedule with an optional delay
(utils/general_utils.py:29-62), a function of the optimizer step. It is
evaluated in float32, as the JAX package evaluates it under jit.
"""

from __future__ import annotations

import math

import torch


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """The learning rate at `step` (0-based, as the optimizer counts)."""
    if lr_init == lr_final == 0.0:
        return 0.0
    f32 = torch.float32
    s = torch.tensor(float(step), dtype=f32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0, 1))
    else:
        delay_rate = torch.tensor(1.0, dtype=f32)
    t = torch.clamp(s / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    # a negative step gives 0, as in the reference
    return 0.0 if step < 0 else float(delay_rate * log_lerp)
