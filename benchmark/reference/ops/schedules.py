"""Stateless schedules (pure functions of the step index).

Counterpart of `ddiffpg_tpu/ops/schedules.py`: the reference's stateful
Linear/Exponential/Tanh schedules as `value(step)`. `step` is a Python
number or a tensor; the result is a float32 tensor (on the step's device
when it is one).
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def linear(step, start_val: float, end_val: float, total_iters: int):
    ratio = torch.clamp(_f32(step / max(total_iters, 1)), 0.0, 1.0)
    return start_val + ratio * (end_val - start_val)


def exponential(step, start_val: float, gamma: float, end_val=None):
    val = _f32(start_val * gamma ** step)
    if end_val is not None:
        lo, hi = sorted((start_val, end_val))
        val = torch.clamp(val, lo, hi)
    return val


def tanh(step, start_step: int, end_step: int, gamma: float = 10e-6):
    center = (end_step - start_step) / 2
    return (torch.tanh(_f32(gamma * (step - center))) + 1.0) / 2.0
