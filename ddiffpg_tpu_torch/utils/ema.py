"""Exponential moving average of parameters.

Counterpart of `ddiffpg_tpu/utils/ema.py:ema_update` (the reference's EMA
helper of the baseline diffusion path). The JAX version returns a new
pytree; here the average is updated in place.
"""

from __future__ import annotations

import torch


def _tensors(x) -> list:
    return list(x.parameters()) if isinstance(x, torch.nn.Module) else list(x)


@torch.no_grad()
def ema_update(ema, new, beta: float = 0.995):
    """ema <- beta * ema + (1 - beta) * new, in place, over two modules'
    parameters (in `parameters()` order) or two lists of tensors of the
    same shapes. Returns `ema`."""
    dst, src = _tensors(ema), _tensors(new)
    if len(dst) != len(src):
        raise ValueError(f"{len(dst)} tensors to average with {len(src)}")
    for e, n in zip(dst, src):
        e.copy_(e * beta + n * (1.0 - beta))
    return ema
