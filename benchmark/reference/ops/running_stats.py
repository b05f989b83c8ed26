"""Running mean/std with the parallel (Chan et al.) update.

Counterpart of `ddiffpg_tpu/ops/running_stats.py` (the reference's
`RunningMeanStd`, utils/torch_util.py:99-145): the state is a tuple of
tensors, and every function returns a new one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningMeanStd(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar float32

    @staticmethod
    def create(shape=(), epsilon: float = 1e-4,
               device: str | torch.device = "cuda") -> "RunningMeanStd":
        f32 = dict(dtype=torch.float32, device=device)
        return RunningMeanStd(mean=torch.zeros(shape, **f32),
                              var=torch.ones(shape, **f32),
                              count=torch.tensor(epsilon, **f32))


def update(rms: RunningMeanStd, x: torch.Tensor) -> RunningMeanStd:
    """Fold the batch x [N, ...] in (population variance, as jnp.var)."""
    return update_from_stats(rms, x.mean(dim=0),
                             x.var(dim=0, unbiased=False), x.shape[0])


def update_from_stats(rms: RunningMeanStd, batch_mean, batch_var,
                      batch_count) -> RunningMeanStd:
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * rms.count * batch_count / tot
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def normalize(rms: RunningMeanStd, x: torch.Tensor,
              epsilon: float = 1e-4) -> torch.Tensor:
    return (x - rms.mean) / torch.sqrt(rms.var + epsilon)


def unnormalize(rms: RunningMeanStd, x: torch.Tensor,
                epsilon: float = 1e-4) -> torch.Tensor:
    return x * torch.sqrt(rms.var + epsilon) + rms.mean


def where(cond: torch.Tensor, a: RunningMeanStd,
          b: RunningMeanStd) -> RunningMeanStd:
    """a where the scalar bool tensor `cond` holds, else b (no host sync)."""
    return RunningMeanStd(*(torch.where(cond, x, y) for x, y in zip(a, b)))
