"""Exploration noise (counterpart of `ddiffpg_tpu/ops/noise.py`).

`add_mixed_normal_noise` anneals the noise std linearly across the env
batch (std linspace std_min -> std_max over envs, in the action dtype).
Each sampler takes an optional explicit standard-normal `noise`; without it
the draw comes from `generator`.
"""

from __future__ import annotations

import torch


class FixedNormalActionNoise:
    """Stateless N(mean, std) action-noise sampler with optional truncation
    (the reference's utils/noise.py:5-16); a call draws from `generator`
    where the JAX sampler takes a key."""

    def __init__(self, mean, std, bounds=None):
        self.mean = mean
        self.std = std
        self.bounds = bounds

    def __call__(self, generator: torch.Generator, shape=(),
                 truncated: bool = False) -> torch.Tensor:
        """A draw of `shape` from `generator`, on its device."""
        s = torch.randn(shape, generator=generator,
                        device=generator.device) * self.std + self.mean
        if truncated and self.bounds is not None:
            s = torch.clamp(s, self.bounds[0], self.bounds[1])
        return s


def _normal(x, noise, generator):
    if noise is None:
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)
    if noise.shape != x.shape:
        raise ValueError(f"noise {tuple(noise.shape)} != x {tuple(x.shape)}")
    return noise


def _finish(x, noise, noise_bounds, out_bounds):
    if noise_bounds is not None:
        noise = torch.clamp(noise, noise_bounds[0], noise_bounds[1])
    out = x + noise
    if out_bounds is not None:
        out = torch.clamp(out, out_bounds[0], out_bounds[1])
    return out


def add_normal_noise(x, std, noise_bounds=None, out_bounds=None, *,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None):
    return _finish(x, _normal(x, noise, generator) * std, noise_bounds,
                   out_bounds)


def add_mixed_normal_noise(x, std_min, std_max, noise_bounds=None,
                           out_bounds=None, *,
                           generator: torch.Generator | None = None,
                           noise: torch.Tensor | None = None):
    std_seq = torch.linspace(std_min, std_max, x.shape[0], dtype=x.dtype,
                             device=x.device)[:, None]
    return _finish(x, _normal(x, noise, generator) * std_seq, noise_bounds,
                   out_bounds)
