"""Closed-form DDPM scheduler tables and steps.

Counterpart of `ddiffpg_tpu/ops/ddpm.py`: the `squaredcos_cap_v2` beta
schedule, epsilon prediction, `clip_sample=True` and the `fixed_small`
posterior variance of diffusers' `DDPMScheduler`. The tables are computed
in float64 with numpy and stored as float32 tensors; the K-step reverse
process is a Python loop over K (the JAX package's `lax.scan`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class DDPMTables(NamedTuple):
    betas: torch.Tensor            # [T]
    alphas: torch.Tensor           # [T]
    alphas_cumprod: torch.Tensor   # [T]
    num_timesteps: int


def squaredcos_cap_v2_betas(num_timesteps: int,
                            max_beta: float = 0.999) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal), capped at 0.999."""

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def linear_betas(num_timesteps: int, beta_start=1e-4,
                 beta_end=2e-2) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def vp_betas(num_timesteps: int, beta_min=0.1, beta_max=10.0) -> np.ndarray:
    """Variance-preserving SDE discrete betas."""
    t = np.arange(1, num_timesteps + 1, dtype=np.float64)
    T = num_timesteps
    alpha = np.exp(-beta_min / T
                   - 0.5 * (beta_max - beta_min) * (2 * t - 1) / T**2)
    return 1.0 - alpha


def make_tables(num_timesteps: int, schedule: str = "squaredcos_cap_v2",
                device: str | torch.device = "cuda") -> DDPMTables:
    """The schedule's tables as float32 tensors on `device` (the card
    unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_tables: no CUDA card; pass device='cpu' "
                           "for the tables on the CPU")
    if schedule in ("squaredcos_cap_v2", "cosine"):
        betas = squaredcos_cap_v2_betas(num_timesteps)
    elif schedule == "linear":
        betas = linear_betas(num_timesteps)
    elif schedule == "vp":
        betas = vp_betas(num_timesteps)
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return DDPMTables(betas=f32(betas), alphas=f32(alphas),
                      alphas_cumprod=f32(acp), num_timesteps=num_timesteps)


def add_noise(tables: DDPMTables, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0); t: int tensor of x0's leading shape."""
    acp = tables.alphas_cumprod[t]
    while acp.dim() < x0.dim():
        acp = acp[..., None]
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def step(tables: DDPMTables, eps_pred: torch.Tensor, t: int,
         x_t: torch.Tensor, noise: torch.Tensor,
         clip_sample: bool = True) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1} (epsilon parameterisation,
    fixed_small variance, predicted x0 clipped to [-1, 1]). `noise` is
    standard normal of x_t's shape and is not used at t == 0."""
    beta_t = tables.betas[t]
    alpha_t = tables.alphas[t]
    acp_t = tables.alphas_cumprod[t]
    acp_prev = tables.alphas_cumprod[t - 1] if t > 0 \
        else torch.ones_like(acp_t)

    x0 = (x_t - torch.sqrt(1.0 - acp_t) * eps_pred) / torch.sqrt(acp_t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t
    var = torch.clamp(beta_t * (1.0 - acp_prev) / (1.0 - acp_t), min=1e-20)
    sigma = torch.sqrt(var) if t > 0 else torch.zeros_like(var)
    return mean + sigma * noise


def reverse_scan(tables: DDPMTables,
                 eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 x_init: torch.Tensor, noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 clip_sample: bool = True) -> torch.Tensor:
    """The K-step reverse process from x_init, t = K-1 down to 0.

    `noise` [K, *x.shape] feeds step i (t = K-1-i) its standard normal
    draw; without it the draws come from `generator`.
    """
    T = tables.num_timesteps
    if noise is None:
        noise = torch.randn((T,) + tuple(x_init.shape), generator=generator,
                            device=x_init.device, dtype=x_init.dtype)
    elif noise.shape[0] != T or noise.shape[1:] != x_init.shape:
        raise ValueError(f"noise: want [{T}, *{tuple(x_init.shape)}], got "
                         f"{tuple(noise.shape)}")
    x = x_init
    for i in range(T):
        t = T - 1 - i
        x = step(tables, eps_fn(x, t), t, x, noise[i], clip_sample)
    return x
