"""The self-contained baseline diffusion actor (the "DiffQ" path).

Counterpart of `ddiffpg_tpu/models/baseline_diffusion.py`: `BaselineMLP`
(:21, the eps model: an 8-frequency sinusoid of t, then three Mish layers
of 256 on [x, t emb, state]) and `Diffusion` (:39, a DDPM actor with a
selectable beta schedule, the predicted x0 clipped, and l2, l1 or huber
losses), and `Consistency` (:86, a one-step map from noise to action,
which no agent uses). Layers are initialised with flax `Dense`'s law, and
`utils/convert.py` loads the JAX package's weights exactly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ddiffpg_tpu_torch.models.diffusion import lecun_normal_
from ddiffpg_tpu_torch.ops import ddpm

__all__ = ["BaselineMLP", "Diffusion", "Consistency"]


class BaselineMLP(nn.Module):
    """eps_theta(x, t, state); `dense` in flax's Dense_0..Dense_3 order."""

    def __init__(self, action_dim: int, state_dim: int, hidden: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [action_dim + 16 + state_dim, hidden, hidden, hidden,
                  action_dim]
        self.dense = nn.ModuleList(nn.Linear(i, o)
                                   for i, o in zip(widths, widths[1:]))
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x, t, state):
        half = 8
        freqs = torch.exp(torch.arange(half, device=x.device,
                                       dtype=torch.float32)
                          * (-math.log(10000.0) / (half - 1)))
        temb = t[:, None].to(torch.float32) * freqs[None, :]
        h = torch.cat([x, torch.sin(temb), torch.cos(temb), state], dim=-1)
        for layer in self.dense[:3]:
            h = F.mish(layer(h))
        return self.dense[3](h)


class Diffusion(nn.Module):
    """DDPM actor over `BaselineMLP`: `sample` is the K-step reverse
    process (x0 clipped a step, the action clipped to +-max_action),
    `loss` the eps-prediction loss. The tables are non-persistent
    buffers."""

    def __init__(self, action_dim: int, state_dim: int,
                 n_timesteps: int = 5, beta_schedule: str = "vp",
                 max_action: float = 1.0, loss_type: str = "l2",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.action_dim = action_dim
        self.n_timesteps = n_timesteps
        self.max_action = max_action
        self.loss_type = loss_type
        self.model = BaselineMLP(action_dim, state_dim, generator=generator)
        tables = ddpm.make_tables(n_timesteps, beta_schedule, device)
        for name in ("betas", "alphas", "alphas_cumprod"):
            self.register_buffer(name, getattr(tables, name),
                                 persistent=False)
        self.to(device)

    @property
    def tables(self) -> ddpm.DDPMTables:
        return ddpm.DDPMTables(self.betas, self.alphas, self.alphas_cumprod,
                               self.n_timesteps)

    def forward(self, x, t, state):
        return self.model(x, t, state)

    @torch.no_grad()
    def act(self, state: torch.Tensor, *,
            generator: torch.Generator | None = None,
            x_init: torch.Tensor | None = None,
            noise: torch.Tensor | None = None) -> torch.Tensor:
        """`sample`: actions [B, A] for state [B, S]; `x_init` [B, A] and
        `noise` [K, B, A] are the standard-normal draws (from `generator`
        when not given)."""
        B = state.shape[0]
        if x_init is None:
            x_init = torch.randn((B, self.action_dim), generator=generator,
                                 device=state.device, dtype=state.dtype)

        def eps_fn(x, t):
            ts = torch.full((B,), float(t), device=state.device,
                            dtype=torch.float32)
            return self.model(x, ts, state)

        x = ddpm.reverse_scan(self.tables, eps_fn, x_init, noise, generator,
                              clip_sample=True)
        return torch.clamp(x, -self.max_action, self.max_action)

    def loss(self, state: torch.Tensor, action: torch.Tensor, *,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None,
             t: torch.Tensor | None = None, weights=1.0) -> torch.Tensor:
        """The eps-prediction loss of `action` [B, A] given `state`;
        `noise` [B, A] and `t` [B] are drawn from `generator` when not
        given."""
        B = action.shape[0]
        if noise is None:
            noise = torch.randn(action.shape, generator=generator,
                                device=action.device, dtype=action.dtype)
        if t is None:
            t = torch.randint(0, self.n_timesteps, (B,), generator=generator,
                              device=action.device)
        noisy = ddpm.add_noise(self.tables, action, noise, t)
        err = self.model(noisy, t.to(torch.float32), state) - noise
        if self.loss_type == "l1":
            per = err.abs().mean(-1)
        elif self.loss_type == "huber":
            per = torch.where(err.abs() < 1.0, 0.5 * err ** 2,
                              err.abs() - 0.5).mean(-1)
        else:
            per = (err ** 2).mean(-1)
        return (per * weights).mean()


class Consistency(nn.Module):
    """Consistency policy: one step from noise to action through the
    boundary-respecting skip parameterisation c_skip(t) x + c_out(t) F(x).
    The noise levels `ts` [n_timesteps + 1] (a non-persistent buffer) are
    computed in float32, as the JAX package does."""

    def __init__(self, action_dim: int, state_dim: int,
                 n_timesteps: int = 5, max_action: float = 1.0,
                 eps: float = 0.002, sigma_data: float = 0.5,
                 sigma_max: float = 80.0, rho: float = 7.0,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.action_dim = action_dim
        self.n_timesteps = n_timesteps
        self.max_action = max_action
        self.eps, self.sigma_data = eps, sigma_data
        self.model = BaselineMLP(action_dim, state_dim, generator=generator)
        i = torch.arange(n_timesteps + 1, dtype=torch.float32,
                         device=device)
        lo, hi = eps ** (1 / rho), sigma_max ** (1 / rho)
        self.register_buffer("ts", (lo + i / n_timesteps * (hi - lo)) ** rho,
                             persistent=False)
        self.to(device)

    def _f(self, x, t, state):
        sd = self.sigma_data
        c_skip = sd ** 2 / ((t - self.eps) ** 2 + sd ** 2)
        c_out = sd * (t - self.eps) / torch.sqrt(sd ** 2 + t ** 2)
        out = self.model(x, t, state)
        return c_skip[:, None] * x + c_out[:, None] * out

    def forward(self, state, *, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        return self.sample(state, generator=generator, noise=noise)

    def sample(self, state: torch.Tensor, *,
               generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Actions [B, A] for state [B, S], from the noise at the largest
        level; `noise` [B, A] is the standard normal draw (from
        `generator` when not given)."""
        B = state.shape[0]
        if noise is None:
            noise = torch.randn((B, self.action_dim), generator=generator,
                                device=state.device, dtype=state.dtype)
        t_max = self.ts[-1].expand(B)
        a = self._f(noise * self.ts[-1], t_max, state)
        return torch.clamp(a, -self.max_action, self.max_action)

    def loss(self, state: torch.Tensor, action: torch.Tensor, *,
             generator: torch.Generator | None = None,
             idx: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
        """Consistency loss of `action` [B, A]: the map at level idx
        against the detached map at idx - 1, on one noise. `idx` [B] (int
        in [1, n_timesteps]) and `noise` [B, A] are drawn from `generator`
        when not given."""
        B = action.shape[0]
        if idx is None:
            idx = torch.randint(1, self.n_timesteps + 1, (B,),
                                generator=generator, device=action.device)
        if noise is None:
            noise = torch.randn(action.shape, generator=generator,
                                device=action.device, dtype=action.dtype)
        t1, t0 = self.ts[idx], self.ts[idx - 1]
        f1 = self._f(action + t1[:, None] * noise, t1, state)
        f0 = self._f(action + t0[:, None] * noise, t0, state).detach()
        return torch.mean((f1 - f0) ** 2)
