"""DDPM diffusion policy, the DDiffPG actor (acting half).

Counterpart of `ddiffpg_tpu/models/diffusion.py`: the noise-prediction net
is a sinusoidal time embedding -> 256->1024->256 Mish time-MLP, then a
1024-512-256 Mish trunk on [time emb, cond, x] -> action. The K-step
reverse denoise (ops/ddpm.py) is a Python loop of plain matrix products.
Layers are initialised with flax `Dense`'s law (lecun-normal kernel, zero
bias), so a freshly made policy has the JAX package's weight statistics;
`utils/convert.py` loads the JAX package's weights exactly. `loss` is the
DDPM epsilon-prediction loss that distils the actor in the update pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ddiffpg_tpu_torch.ops import ddpm

__all__ = ["SinusoidalPosEmb", "DiffusionNet", "DiffusionPolicy"]

# std of a unit normal truncated to [-2, 2] (flax's truncated_normal init)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax lecun_normal on a torch [out, in] weight: a normal truncated to
    [-2, 2] sigma with variance 1/fan_in, drawn by inverse CDF."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    with torch.no_grad():
        u = torch.rand(weight.shape, generator=generator,
                       device=weight.device) * (hi - lo) + lo
        w = torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)
        return weight.copy_(torch.clamp(w, -2.0 * std, 2.0 * std))


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device,
                                       dtype=torch.float32)
                          * (-math.log(10000.0) / (half - 1)))
        x = t[:, None].to(torch.float32) * freqs[None, :]
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class DiffusionNet(nn.Module):
    """eps_theta(x, t, cond). `dense` holds the six layers in the flax
    module's order Dense_0..Dense_5."""

    def __init__(self, action_dim: int, cond_dim: int, dim: int = 256):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim)
        widths = [(dim, dim * 4), (dim * 4, dim),
                  (dim + cond_dim + action_dim, 1024), (1024, 512),
                  (512, 256), (256, action_dim)]
        self.dense = nn.ModuleList(nn.Linear(i, o) for i, o in widths)

    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x, t, cond):
        d = self.dense
        temb = d[1](F.mish(d[0](self.pos_emb(t))))
        h = torch.cat([temb, cond, x], dim=-1)
        for layer in d[2:5]:
            h = F.mish(layer(h))
        return d[5](h)


class DiffusionPolicy(nn.Module):
    """K-step DDPM policy head: `forward` is the eps prediction, `act` the
    K-step reverse denoise to an action in [-1, 1], `loss` the training
    loss. The schedule's tables are non-persistent buffers, so `.to()` and
    `copy.deepcopy` carry them and the state dict holds the weights
    only."""

    def __init__(self, action_dim: int, cond_dim: int,
                 diffusion_iter: int = 5, dim: int = 256,
                 schedule: str = "squaredcos_cap_v2",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        """Built on the card unless `device` says otherwise (on a machine
        without one, only `device="cpu"` builds). `generator` (a CPU
        generator) draws the initial weights."""
        super().__init__()
        self.action_dim = action_dim
        self.diffusion_iter = diffusion_iter
        self.net = DiffusionNet(action_dim, cond_dim, dim)
        self.net.reset_parameters(generator)
        # first the tables: without a card they raise for device="cuda"
        tables = ddpm.make_tables(diffusion_iter, schedule, device)
        for name in ("betas", "alphas", "alphas_cumprod"):
            self.register_buffer(name, getattr(tables, name),
                                 persistent=False)
        self.to(device)

    @property
    def tables(self) -> ddpm.DDPMTables:
        return ddpm.DDPMTables(self.betas, self.alphas, self.alphas_cumprod,
                               self.diffusion_iter)

    def forward(self, x, t, cond):
        return self.net(x, t, cond)

    @torch.no_grad()
    def act(self, cond: torch.Tensor, *,
            generator: torch.Generator | None = None,
            x_init: torch.Tensor | None = None,
            noise: torch.Tensor | None = None) -> torch.Tensor:
        """Actions [B, A] for cond [B, C]. `x_init` [B, A] and `noise`
        [K, B, A] are the standard-normal draws (drawn from `generator`
        when not given)."""
        B = cond.shape[0]
        if x_init is None:
            x_init = torch.randn((B, self.action_dim), generator=generator,
                                 device=cond.device, dtype=cond.dtype)

        def eps_fn(x, t):
            ts = torch.full((B,), float(t), device=cond.device,
                            dtype=torch.float32)
            return self.net(x, ts, cond)

        return ddpm.reverse_scan(self.tables, eps_fn, x_init, noise,
                                 generator)

    def loss(self, cond: torch.Tensor, action: torch.Tensor, *,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None,
             t: torch.Tensor | None = None) -> torch.Tensor:
        """Epsilon-prediction MSE of the target actions [B, A] given cond
        [B, C]. `noise` [B, A] (standard normal) and `t` [B] (int in
        [0, K)) are drawn from `generator` when not given; the net sees t
        as float32."""
        B = action.shape[0]
        if noise is None:
            noise = torch.randn(action.shape, generator=generator,
                                device=action.device, dtype=action.dtype)
        if t is None:
            t = torch.randint(0, self.diffusion_iter, (B,),
                              generator=generator, device=action.device)
        noisy = ddpm.add_noise(self.tables, action, noise, t)
        eps = self.net(noisy, t.to(torch.float32), cond)
        return torch.mean((eps - noise) ** 2)
