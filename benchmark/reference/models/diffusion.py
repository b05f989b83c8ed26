"""DDPM diffusion policy, the DDiffPG actor (acting half).

Counterpart of `ddiffpg_tpu/models/diffusion.py`: the noise-prediction net
is a sinusoidal time embedding -> 256->1024->256 Mish time-MLP, then a
1024-512-256 Mish trunk on [time emb, cond, x] -> action. The K-step
reverse denoise (ops/ddpm.py) is a Python loop of plain matrix products.
Layers are initialised with flax `Dense`'s law (lecun-normal kernel, zero
bias), so a freshly made policy has the JAX package's weight statistics;
`utils/convert.py` loads the JAX package's weights exactly. `loss` is the
DDPM epsilon-prediction loss that distils the actor in the update pass.

Beside it, as in the JAX package and used by no agent: the residual trunk
`MLPResNet` (:67) and `EBMDiffusionPolicy` (:129), whose score is the
gradient of an energy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import ddpm

__all__ = ["SinusoidalPosEmb", "DiffusionNet", "MLPResNet", "DiffusionPolicy",
           "EBMDiffusionPolicy"]

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


class MLPResNetBlock(nn.Module):
    """x + Dense(Mish(Dense_4f(LayerNorm(dropout(x))))); flax's LayerNorm
    epsilon (1e-6). Dropout acts only when `deterministic` is false, as
    in flax (`MLPResNet` never turns it on)."""

    def __init__(self, features: int, use_layer_norm: bool = True,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = nn.LayerNorm(features, eps=1e-6) if use_layer_norm \
            else None
        self.dense = nn.ModuleList([nn.Linear(features, features * 4),
                                    nn.Linear(features * 4, features)])
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x, deterministic: bool = True):
        residual = x
        if self.dropout_rate > 0.0:
            x = F.dropout(x, self.dropout_rate, training=not deterministic)
        if self.norm is not None:
            x = self.norm(x)
        return residual + self.dense[1](F.mish(self.dense[0](x)))


class MLPResNet(nn.Module):
    """Residual trunk: Dense(hidden), `num_blocks` residual blocks, Mish,
    Dense(out)."""

    def __init__(self, in_dim: int, out_dim: int, num_blocks: int = 3,
                 hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense_in = nn.Linear(in_dim, hidden_dim)
        self.blocks = nn.ModuleList(MLPResNetBlock(hidden_dim,
                                                   generator=generator)
                                    for _ in range(num_blocks))
        self.dense_out = nn.Linear(hidden_dim, out_dim)
        for layer in (self.dense_in, self.dense_out):
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        x = self.dense_in(x)
        for block in self.blocks:
            x = block(x)
        return self.dense_out(F.mish(x))


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


class EBMDiffusionPolicy(DiffusionPolicy):
    """Energy-parameterised variant: E(x) = ||net(x, t, cond) - x||^2, and
    `forward` (the score) is dE/dx. `act` and `loss` are the parent's,
    on the net itself, as in the JAX package; `logprob` and `entropy`
    follow `ddiffpg_tpu/models/diffusion.py:143-162`."""

    def neg_logp_unnorm(self, x, t, cond):
        return ((self.net(x, t, cond) - x) ** 2).sum(-1)

    def forward(self, x, t, cond):
        """dE/dx [B, A], with its graph kept (`create_graph`), so that a
        loss on the score trains the net through it."""
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            e = self.neg_logp_unnorm(x, t, cond).sum()
            return torch.autograd.grad(e, x, create_graph=True)[0]

    def logprob(self, x, t, cond, action_buf):
        """log p(x | cond) [B1] against the partition function over the
        sample buffer `action_buf` [B2, A] at t = 0."""
        B1, B2 = cond.shape[0], action_buf.shape[0]
        E = self.neg_logp_unnorm(x, t, cond)
        a = action_buf.repeat(B1, 1)
        c = cond.repeat_interleave(B2, dim=0)
        t2 = torch.zeros((B1 * B2,), dtype=torch.float32, device=x.device)
        Z = torch.exp(-self.neg_logp_unnorm(a, t2, c)).reshape(B1, B2).sum(-1)
        return -E - torch.log(Z)

    def entropy(self, cond, logZ, num_action: int = 50, *,
                generator: torch.Generator | None = None,
                x_init: torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
        """Monte-Carlo entropy [B]: the mean energy at t = 0 of
        `num_action` sampled actions per cond row, plus logZ. `x_init`
        [B * num_action, A] and `noise` [K, B * num_action, A] are the
        sampler's draws (from `generator` when not given)."""
        B = cond.shape[0]
        c = cond.repeat_interleave(num_action, dim=0)
        a = self.act(c, generator=generator, x_init=x_init, noise=noise)
        t = torch.zeros((B * num_action,), dtype=torch.float32,
                        device=cond.device)
        E = self.neg_logp_unnorm(a, t, c).reshape(B, num_action).mean(dim=1)
        return E + logZ
