"""The policies', the critics' and the novelty nets' MLPs.

Counterpart of `ddiffpg_tpu/models/mlp.py`: `MLPNet` (ELU, hidden 512,
256, 128), the baselines' `TanhMLPPolicy` (:40), `TanhDiagGaussianMLPPolicy`
(:67) and `DoubleQ` (:98), `DistributionalDoubleQ` (:114) and `RNDModel`
(:194), and the rest of the zoo, which no agent uses: `DiagGaussianMLPPolicy`
(:50), `DistributionalEnsembleQ` (:138), `MLPCritic` (:162) and
`DynamicModel` (:171). Layers
are initialised with flax's laws (lecun-normal kernels for `Dense`,
orthogonal(sqrt 2) for the RND nets, zero biases), so fresh modules have
the JAX package's weight statistics; `utils/convert.py` loads its weights
exactly.

The JAX package keeps one critic per group (the explore group and up to
`max_modes` behaviour modes) as a `[G_max]` stack of parameter trees that
`jax.vmap` consumes. Here the stack is explicit: `DistributionalDoubleQ`
holds every layer as one `[G_max, 2, in, out]` tensor (groups, then the
heads q1 and q2), and its forward pass runs the first `G` groups' both
heads as one batched matrix product per layer (`torch.baddbmm` over
`G * 2` matrices). One backward pass then gives every group's gradient,
and rows `G..` get none. TD3 and DIPO use it at one row.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.diffusion import lecun_normal_

__all__ = [
    "MLPNet", "TanhMLPPolicy", "DiagGaussianMLPPolicy",
    "TanhDiagGaussianMLPPolicy", "DoubleQ", "DistributionalDoubleQ",
    "DistributionalEnsembleQ", "MLPCritic", "DynamicModel", "RNDModel",
]

DEFAULT_HIDDEN = (512, 256, 128)


class MLPNet(nn.Module):
    """ELU MLP in -> hidden... -> out; `dense` in flax's Dense_0.. order.
    init "lecun" (flax Dense) or "orthogonal" (gain sqrt 2, as RNDModel)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 init: str = "lecun",
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.dense = nn.ModuleList(nn.Linear(i, o)
                                   for i, o in zip(widths, widths[1:]))
        for layer in self.dense:
            if init == "lecun":
                lecun_normal_(layer.weight, generator)
            elif init == "orthogonal":
                nn.init.orthogonal_(layer.weight, gain=math.sqrt(2.0),
                                    generator=generator)
            else:
                raise ValueError(f"unknown init {init!r}")
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = F.elu(layer(x))
        return self.dense[-1](x)


class TanhMLPPolicy(nn.Module):
    """Deterministic tanh policy (the TD3 actor)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = MLPNet(obs_dim, action_dim, hidden, generator=generator)

    def forward(self, obs):
        return torch.tanh(self.net(obs))

    @torch.no_grad()
    def act(self, obs, *, generator=None, x_init=None, noise=None):
        """The action [B, A]; it draws nothing."""
        return self(obs)


class DiagGaussianMLPPolicy(nn.Module):
    """Gaussian policy with a state-independent `logstd` parameter [A]:
    `forward` gives (mean, log_std broadcast to the mean's shape)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 init_log_std: float = 0.0,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = MLPNet(obs_dim, action_dim, hidden, generator=generator)
        self.logstd = nn.Parameter(torch.full((action_dim,),
                                              float(init_log_std)))

    def forward(self, obs):
        mean = self.net(obs)
        return mean, self.logstd.expand(mean.shape)

    @staticmethod
    def sample(mean, log_std, *, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
        """mean + exp(log_std) * noise; `noise` is the standard normal
        draw (from `generator` when not given)."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(log_std) * noise


class TanhDiagGaussianMLPPolicy(nn.Module):
    """Squashed Gaussian (the SAC actor): `forward` gives (mu, log_std),
    log_std clipped to [log_std_min, log_std_max]."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 log_std_min: float = -5.0, log_std_max: float = 5.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = MLPNet(obs_dim, 2 * action_dim, hidden,
                          generator=generator)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, obs):
        mu, log_std = torch.chunk(self.net(obs), 2, dim=-1)
        return mu, torch.clamp(log_std, self.log_std_min, self.log_std_max)

    @staticmethod
    def sample_logprob(mu, log_std, *,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None):
        """rsample and the tanh-squashed log-prob [B, 1], with log|d tanh/dx|
        in the stable softplus form. `noise` is the standard normal draw
        (from `generator` when not given)."""
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        std = torch.exp(log_std)
        x = mu + std * noise
        base_lp = -0.5 * (((x - mu) / std) ** 2 + 2 * log_std
                          + math.log(2 * math.pi))
        jac = 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))
        return torch.tanh(x), (base_lp - jac).sum(-1, keepdim=True)

    @torch.no_grad()
    def act(self, obs, *, generator=None, x_init=None, noise=None):
        """A sampled action [B, A]; `x_init` is its standard-normal draw
        (from `generator` when not given)."""
        return self.sample_logprob(*self(obs), generator=generator,
                                   noise=x_init)[0]


class DoubleQ(nn.Module):
    """Two scalar Q MLPs on [obs, action] (the SAC critic)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.q1 = MLPNet(obs_dim + action_dim, 1, hidden, generator=generator)
        self.q2 = MLPNet(obs_dim + action_dim, 1, hidden, generator=generator)

    def params(self) -> list:
        return list(self.parameters())

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return self.q1(x), self.q2(x)


class DistributionalDoubleQ(nn.Module):
    """C51 double critics for `rows` groups: two softmax heads over
    `num_atoms` atoms on [obs, action]. Every row starts as a copy of
    row 0 (the JAX agent's `init` broadcasts the explore critic)."""

    def __init__(self, obs_dim: int, action_dim: int, rows: int,
                 num_atoms: int = 51, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        heads = [MLPNet(obs_dim + action_dim, num_atoms, hidden,
                        generator=generator).dense for _ in range(2)]

        def stack(xs):      # [rows, 2, ...], every row the same
            x = torch.stack([t.detach() for t in xs])
            return nn.Parameter(x[None].repeat(rows, *(1,) * x.dim()))

        n = len(heads[0])
        self.weight = nn.ParameterList(
            stack([h[k].weight.T for h in heads]) for k in range(n))
        self.bias = nn.ParameterList(
            stack([h[k].bias for h in heads]) for k in range(n))

    def params(self) -> list:
        """Parameters in the order the optimizer state keeps them."""
        return [*self.weight, *self.bias]

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        """obs [G, b, D], action [G, b, A] for groups 0..G-1 ->
        (q1, q2), each [G, b, num_atoms] probabilities."""
        G, b = obs.shape[:2]
        x = torch.cat([obs, action], dim=-1)
        h = x[:, None].expand(G, 2, b, x.shape[-1]).reshape(G * 2, b, -1)
        last = len(self.weight) - 1
        for i, (w, bias) in enumerate(zip(self.weight, self.bias)):
            h = torch.baddbmm(bias[:G].reshape(G * 2, 1, -1), h,
                              w[:G].reshape(G * 2, *w.shape[2:]))
            if i < last:
                h = F.elu(h)
        q = torch.softmax(h.reshape(G, 2, b, -1), dim=-1)
        return q[:, 0], q[:, 1]


class DistributionalEnsembleQ(nn.Module):
    """`n_ensemble` C51 critics on [obs, action]: `forward` gives their
    softmaxes [n, B, num_atoms], `q_mean` the mean over the ensemble of
    each one's expected value on the atoms `z_atoms`."""

    def __init__(self, obs_dim: int, action_dim: int, v_min: float = -10.0,
                 v_max: float = 10.0, num_atoms: int = 51,
                 n_ensemble: int = 3, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads = nn.ModuleList(
            MLPNet(obs_dim + action_dim, num_atoms, hidden,
                   generator=generator) for _ in range(n_ensemble))
        self.register_buffer("z_atoms", torch.linspace(v_min, v_max,
                                                       num_atoms),
                             persistent=False)

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return torch.stack([torch.softmax(h(x), dim=-1)
                            for h in self.heads])

    def q_mean(self, obs, action):
        return (self(obs, action) * self.z_atoms).sum(-1).mean(0)


class MLPCritic(nn.Module):
    """State-value MLP: obs -> [B, 1]."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = MLPNet(obs_dim, 1, hidden, generator=generator)

    def forward(self, obs):
        return self.net(obs)


class DynamicModel(nn.Module):
    """Ensemble of forward-dynamics MLPs on [obs, action]: `forward` gives
    their predictions [n, B, obs_dim]; `disagreement_reward` [B] is the
    variance over the ensemble (unbiased, as the JAX package's ddof=1),
    averaged over the obs dimensions."""

    def __init__(self, obs_dim: int, action_dim: int, n_ensemble: int = 3,
                 hidden: Sequence[int] = DEFAULT_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads = nn.ModuleList(
            MLPNet(obs_dim + action_dim, obs_dim, hidden, generator=generator)
            for _ in range(n_ensemble))

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return torch.stack([h(x) for h in self.heads])

    def disagreement_reward(self, obs, action):
        return self(obs, action).var(dim=0, correction=1).mean(dim=-1)


def q_min(critic: DistributionalDoubleQ, z: torch.Tensor, obs, action):
    """min over the two heads of the expected value on atoms z [G, 1, A]:
    [G, b]."""
    q1, q2 = critic(obs, action)
    return torch.minimum((q1 * z).sum(-1), (q2 * z).sum(-1))


class RNDModel(nn.Module):
    """Random-network distillation: a trained predictor and a target net,
    both in -> 512 -> 256 -> 128 -> feat_dim with ELU, orthogonal(sqrt 2)
    init and zero bias. The target's output is detached; its parameters
    still sit in the optimizer (adamw decays them, as in the JAX
    package)."""

    def __init__(self, in_dim: int, feat_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pred = MLPNet(in_dim, feat_dim, init="orthogonal",
                           generator=generator)
        self.tgt = MLPNet(in_dim, feat_dim, init="orthogonal",
                          generator=generator)

    def params(self) -> list:
        return list(self.parameters())

    def forward(self, x):
        return self.pred(x), self.tgt(x).detach()
