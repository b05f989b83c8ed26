"""SAC with auto-tuned alpha and the scalar double-Q critic.

Counterpart of `ddiffpg_tpu/agents/sac.py` (the reference's algo/sac.py).
Its state is TD3's (actor, critics, replay, window, env) with
`log_alpha` and alpha's optimizer, `optax.adamw(alpha_lr)` as in the JAX
agent: weight decay 1e-4 on the scalar and no gradient clip. It explores
by sampling its own squashed Gaussian.
"""

from __future__ import annotations

import dataclasses

import torch

from ddiffpg_tpu_torch.agents.td3 import AgentTD3, TD3State, UpdateDraws
from ddiffpg_tpu_torch.models.mlp import DoubleQ, TanhDiagGaussianMLPPolicy
from ddiffpg_tpu_torch.ops import optim
from ddiffpg_tpu_torch.replay import flat
from ddiffpg_tpu_torch.utils import trace


@dataclasses.dataclass(kw_only=True)
class SACState(TD3State):
    log_alpha: torch.Tensor        # float32 scalar
    alpha_opt: optim.AdamState


class AgentSAC(AgentTD3):
    name = "SAC"

    def __init__(self, env, cfg, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__(env, cfg, device, generator)
        self.alpha_spec = optim.OptimizerSpec(cfg.algo.alpha_lr,
                                              max_grad_norm=None)
        self.target_entropy = -float(env.action_dim)

    def _make_actor(self, g):
        return TanhDiagGaussianMLPPolicy(self.obs_dim, self.action_dim,
                                         generator=g).to(self.device)

    def _make_critic(self, g):
        return DoubleQ(self.obs_dim, self.action_dim,
                       generator=g).to(self.device)

    def init(self, seed: int | None = None) -> SACState:
        log_alpha = torch.zeros((), device=self.device)
        return SACState(**vars(super().init(seed)), log_alpha=log_alpha,
                        alpha_opt=optim.adam_init([log_alpha]))

    def _alpha(self, ts: SACState) -> torch.Tensor:
        if self.cfg.algo.alpha is not None:
            return torch.tensor(self.cfg.algo.alpha, device=self.device)
        return torch.exp(ts.log_alpha)

    def _policy_action(self, ts, obs, draws):
        """SAC explores by its own sampling
        (`ddiffpg_tpu/agents/sac.py:51-53`)."""
        x = None if draws is None else draws.x_init
        return ts.actor.act(obs, generator=self.generator, x_init=x)

    def draw_update(self, ts: SACState) -> UpdateDraws:
        """The replay rows and the two policy samples' normals."""
        B, A = self.cfg.algo.batch_size, self.action_dim
        return UpdateDraws(
            idx=flat.draw_indices(ts.replay, B, self.generator),
            next_noise=self._normal(B, A), pi_noise=self._normal(B, A))

    def update_once(self, ts: SACState, draws: UpdateDraws | None = None,
                    mark=None):
        """One update pass in the JAX agent's order
        (`ddiffpg_tpu/agents/sac.py:62-146`):
        sample, intrinsic reward (before obs normalisation), the MSE
        critic step against the entropy-regularised target, RND on
        normalised obs, the actor step, auto-alpha, soft targets; each
        part a span, `mark` as in TD3's."""
        a = self.cfg.algo
        with trace.part("sample", mark):
            d = draws or self.draw_update(ts)
            batch, _ = flat.sample(ts.replay, len(d.idx), idx=d.idx)
            obs, action, _, reward, next_obs, done = batch
            r_int, intr = self.intrinsic.compute_reward(ts.intrinsic, obs,
                                                        next_obs)
            reward = reward + r_int
            obs = self._norm_obs(ts, obs)
            next_obs = self._norm_obs(ts, next_obs)
            alpha = self._alpha(ts)

        sample = TanhDiagGaussianMLPPolicy.sample_logprob
        with trace.part("critic update", mark):
            with torch.no_grad():
                next_a, next_lp = sample(*ts.actor(next_obs),
                                         noise=d.next_noise)
                q1_t, q2_t = ts.critic_target(next_obs, next_a)
                target_q = reward + (1 - done) * (a.gamma ** a.nstep) * (
                    torch.minimum(q1_t, q2_t) - alpha * next_lp)
            q1, q2 = ts.critic(obs, action)
            c_loss = torch.mean((q1 - target_q) ** 2) + torch.mean(
                (q2 - target_q) ** 2)
            params = ts.critic.params()
            c_gn = optim.apply_update(
                params, torch.autograd.grad(c_loss, params), ts.critic_opt,
                self.critic_spec)
        with trace.part("RND update", mark):
            intr, d_loss, d_gn = self._rnd_update(intr, obs, next_obs)

        with trace.part("actor update", mark):
            act, lp = sample(*ts.actor(obs), noise=d.pi_noise)
            q1, q2 = ts.critic(obs, act)
            a_loss = (alpha * lp - torch.minimum(q1, q2)).mean()
            params = list(ts.actor.parameters())
            a_gn = optim.apply_update(
                params, torch.autograd.grad(a_loss, params), ts.actor_opt,
                self.actor_spec)

        with trace.part("alpha and soft targets", mark):
            if a.alpha is None:
                tgt = (-lp - self.target_entropy).detach()
                la = ts.log_alpha.detach().requires_grad_(True)
                (g,) = torch.autograd.grad((torch.exp(la) * tgt).mean(),
                                           [la])
                optim.apply_update([ts.log_alpha], [g], ts.alpha_opt,
                                   self.alpha_spec)
            self._soft_targets(ts)
        logs = {"train/critic_loss": c_loss.detach(),
                "train/actor_loss": a_loss.detach(),
                "train/critic_grad": c_gn, "train/actor_grad": a_gn,
                "train/dynamic_loss": d_loss, "train/dynamic_grad": d_gn,
                "train/alpha": torch.exp(ts.log_alpha),
                "train/mean_intrinsic": r_int.mean()}
        return dataclasses.replace(ts, intrinsic=intr), logs
