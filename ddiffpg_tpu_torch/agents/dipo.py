"""DIPO: the diffusion-policy actor trained by the action gradient.

Counterpart of `ddiffpg_tpu/agents/dipo.py` (the reference's
algo/dipo.py). Beside TD3: the actor is the K-step DDPM policy
(`models/diffusion.py`, conditioned on the obs, no embedding), so the
critic's target actions take K reverse steps of the target actor; each
update pass improves the sampled rows' stored target actions by
`diffusion.update_times` Adam ascent steps on Q, writes them back into the
replay's target-action column, and distils them into the actor with the
epsilon-MSE loss.
"""

from __future__ import annotations

import dataclasses

import torch

from ddiffpg_tpu_torch.agents import base
from ddiffpg_tpu_torch.agents.td3 import AgentTD3, TD3State, UpdateDraws
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy
from ddiffpg_tpu_torch.models.mlp import q_min
from ddiffpg_tpu_torch.ops import optim
from ddiffpg_tpu_torch.replay import flat


class AgentDIPO(AgentTD3):
    name = "DIPO"

    def _make_actor(self, g):
        return DiffusionPolicy(self.action_dim, self.obs_dim,
                               self.cfg.diffusion.diffusion_iter,
                               device=self.device, generator=g)

    def draw_update(self, ts: TD3State) -> UpdateDraws:
        """The replay rows, the target actor's reverse process and
        smoothing noise, the actor loss's noise and steps."""
        B, A = self.cfg.algo.batch_size, self.action_dim
        K = self.cfg.diffusion.diffusion_iter
        return UpdateDraws(
            idx=flat.draw_indices(ts.replay, B, self.generator),
            target=base.TargetDraws(self._normal(B, A),
                                    self._normal(K, B, A),
                                    self._normal(B, A)),
            loss_noise=self._normal(B, A),
            loss_t=torch.randint(0, K, (B,), generator=self.generator,
                                 device=self.device))

    def update_once(self, ts: TD3State, draws: UpdateDraws | None = None,
                    mark=None):
        """One update pass in the JAX agent's order
        (`ddiffpg_tpu/agents/dipo.py:44-99`):
        sample, critic, RND on normalised obs, the action gradient on the
        sampled target actions and their write-back, the distillation,
        soft targets."""
        dcfg = self.cfg.diffusion
        d = draws or self.draw_update(ts)
        mark = mark or (lambda part: None)
        batch, idx = flat.sample(ts.replay, len(d.idx), idx=d.idx)
        obs, _, target_action, _, next_obs, _ = batch
        mark("sample")
        intr, c_loss, c_gn, r_int = self._critic_update(ts, batch, d.target)
        mark("critic update")
        # everything below sees normalised obs, as in the JAX agent
        n_obs, n_next = self._norm_obs(ts, obs), self._norm_obs(ts, next_obs)
        intr, d_loss, d_gn = self._rnd_update(intr, n_obs, n_next)
        mark("RND update")

        z = self.z[None, None]
        new_action = base.action_gradient(
            lambda act: q_min(ts.critic, z, n_obs[None], act),
            target_action[None], n_steps=dcfg.update_times,
            lr=dcfg.action_lr, max_grad_norm=self.cfg.algo.max_grad_norm)[0]
        flat.update_target_action(ts.replay, idx, new_action)
        mark("action gradient")

        a_loss = ts.actor.loss(n_obs, new_action, noise=d.loss_noise,
                               t=d.loss_t)
        params = list(ts.actor.parameters())
        a_gn = optim.apply_update(params, torch.autograd.grad(a_loss, params),
                                  ts.actor_opt, self.actor_spec)
        mark("actor loss and step")
        self._soft_targets(ts)
        mark("soft targets")
        logs = {"train/critic_loss": c_loss,
                "train/actor_loss": a_loss.detach(),
                "train/critic_grad": c_gn, "train/actor_grad": a_gn,
                "train/dynamic_loss": d_loss, "train/dynamic_grad": d_gn,
                "train/mean_action": new_action.abs().mean(),
                "train/mean_intrinsic": r_int.mean()}
        return dataclasses.replace(ts, intrinsic=intr), logs
