"""TD3 with the C51 double critic and the intrinsic reward: the baselines'
common core.

Counterpart of `ddiffpg_tpu/agents/td3.py` (the reference's algo/td3.py).
The JAX agent jits a train iteration (`horizon_len` env steps, then
`update_times` update passes) as one program over a donated state; here
the state's modules and tables are updated in place by eager PyTorch
calls, and nothing waits on the device within an iteration. Each env step
goes through the n-step window into the flat replay; each update pass
samples the replay, rewards with NovelD, updates the critic against the
smoothed target policy, the RND predictor and the actor, then the soft
targets. `AgentSAC`, `AgentDIPO` and `AgentDiffQ` derive from it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ddiffpg_tpu_torch.agents import base
from ddiffpg_tpu_torch.envs.base import EnvState
from ddiffpg_tpu_torch.intrinsic import IntrinsicModule, IntrinsicState
from ddiffpg_tpu_torch.models.mlp import (DistributionalDoubleQ,
                                          TanhMLPPolicy, q_min)
from ddiffpg_tpu_torch.ops import nstep as nstep_ops
from ddiffpg_tpu_torch.ops import optim
from ddiffpg_tpu_torch.ops import running_stats as rs
from ddiffpg_tpu_torch.replay import flat
from ddiffpg_tpu_torch.utils import trace


@dataclasses.dataclass
class TD3State:
    """The train state. Modules and tables are updated in place."""
    actor: nn.Module
    actor_target: nn.Module
    actor_opt: optim.AdamState
    critic: nn.Module
    critic_target: nn.Module
    critic_opt: optim.AdamState
    intrinsic: IntrinsicState
    replay: flat.FlatReplay
    nstep: nstep_ops.NStepState
    env_state: EnvState
    obs: torch.Tensor
    stats: base.EpisodeStats
    global_step: torch.Tensor                  # int64 scalar
    obs_rms: rs.RunningMeanStd | None = None   # with algo.obs_norm

    def to(self, device) -> "TD3State":
        """A copy of the whole state on `device` (a copy on any device)."""
        return base.to_device(self, device)


class EnvDraws(NamedTuple):
    """The draws of one env step: the warm-up's uniform actions [E, A] in
    [-1, 1), or the policy's and the exploration noise's normals."""
    uniform: torch.Tensor | None = None
    policy: base.TargetDraws | None = None


class UpdateDraws(NamedTuple):
    """Every random draw of one update pass of B rows (tests fill them
    from JAX's keys)."""
    idx: torch.Tensor                          # [B] replay rows
    target: base.TargetDraws | None = None     # target actor + smoothing
    loss_noise: torch.Tensor | None = None     # [B, A] diffusion loss
    loss_t: torch.Tensor | None = None         # [B] diffusion step
    next_noise: torch.Tensor | None = None     # [B, A] SAC's next action
    pi_noise: torch.Tensor | None = None       # [B, A] SAC's actor loss


def _pos_dim(env_name: str) -> int:
    return 2 if ("antmaze" in env_name or "pointmaze" in env_name) else 3


class AgentTD3:
    name = "TD3"

    def __init__(self, env, cfg, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        """Built on the card unless `device` says otherwise; the env must
        live on the same device. `generator` (on `device`) draws every
        random number of acting and updating; it defaults to one seeded
        with `cfg.seed`."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Agent{self.name}: no CUDA card; pass "
                               "device='cpu' for the agent on the CPU")
        inner = getattr(env, "env", env)
        if torch.device(inner.device) != self.device:
            raise ValueError(f"env on {inner.device}, agent on {self.device}")
        a = cfg.algo
        self.env = env
        self.cfg = cfg
        self.obs_dim = env.obs_dim
        self.action_dim = env.action_dim
        self.actor_spec = optim.make_optimizer(a.actor_lr, a.max_grad_norm)
        self.critic_spec = optim.make_optimizer(a.critic_lr, a.max_grad_norm)
        self.intrinsic = IntrinsicModule(
            self.obs_dim, kind=cfg.intrinsic.type,
            pos_dim=_pos_dim(cfg.env.name), normalize=cfg.intrinsic.normalize,
            pos_enc=cfg.intrinsic.pos_enc, L=cfg.intrinsic.L,
            warm_up=cfg.intrinsic.warm_up, scale=cfg.intrinsic.scale,
            depth_scale=cfg.intrinsic.depth_scale)
        self.generator = generator or torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        self.z = torch.linspace(a.v_min, a.v_max, a.num_atoms,
                                device=self.device)

    # ------------------------------------------------------------------ init

    def _make_actor(self, g: torch.Generator) -> nn.Module:
        return TanhMLPPolicy(self.obs_dim, self.action_dim,
                             generator=g).to(self.device)

    def _make_critic(self, g: torch.Generator) -> nn.Module:
        return DistributionalDoubleQ(self.obs_dim, self.action_dim, 1,
                                     self.cfg.algo.num_atoms,
                                     generator=g).to(self.device)

    def init(self, seed: int | None = None) -> TD3State:
        """A fresh state; weights are drawn on the CPU from `seed` (default
        cfg.seed), so both devices start alike."""
        a, dev = self.cfg.algo, self.device
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None
                                          else seed)
        actor, critic = self._make_actor(g), self._make_critic(g)
        intrinsic = self.intrinsic.init(dev, g)
        env_state, obs = self.env.reset()
        return TD3State(
            actor=actor, actor_target=copy.deepcopy(actor),
            actor_opt=optim.adam_init(list(actor.parameters())),
            critic=critic, critic_target=copy.deepcopy(critic),
            critic_opt=optim.adam_init(critic.params()),
            intrinsic=intrinsic,
            replay=flat.FlatReplay.create(int(a.memory_size), self.obs_dim,
                                          self.action_dim, dev),
            nstep=nstep_ops.NStepState.create(
                self.env.num_envs, a.nstep, self.obs_dim, self.action_dim,
                dev),
            env_state=env_state, obs=obs,
            stats=base.EpisodeStats.create(self.env.num_envs, a.tracker_len,
                                           dev),
            global_step=torch.zeros((), dtype=torch.int64, device=dev),
            obs_rms=(rs.RunningMeanStd.create((self.obs_dim,), device=dev)
                     if a.obs_norm else None))

    # ---------------------------------------------------------------- acting

    def _norm_obs(self, ts: TD3State, obs: torch.Tensor) -> torch.Tensor:
        return base.norm_obs(self.cfg, ts.obs_rms, obs)

    def _policy_action(self, ts: TD3State, obs: torch.Tensor,
                       draws: base.TargetDraws | None) -> torch.Tensor:
        """The explore action on normalised obs: the actor's plus noise."""
        it = ts.global_step / max(self.env.num_envs, 1)
        nz = self.cfg.algo.noise
        return base.explore_action(ts.actor, obs, nz,
                                   noise_val=base.noise_std(nz, it),
                                   generator=self.generator, draws=draws)

    # ----------------------------------------------------------- exploration

    def _env_step(self, ts: TD3State, random: bool,
                  draws: EnvDraws | None = None) -> TD3State:
        """One env step of every env: the rms folds the obs in (obs_norm),
        then uniform actions (warm-up) or the explore policy's, the env
        step, the timeout XOR, the n-step window and the flat add (rows
        written either way, ptr and size moved once the window is full)."""
        a = self.cfg.algo
        E, A = self.env.num_envs, self.action_dim
        d = draws or EnvDraws()
        if a.obs_norm and ts.obs_rms is not None:
            ts = dataclasses.replace(
                ts, obs_rms=base.update_rms(ts.obs_rms, ts.obs))
        if random:
            action = d.uniform if d.uniform is not None else torch.rand(
                (E, A), generator=self.generator,
                device=self.device) * 2.0 - 1.0
        else:
            action = self._policy_action(ts, self._norm_obs(ts, ts.obs),
                                         d.policy)
        env_state, next_obs, reward, done, info = self.env.step(
            ts.env_state, action)
        stats = base.update_stats(ts.stats, reward, done)
        done = done.to(torch.bool)
        done_b = done ^ info["time_outs"] if a.handle_timeout else done
        ns, (o0, a0, r_f, nobs_f, dn_f, valid) = nstep_ops.push(
            ts.nstep, ts.obs, action, (reward * a.reward_scale)[:, None],
            done_b[:, None], next_obs, a.gamma)
        flat.add(ts.replay, o0, a0, r_f[:, 0], nobs_f, dn_f[:, 0],
                 valid=valid)
        return dataclasses.replace(
            ts, env_state=env_state, obs=next_obs, nstep=ns, stats=stats,
            global_step=ts.global_step + E)

    def warmup(self, ts):
        """`algo.warm_up` env steps with uniform random actions."""
        for _ in range(int(self.cfg.algo.warm_up)):
            ts = self._env_step(ts, random=True)
        return ts

    # --------------------------------------------------------------- updates

    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def draw_update(self, ts: TD3State) -> UpdateDraws:
        """Every random draw of one update pass, from the agent's generator
        on its device (no host sync): the replay rows and the target
        smoothing noise."""
        B, A = self.cfg.algo.batch_size, self.action_dim
        return UpdateDraws(
            idx=flat.draw_indices(ts.replay, B, self.generator),
            target=base.TargetDraws(None, None, self._normal(B, A)))

    def _critic_update(self, ts: TD3State, batch, target: base.TargetDraws):
        """The C51 critic step. The intrinsic reward is added before obs
        normalisation (`ddiffpg_tpu/agents/td3.py:174-179`). Returns (intrinsic state, loss,
        grad norm, r_int)."""
        a = self.cfg.algo
        obs, action, _, reward, next_obs, done = batch
        r_int, intr = self.intrinsic.compute_reward(ts.intrinsic, obs,
                                                    next_obs)
        reward = reward + r_int
        obs, next_obs = self._norm_obs(ts, obs), self._norm_obs(ts, next_obs)
        next_actions = base.tgt_policy_action(
            ts.actor_target, next_obs, a.noise, generator=self.generator,
            draws=target)
        loss = base.distributional_critic_loss(
            ts.critic, ts.critic_target, self.z[None, None], obs[None],
            action[None], reward[None], next_obs[None], next_actions[None],
            done[None], a.gamma ** a.nstep, a.v_min, a.v_max,
            a.num_atoms)[0]
        params = ts.critic.params()
        gnorm = optim.apply_update(params, torch.autograd.grad(loss, params),
                                   ts.critic_opt, self.critic_spec)
        return intr, loss.detach(), gnorm, r_int

    def _q_min(self, critic, obs, action):
        return q_min(critic, self.z[None, None], obs[None], action[None])[0]

    def _rnd_update(self, intr: IntrinsicState, n_obs, n_next):
        """The RND predictor's step on normalised obs (and next obs with
        NovelD)."""
        if self.cfg.intrinsic.type == "noveld":
            return self.intrinsic.update(intr, torch.cat([n_obs, n_next]))
        return self.intrinsic.update(intr, n_obs)

    def _soft_targets(self, ts):
        a = self.cfg.algo
        base.soft_update(ts.critic_target.params(), ts.critic.params(),
                         a.tau)
        if a.no_tgt_actor:
            with torch.no_grad():
                for t, p in zip(ts.actor_target.parameters(),
                                ts.actor.parameters()):
                    t.copy_(p)
        else:
            base.soft_update(list(ts.actor_target.parameters()),
                             list(ts.actor.parameters()), a.tau)

    def update_once(self, ts: TD3State, draws: UpdateDraws | None = None,
                    mark=None):
        """One update pass in the JAX agent's order
        (`ddiffpg_tpu/agents/td3.py:213-247`):
        sample, critic, RND on normalised obs, actor, soft targets. The
        draws come from `draw_update` unless given; `mark`, when given, is
        called with each part's name as the part's span ends
        (`utils/trace.py:part`). Returns (state, logs of 0-d tensors)."""
        with trace.part("sample", mark):
            d = draws or self.draw_update(ts)
            batch, _ = flat.sample(ts.replay, len(d.idx), idx=d.idx)
            obs, _, _, _, next_obs, _ = batch
        with trace.part("critic update", mark):
            intr, c_loss, c_gn, r_int = self._critic_update(ts, batch,
                                                            d.target)
        with trace.part("RND update", mark):
            n_obs = self._norm_obs(ts, obs)
            n_next = self._norm_obs(ts, next_obs)
            intr, d_loss, d_gn = self._rnd_update(intr, n_obs, n_next)

        with trace.part("actor update", mark):
            action = ts.actor(n_obs)
            a_loss = -self._q_min(ts.critic, n_obs, action).mean()
            params = list(ts.actor.parameters())
            a_gn = optim.apply_update(
                params, torch.autograd.grad(a_loss, params), ts.actor_opt,
                self.actor_spec)
        with trace.part("soft targets", mark):
            self._soft_targets(ts)
        logs = {"train/critic_loss": c_loss,
                "train/actor_loss": a_loss.detach(),
                "train/critic_grad": c_gn, "train/actor_grad": a_gn,
                "train/dynamic_loss": d_loss, "train/dynamic_grad": d_gn,
                "train/mean_action": action.detach().abs().mean(),
                "train/mean_intrinsic": r_int.mean()}
        return dataclasses.replace(ts, intrinsic=intr), logs

    def train_iter(self, ts, steps: int | None = None):
        """`horizon_len` explore env steps, then `update_times` update
        passes; the logs are the passes' means. `steps` is unused (the
        baselines' cadence holds no state)."""
        for _ in range(self.cfg.algo.horizon_len):
            ts = self._env_step(ts, random=False)
        passes = []
        for _ in range(self.cfg.algo.update_times):
            ts, logs = self.update_once(ts)
            passes.append(logs)
        logs = {k: torch.stack([lg[k] for lg in passes]).mean()
                for k in passes[0]}
        logs["train/return"] = ts.stats.return_tracker.mean()
        logs["train/episode_length"] = ts.stats.step_tracker.mean()
        return ts, logs

    # ------------------------------------------------------------ evaluation

    def eval_actor(self, ts, obs: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   draws: base.TargetDraws | None = None) -> torch.Tensor:
        """The eval policy on the (normalised, with obs_norm) obs, with no
        exploration noise: TD3's is deterministic, SAC's samples, DIPO's
        and DiffQ's draw their reverse process from `generator`."""
        d = draws or base.TargetDraws(None, None, None)
        return ts.actor.act(self._norm_obs(ts, obs),
                              generator=generator or self.generator,
                              x_init=d.x_init, noise=d.step_noise)
