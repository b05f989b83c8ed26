"""DDiffPG: the collect path and the training iteration.

Counterpart of `ddiffpg_tpu/agents/ddiffpg.py`. `explore_actions` and
`collect` are the acting half (mode-embedding mixing -> K-step DDPM
reverse denoise -> exploration noise -> one batched env step, the physics
kernel on a card). `AgentDDiffPG` adds the rest of a train iteration: the
episodic replay write of every env step, and `update_times` update passes,
each sampling every live group, rewarding with NovelD, updating the
per-group C51 critics, improving the sampled target actions by the action
gradient, distilling the actor and updating the RND predictor.

The JAX agent jits a train iteration as one program over a donated state.
Here the state's tensors and modules are updated in place by eager PyTorch
calls; the only host waits are the replay's flush (one per env step) and
reading `global_step` for the explore ratio when the caller passes no step
count. At eval cadence `update_cluster` reclusters the stored successes
(`modes/cluster.py`, its DTW on the card through `csrc/dtw.cu`) and
applies the Q-scheduler's plan to the replay's groups, the critic rows,
their optimizer rows and the mode embeddings.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import NamedTuple

import torch

from ddiffpg_tpu_torch.agents import base
from ddiffpg_tpu_torch.envs.base import EnvState
from ddiffpg_tpu_torch.intrinsic import IntrinsicModule, IntrinsicState
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy
from ddiffpg_tpu_torch.models.mlp import DistributionalDoubleQ, q_min
from ddiffpg_tpu_torch.modes.cluster import ClusterManager
from ddiffpg_tpu_torch.ops import optim
from ddiffpg_tpu_torch.ops import running_stats as rs
from ddiffpg_tpu_torch.ops.embedding import add_embedding, append_embedding
from ddiffpg_tpu_torch.ops.noise import (add_mixed_normal_noise,
                                         add_normal_noise)
from ddiffpg_tpu_torch.physics import maze
from ddiffpg_tpu_torch.replay import episodic as ep
from ddiffpg_tpu_torch.utils import density, trace


def explore_actions(policy, obs: torch.Tensor, p, embeddings: torch.Tensor,
                    num_modes, std_min: float, std_max: float, *,
                    noise_type: str = "mixed",
                    generator: torch.Generator | None = None,
                    zero_mask: torch.Tensor | None = None,
                    x_init: torch.Tensor | None = None,
                    step_noise: torch.Tensor | None = None,
                    action_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Exploration actions [B, A] in [-1, 1] for obs [B, obs_dim].

    embeddings [G_max, E]: row 0 is the explore embedding, rows 1.. the
    behaviour modes, of which `num_modes` are live (0: none yet). A
    fraction `p` of the batch acts in exploit mode (ops/embedding.py).
    noise_type "mixed" anneals the noise std from std_min to std_max across
    the batch; any other type adds N(0, std_max) (the JAX agent's branch).
    The random draws — `zero_mask` [B], `x_init` [B, A], `step_noise`
    [K, B, A], `action_noise` [B, A] — come from `generator` unless given.
    """
    with trace.span("actor"):
        emb_obs = add_embedding(obs, embeddings[0], p, embeddings[1:],
                                num_modes, generator=generator,
                                zero_mask=zero_mask)
        action = policy.act(emb_obs, generator=generator, x_init=x_init,
                            noise=step_noise)
        if noise_type == "mixed":
            return add_mixed_normal_noise(action, std_min, std_max,
                                          out_bounds=(-1.0, 1.0),
                                          generator=generator,
                                          noise=action_noise)
        return add_normal_noise(action, std_max, out_bounds=(-1.0, 1.0),
                                generator=generator, noise=action_noise)


class Rollout(NamedTuple):
    """Per-control-step records of `collect`, stacked on a leading [T]."""
    action: torch.Tensor    # [T, B, A]
    obs: torch.Tensor       # [T, B, obs_dim] next obs (true terminal obs)
    reward: torch.Tensor    # [T, B]
    done: torch.Tensor      # [T, B] bool
    success: torch.Tensor   # [T, B] int32 goal id + 1 (0: none)


def collect(env, policy, state, obs: torch.Tensor, n_steps: int, p,
            embeddings: torch.Tensor, num_modes, std_min: float,
            std_max: float, generator: torch.Generator | None = None):
    """`n_steps` control steps of explore_actions + env.step.

    Like the JAX agent, the obs carried to the next step is the one `step`
    returned (the true terminal obs for an env that just reset). Returns
    (state, obs, Rollout).
    """
    rec = {k: [] for k in Rollout._fields}
    for _ in range(n_steps):
        with trace.span("collect_step"):
            action = explore_actions(policy, obs, p, embeddings, num_modes,
                                     std_min, std_max, generator=generator)
            state, obs, reward, done, info = env.step(state, action)
        for k, v in (("action", action), ("obs", obs), ("reward", reward),
                     ("done", done), ("success", info["success"])):
            rec[k].append(v)
    return state, obs, Rollout(**{k: torch.stack(v) for k, v in rec.items()})


def _pos_dim(env_name: str) -> int:
    return 2 if ("antmaze" in env_name or "pointmaze" in env_name) else 3


@dataclasses.dataclass
class DDiffPGState:
    """The train state. Modules and tables are updated in place."""
    actor: DiffusionPolicy
    actor_opt: optim.AdamState
    critics: DistributionalDoubleQ          # [G_max] rows
    critic_targets: DistributionalDoubleQ
    critic_opts: optim.AdamState            # count [G_max]
    embeddings: torch.Tensor                # [G_max, E]; row 0: explore
    intrinsic: IntrinsicState
    replay: ep.EpisodicReplay
    env_state: EnvState
    obs: torch.Tensor
    stats: base.EpisodeStats
    global_step: torch.Tensor               # int64 scalar
    density_grid: torch.Tensor              # [res, res] int32

    obs_rms: rs.RunningMeanStd | None = None   # with algo.obs_norm

    def to(self, device) -> "DDiffPGState":
        """A copy of the whole state on `device` (a copy on any device)."""
        return base.to_device(self, device)


class UpdateDraws(NamedTuple):
    """Every random draw of one update pass at G groups of b samples
    (n = G b rows); tests fill them from JAX's keys."""
    u: torch.Tensor                  # [G, b] int: each group's buffer draw
    emb_masks: torch.Tensor          # [2G, b] bool: zero-embedding rows
    target: base.TargetDraws         # target actor + smoothing, n rows
    loss_noise: torch.Tensor         # [n, A] actor loss noise
    loss_t: torch.Tensor             # [n] int diffusion step
    u_success: torch.Tensor | None = None   # [G, b], with success_bias
    u_frontier: torch.Tensor | None = None  # [b], with the frontier share


class AgentDDiffPG:
    name = "DDiffPG"

    def __init__(self, env, cfg, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        """Built on the card unless `device` says otherwise; the env must
        live on the same device. `generator` (on `device`) draws every
        random number of acting and updating; it defaults to one seeded
        with `cfg.seed`."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AgentDDiffPG: no CUDA card; pass "
                               "device='cpu' for the agent on the CPU")
        inner = getattr(env, "env", env)
        if torch.device(inner.device) != self.device:
            raise ValueError(f"env on {inner.device}, agent on {self.device}")
        a = cfg.algo
        self.env = env
        self.cfg = cfg
        self.obs_dim = env.obs_dim
        self.action_dim = env.action_dim
        self.embed_dim = a.embedding_dim
        self.G_max = a.max_modes + 1
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
        self.cluster_manager = ClusterManager(
            capacity=int(a.memory_size), max_modes=a.max_modes,
            threshold=a.cluster_threshold,
            use_downsampling=a.use_downsampling,
            traj_dim=_pos_dim(cfg.env.name), seed=cfg.seed,
            split_by_goal=a.split_by_goal, device=self.device)
        self.num_groups = 1
        self.num_clusters = 0
        self.last_goal_counts = {}       # goal id -> replay success count
        self.last_plot = None
        self.last_unsuccess_plot = None

        if "antmaze" in cfg.env.name or "pointmaze" in cfg.env.name:
            self._maze_map = maze.MAZES[cfg.env.name.replace("pointmaze",
                                                             "antmaze")]
            grid, self._density_reset, self._num_free = density.create_grid(
                self._maze_map, cfg.env.resolution)
            self._density_grid0 = torch.as_tensor(grid)
        else:
            self._maze_map = None
            self._density_grid0 = torch.zeros((1, 1), dtype=torch.int32)
            self._num_free = 1
        gxy = getattr(inner, "goal_xy", None)
        self._goal_xy = None if gxy is None else gxy.to(self.device)
        self._frontier_goals = 1 if gxy is None else int(gxy.shape[0])
        if a.obs_norm:
            warnings.warn(
                "algo.obs_norm=true with DDiffPG: acting/eval use normalized"
                " obs but critic/actor updates train on RAW obs (faithful to"
                " the reference, see _norm_obs) — a train/act distribution"
                " mismatch that can silently degrade learning.")

    # ------------------------------------------------------------------ init

    def init(self, seed: int | None = None) -> DDiffPGState:
        """A fresh state; weights and embeddings are drawn on the CPU from
        `seed` (default cfg.seed), so both devices start alike."""
        a = self.cfg.algo
        g = torch.Generator().manual_seed(self.cfg.seed if seed is None
                                          else seed)
        actor = DiffusionPolicy(
            self.action_dim, self.obs_dim + self.embed_dim,
            self.cfg.diffusion.diffusion_iter, device=self.device,
            generator=g)
        critics = DistributionalDoubleQ(
            self.obs_dim, self.action_dim, self.G_max, a.num_atoms,
            generator=g).to(self.device)
        embeddings = torch.randn((self.G_max, self.embed_dim),
                                 generator=g).to(self.device)
        intrinsic = self.intrinsic.init(self.device, g)
        env_state, obs = self.env.reset()
        return DDiffPGState(
            actor=actor, actor_opt=optim.adam_init(list(actor.parameters())),
            critics=critics, critic_targets=copy.deepcopy(critics),
            critic_opts=optim.adam_init(critics.params(), rows=1),
            embeddings=embeddings, intrinsic=intrinsic,
            # the slot allocation parks non-finishing envs on distinct
            # slots in the JAX package, hence >= 2 * num_envs slots
            replay=ep.EpisodicReplay.create(
                max(int(a.memory_size), 2 * self.env.num_envs),
                self.env.max_episode_length, self.env.num_envs,
                self.obs_dim, self.action_dim, self.G_max,
                num_goals=self._frontier_goals, device=self.device),
            env_state=env_state, obs=obs,
            stats=base.EpisodeStats.create(self.env.num_envs, a.tracker_len,
                                           self.device),
            global_step=torch.zeros((), dtype=torch.int64,
                                    device=self.device),
            density_grid=self._density_grid0.to(self.device),
            obs_rms=(rs.RunningMeanStd.create((self.obs_dim,),
                                              device=self.device)
                     if a.obs_norm else None))

    # ----------------------------------------------------------- exploration

    def _norm_obs(self, ts: DDiffPGState, obs: torch.Tensor) -> torch.Tensor:
        """obs normalisation of the acting path only: as in the JAX agent
        (and the reference), the update pass trains on raw obs, and the
        raw obs is normalised before the embedding is appended."""
        return base.norm_obs(self.cfg, ts.obs_rms, obs)

    def _env_step(self, ts: DDiffPGState, p, random: bool) -> DDiffPGState:
        with trace.span("env_step"):
            a = self.cfg.algo
            E, A = self.env.num_envs, self.action_dim
            if a.obs_norm and ts.obs_rms is not None:
                ts = dataclasses.replace(
                    ts, obs_rms=base.update_rms(ts.obs_rms, ts.obs))
            if random:
                action = torch.rand((E, A), generator=self.generator,
                                    device=self.device) * 2.0 - 1.0
            else:
                num_modes = max(self.num_groups - 1, 0) if (
                    a.exp.mode_embedding and a.use_embedding) else 0
                action = explore_actions(
                    ts.actor, self._norm_obs(ts, ts.obs), p, ts.embeddings,
                    num_modes, a.noise.std_min, a.noise.std_max,
                    noise_type=a.noise.type, generator=self.generator)
            env_state, next_obs, reward, done, info = self.env.step(
                ts.env_state, action)
            stats = base.update_stats(ts.stats, reward, done)
            done = done.to(torch.bool)
            done_b = done ^ info["time_outs"] if a.handle_timeout else done

            grid = ts.density_grid
            if self._maze_map is not None:
                grid = density.update(grid, ts.obs[:, :2], 4.0,
                                      self._density_reset,
                                      len(self._maze_map))
            if self._goal_xy is not None:
                goal_dist = torch.linalg.vector_norm(
                    next_obs[:, None, :2] - self._goal_xy[None], dim=-1)
            else:
                goal_dist = -torch.linalg.vector_norm(
                    next_obs[:, :_pos_dim(self.cfg.env.name)], dim=-1,
                    keepdim=True)
            ep.add(ts.replay, ts.obs, action, reward * a.reward_scale,
                   next_obs, done_b, done, info["success"],
                   goal_dist=goal_dist, frontier_keep=a.frontier_keep)
            return dataclasses.replace(
                ts, env_state=env_state, obs=next_obs, stats=stats,
                global_step=ts.global_step + E, density_grid=grid)

    def warmup(self, ts: DDiffPGState) -> DDiffPGState:
        """`algo.warm_up` env steps with uniform random actions."""
        for _ in range(int(self.cfg.algo.warm_up)):
            ts = self._env_step(ts, 0.0, random=True)
        return ts

    # --------------------------------------------------------------- updates

    def _ref_group_sizes(self, G: int):
        """The reference's per-group batch split (the remainder to the
        explore group); only the explore ratio reads it, the update uses
        batch_size // G for every group, as the JAX agent."""
        B = self.cfg.algo.batch_size
        sizes = [B // G] * G
        sizes[0] += B % G
        return sizes

    def draw_update(self, ts: DDiffPGState, G: int) -> UpdateDraws:
        """Every random draw of one update pass at G groups, from the
        agent's generator on its device (no host sync)."""
        a = self.cfg.algo
        b, A, K = a.batch_size // G, self.action_dim, \
            self.cfg.diffusion.diffusion_iter
        n, gen, dev = G * b, self.generator, self.device
        totals = [ep.group_totals(ts.replay, i, i == 0, a.frontier_keep)
                  for i in range(G)]
        normal = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=dev)
        return UpdateDraws(
            u=torch.stack([ep.draw(b, t[0], gen) for t in totals]),
            emb_masks=torch.rand((2 * G, b), generator=gen,
                                 device=dev).argsort(dim=1) < b // 2,
            target=base.TargetDraws(normal(n, A), normal(K, n, A),
                                    normal(n, A)),
            loss_noise=normal(n, A),
            loss_t=torch.randint(0, K, (n,), generator=gen, device=dev),
            u_success=torch.stack([ep.draw(b, t[1], gen) for t in totals]),
            u_frontier=ep.draw(b, totals[0][2], gen))

    def update_once(self, ts: DDiffPGState, G: int | None = None,
                    draws: UpdateDraws | None = None, mark=None):
        """One update pass over groups 0..G-1 (default `num_groups`), in
        the JAX agent's order: sample, NovelD reward with the old RND,
        embeddings, target actions from the old actor, critic update of
        rows :G and their soft targets, the action gradient on the updated
        critics, the target-action scatter, actor distillation, the RND
        update. The draws come from `draw_update` unless given. The pass
        is the span `update_pass`, each part a span of its own; `mark`, when
        given, is called with each part's name as its span ends (a timing
        hook). Returns (state, logs of 0-d tensors)."""
        G = self.num_groups if G is None else G
        a = self.cfg.algo
        b, A, E = a.batch_size // G, self.action_dim, self.embed_dim
        dev = self.device
        with trace.span("update_pass"):
            # --- sample every group; stack to [G, b, ...] -------------------
            with trace.part("sample", mark):
                d = draws or self.draw_update(ts, G)
                gbs = [ep.sample_group(
                    ts.replay, i, b, mix_temp=(i == 0),
                    success_frac=a.success_bias,
                    frontier_frac=a.frontier_frac,
                    frontier_keep=a.frontier_keep,
                    frontier_frac_near=a.frontier_frac_near,
                    frontier_near_dist=a.frontier_near_dist, u=d.u[i],
                    u_success=None if d.u_success is None
                    else d.u_success[i],
                    u_frontier=d.u_frontier)
                    for i in range(G)]
                gb = ep.GroupBatch(*(torch.stack(x) for x in zip(*gbs)))
            flat = lambda x: x.reshape((G * b,) + x.shape[2:])  # noqa: E731

            with trace.part("NovelD reward", mark):
                r_int, intr = self.intrinsic.compute_reward(
                    ts.intrinsic, flat(gb.obs), flat(gb.next_obs))
                r_int_g = r_int.reshape(G, b, 1)
                explore = torch.arange(G, device=dev) == 0
                # the explore group trains on the intrinsic reward only
                reward = torch.where(explore[:, None, None], r_int_g,
                                     gb.reward + r_int_g)

            with trace.part("target actions", mark):
                # per-group conditioning embeddings
                if a.use_embedding:
                    emb_g = ts.embeddings[:G]
                else:
                    emb_g = torch.zeros((G, E), device=dev)
                    emb_g[0] = ts.embeddings[0]
                # mode groups: a random half of the rows gets the zero
                # embedding, drawn apart for states and next states
                drop = d.emb_masks & ~explore.repeat(2)[:, None]

                def embed(obs, m):
                    rows = torch.where(m[..., None], 0.0, emb_g[:, None]
                                       .expand(G, b, E))
                    return torch.cat([obs, rows], dim=-1)

                emb_state = embed(gb.obs, drop[:G])
                emb_next = embed(gb.next_obs, drop[G:])
                # target-policy actions on all groups in one actor call
                next_actions = base.tgt_policy_action(
                    ts.actor, emb_next.reshape(G * b, -1), a.noise,
                    draws=d.target).reshape(G, b, A)

            with trace.part("critic update", mark):
                # per-group C51 support: the explore critic keeps its own
                vmin = torch.full((G, 1, 1), a.v_min, device=dev)
                vmax = torch.full((G, 1, 1), a.v_max, device=dev)
                vmin[0], vmax[0] = a.v_min_explore, a.v_max_explore
                unit = torch.linspace(0.0, 1.0, a.num_atoms, device=dev)
                z = vmin + (vmax - vmin) * unit               # [G, 1, atoms]
                c_loss = base.distributional_critic_loss(
                    ts.critics, ts.critic_targets, z, gb.obs, gb.action,
                    reward, gb.next_obs, next_actions, gb.done,
                    a.gamma ** a.nstep, vmin, vmax, a.num_atoms)
                params = ts.critics.params()
                grads = torch.autograd.grad(c_loss.sum(), params)
                c_gn = optim.apply_update(params, grads, ts.critic_opts,
                                          self.critic_spec, G=G)
                base.soft_update([t[:G] for t in ts.critic_targets.params()],
                                 [p[:G] for p in params], a.tau)
                c_loss = c_loss.detach()

            with trace.part("action gradient", mark):
                # on the updated critics, then the scatter
                new_action = base.action_gradient(
                    lambda act: q_min(ts.critics, z, gb.obs, act),
                    gb.target_action, n_steps=self.cfg.diffusion.update_times,
                    lr=self.cfg.diffusion.action_lr,
                    max_grad_norm=a.max_grad_norm)
                g_idx = torch.arange(G, device=dev).repeat_interleave(b)
                ep.write_target_actions(ts.replay, g_idx, flat(gb.slot),
                                        flat(gb.step), flat(gb.from_buffer),
                                        new_action.reshape(-1, A))

            with trace.part("actor loss and step", mark):
                # distillation over all groups
                tgt_actions = new_action.reshape(G * b, A)
                a_loss = ts.actor.loss(emb_state.reshape(G * b, -1),
                                       tgt_actions, noise=d.loss_noise,
                                       t=d.loss_t)
                aparams = list(ts.actor.parameters())
                a_gn = optim.apply_update(
                    aparams, torch.autograd.grad(a_loss, aparams),
                    ts.actor_opt, self.actor_spec)

            with trace.part("RND update", mark):
                obs_cat = flat(gb.obs)
                if self.cfg.intrinsic.type == "noveld":
                    obs_cat = torch.cat([obs_cat, flat(gb.next_obs)])
                intr, d_loss, d_gn = self.intrinsic.update(intr, obs_cat)

            # the explore row's Q on its own atoms
            with torch.no_grad():
                q_explore = q_min(ts.critics, z[:1], gb.obs[:1],
                                  gb.action[:1]).mean()
        logs = {
            "train/critic_loss": c_loss.mean(),
            "train/critic_loss_explore": c_loss[0],
            "train/q_explore": q_explore,
            "train/critic_grad": c_gn.mean(),
            "train/actor_loss": a_loss.detach(),
            "train/actor_grad": a_gn,
            "train/dynamic_loss": d_loss,
            "train/dynamic_grad": d_gn,
            "train/mean_action": tgt_actions.abs().mean(),
            "train/mean_intrinsic": r_int.mean(),
        }
        return dataclasses.replace(ts, intrinsic=intr), logs

    def train_iter(self, ts: DDiffPGState, steps: int | None = None):
        """`horizon_len` explore env steps, then `update_times` update
        passes. Pass the host-tracked `steps` when known: reading
        `ts.global_step` waits on the device."""
        with trace.span("train_step"):
            G = self.num_groups
            p = self.get_exp_p(int(ts.global_step) if steps is None else steps)
            for _ in range(self.cfg.algo.horizon_len):
                ts = self._env_step(ts, p, random=False)
            passes = []
            for _ in range(self.cfg.algo.update_times):
                ts, logs = self.update_once(ts, G)
                passes.append(logs)
            logs = {k: torch.stack([lg[k] for lg in passes]).mean()
                    for k in passes[0]}
            logs["train/return"] = ts.stats.return_tracker.mean()
            logs["train/episode_length"] = ts.stats.step_tracker.mean()
            logs["train/p"] = torch.tensor(float(p))
            logs["train/num_groups"] = torch.tensor(float(G))
            logs["train/frontier_dist"] = ep.frontier_dist(ts.replay)
            if self._maze_map is not None:
                grid = ts.density_grid
                if base.dp_group() is not None:
                    # across ranks the grids are averaged: counts become
                    # fractional, and > 0 still marks any rank's visit
                    grid = base.maybe_pmean(grid.to(torch.float32))
                logs["train/state_coverage"] = density.coverage(
                    grid, self._num_free)
            return ts, logs

    # ------------------------------------------------------- explore ratio p

    def get_exp_p(self, steps: int) -> float:
        """The reference's get_exp_p (ddiffpg.py:112-137)."""
        a = self.cfg.algo
        G = self.num_groups
        explore_n = self._ref_group_sizes(G)[0]
        if a.exp.type == "fixed":
            p = min(a.exp.fix_ratio, 1 - explore_n / a.batch_size)
        elif a.exp.type == "prop":
            p = 1 - explore_n / a.batch_size
        elif a.exp.type == "linear":
            if self.num_clusters == 0:
                p = 0.0
            else:
                if not hasattr(self, "_lin_start"):
                    self._lin_start = steps
                    self._lin_total = max(
                        (a.exp.stop_ratio * self.cfg.max_step - steps)
                        // self.cfg.num_envs, 1)
                it = (steps - self._lin_start) / max(self.cfg.num_envs, 1)
                p = min(it / self._lin_total, 1.0)
        else:
            raise ValueError(f"unknown exp type {a.exp.type!r}")
        if steps >= a.exp.stop_ratio * self.cfg.max_step:
            held = a.exp.hold_until_mode and self.num_clusters == 0
            if a.exp.hold_until_goals > 0 and \
                    len(self.last_goal_counts) < a.exp.hold_until_goals:
                held = True
            if not held:
                p = 1.0
        return float(p)

    # ------------------------------------------------------------- recluster

    @torch.no_grad()
    def update_cluster(self, ts: DDiffPGState,
                       fresh_embeddings: torch.Tensor | None = None
                       ) -> DDiffPGState:
        """Recluster the stored trajectories and apply the plan in place:
        evict slots, set the replay's groups and target-action rows, gather
        the critic rows, targets and optimizer rows by `src_row` (optimizer
        rows reset where `fresh_opt`), and inherit embeddings by
        `embedding_src` or take fresh ones: `fresh_embeddings` [G_max, E]
        when given (tests feed the JAX package's draw), else a draw from
        the agent's generator."""
        *fields, protect = [None if x is None else x.cpu().numpy()
                            for x in self.recluster_fields(ts)]
        res = self.cluster_manager.recluster(
            *fields, protect_slots=(None if protect is None
                                    else protect.nonzero()[0]))
        if fresh_embeddings is None:
            fresh_embeddings = torch.randn(ts.embeddings.shape,
                                           generator=self.generator,
                                           device=self.device)
        return self.apply_recluster(ts, res, fresh_embeddings)

    def recluster_fields(self, ts: DDiffPGState) -> list:
        """What the recluster reads of the replay: traj_id, length,
        success, the position tracks and the frontier-protected slots
        (None without `frontier_keep`)."""
        rep = ts.replay
        keep = self.cfg.algo.frontier_keep
        return [rep.traj_id, rep.length, rep.success,
                rep.obs[:, :, :self.cluster_manager.traj_dim],
                ep.frontier_mask(rep, keep) if keep > 0 else None]

    @torch.no_grad()
    def apply_recluster(self, ts: DDiffPGState, res, fresh_embeddings,
                        first_slot: int = 0) -> DDiffPGState:
        """Apply a recluster's result in place: this replay holds the slots
        first_slot.. of the one that was clustered (a data-parallel rank's
        share)."""
        plan = res.plan
        self.num_groups = res.num_groups
        self.num_clusters = res.num_groups - 1
        self.last_goal_counts = res.goal_counts
        self.last_plot = (res.plot_success, res.plot_clusters, res.Z)
        self.last_unsuccess_plot = (
            (res.plot_unsuccess, res.plot_unsuccess_clusters)
            if res.plot_unsuccess else None)

        dev = self.device
        rep = ts.replay
        S = rep.length.shape[0]
        evict = [s - first_slot for s in res.evict_slots
                 if first_slot <= s < first_slot + S]
        if len(evict):
            sl = torch.as_tensor(evict, device=dev)
            rep.length[sl] = 0
            rep.traj_id[sl] = -1
        ep.set_groups(rep, torch.as_tensor(
            res.group_mask[:, first_slot:first_slot + S], device=dev),
            torch.as_tensor(plan.parent_row, device=dev))

        # critic rows from their parents; fresh optimizer rows start from
        # adam_init's zeros. As in the JAX package, a fresh mode row copies
        # the explore row (src_row 0) whose atoms sit on the explore
        # support; its reset optimizer and the BCE target retrain it.
        src = torch.as_tensor(plan.src_row, device=dev)
        fresh = torch.as_tensor(plan.fresh_opt, device=dev)
        for p in ts.critics.params() + ts.critic_targets.params():
            p.copy_(p[src])
        opt = ts.critic_opts
        for x in opt.mu + opt.nu + [opt.count]:
            m = fresh.reshape((-1,) + (1,) * (x.dim() - 1))
            x.copy_(torch.where(m, torch.zeros_like(x), x[src]))

        esrc = torch.as_tensor(plan.embedding_src, device=dev)
        inherited = ts.embeddings[esrc.clamp(0, self.G_max - 1)]
        ts.embeddings.copy_(torch.where((esrc >= 0)[:, None], inherited,
                                        fresh_embeddings.to(dev)))
        return ts

    # ------------------------------------------------------------ evaluation

    def eval_actor(self, ts: DDiffPGState, obs: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   x_init: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
        """The eval policy: the actor on the (normalised, with obs_norm)
        obs with the zero embedding (ddiffpg_main.py:84-89)."""
        emb_obs = append_embedding(self._norm_obs(ts, obs),
                                   torch.zeros(self.embed_dim,
                                               device=obs.device))
        return ts.actor.act(emb_obs, generator=generator or self.generator,
                            x_init=x_init, noise=noise)
