"""The reference beside a run: the same inputs, the plain code.

`train_readings` follows a train cell's first training iterations from
the state the program held before them (the replay's raw trajectories,
the env states and trackers, as set-up left them; the replay's groups and
target actions worked out again by `groups`; fresh intrinsic statistics;
the harness's weights and zero optimizer states; the generators re-seeded
by the harness), and reads what the comparison takes: each iteration's
losses, the norm of each leaf's Adam first moment after the first
iteration, the norm of each leaf's change over the iterations, and the
faults of the program's groups (`group_gap`). `collect_outputs` computes, for sampled collect
calls, every step's actions from the obs the program's actor saw, the
first env step of the call from its saved start state with the program's
actions, and the second step of the envs that reset at the first.

`lower=True` computes the same one precision down (the control): matrix
products in TF32, and the physics state rounded to bfloat16 after every
substep. `fault="half_batch"` makes every update pass keep the first half
of each group's sampled batch, its second half a copy of the first, so
each mean is over that half alone.

Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
from types import SimpleNamespace

import torch

from benchmark.reference import groups
from benchmark.reference.agents import base as RB
from benchmark.reference.agents import ddiffpg as RD
from benchmark.reference.envs import antmaze as R_ant
from benchmark.reference.envs import panda as R_panda
from benchmark.reference.envs.base import EnvState, VecEnv
from benchmark.reference.models.diffusion import DiffusionPolicy
from benchmark.reference.models.mlp import DistributionalDoubleQ
from benchmark.reference.ops import optim
from benchmark.reference.physics.substep import substep_reference
from benchmark.reference.replay import episodic as ep

LOSSES = ("train/critic_loss", "train/actor_loss", "train/dynamic_loss")


def namespace(d):
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    return d


def config(file_config: dict, num_envs: int, seed: int):
    """The configuration file's `config` as attributes, with the run's
    env count and seed."""
    return namespace({**file_config, "num_envs": num_envs, "seed": seed})


def make_env(cfg, num_envs: int, device, seed: int) -> VecEnv:
    name = cfg.env.name
    if name.startswith("antmaze"):
        env = R_ant.AntMazeEnv(name=name, reward_type=cfg.env.reward_type,
                               random_init=cfg.env.random_init,
                               device=device, seed=seed)
    elif name.startswith("Panda"):
        env = R_panda.make_panda_env(name,
                                     control_type=cfg.env.control_type,
                                     device=device, seed=seed)
    else:
        raise ValueError(f"no reference env {name!r}")
    return VecEnv(env, num_envs)


@torch.no_grad()
def load(module: torch.nn.Module, key: str, weights: dict):
    for name, p in module.named_parameters():
        p.copy_(weights[f"{key}.{name}"].to(p.device))


def _bf16_physics(env, qpos, qvel, ctrl):
    r = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    qpos, qvel, ctrl = r(qpos), r(qvel), r(ctrl.contiguous())
    for _ in range(env.consts.n_substeps):
        qpos, qvel = substep_reference(env.consts, qpos, qvel, ctrl,
                                       n_substeps=1)
        qpos, qvel = r(qpos), r(qvel)
    return qpos, qvel


def _half_batch(sample):
    def sample_half(*args, **kwargs):
        gb = sample(*args, **kwargs)
        b = gb.obs.shape[0]
        idx = torch.arange(b, device=gb.obs.device) % max(b // 2, 1)
        return ep.GroupBatch(*(x[idx] for x in gb))
    return sample_half


@contextlib.contextmanager
def precision(lower: bool = False, fault: str | None = None):
    """The reference's arithmetic: float32 with TF32 off; with `lower`,
    TF32 matrix products and a bfloat16 physics state; with `fault`, the
    planted fault."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    saved = (R_ant.step_physics, R_panda.step_physics, RD.ep.sample_group)
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    if lower:
        R_ant.step_physics = R_panda.step_physics = _bf16_physics
    if fault == "half_batch":
        RD.ep.sample_group = _half_batch(saved[2])
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        R_ant.step_physics, R_panda.step_physics, RD.ep.sample_group = saved


# --------------------------------------------------------------- training

def _state(agent, cfg, snap: dict, weights: dict, emb, device):
    """The DDiffPG state the program held before the followed iterations:
    from `snap` the replay's raw trajectories, the env state, obs,
    trackers, step count and density grid; the replay's group mask and
    target actions from `groups`; fresh intrinsic statistics (only an
    update pass moves them); the harness's weights, zero optimizer states.
    Returns (state, the faults of the program's groups)."""
    a = cfg.algo
    g = torch.Generator().manual_seed(0)      # replaced by `weights`
    actor = DiffusionPolicy(agent.action_dim, agent.obs_dim + agent.embed_dim,
                            cfg.diffusion.diffusion_iter, device=device,
                            generator=g)
    load(actor, "actor", weights)
    critics = DistributionalDoubleQ(agent.obs_dim, agent.action_dim,
                                    agent.G_max, a.num_atoms,
                                    generator=g).to(device)
    load(critics, "critic", weights)
    intr = agent.intrinsic.init(device, g)
    load(intr.net, "rnd", weights)
    dev = lambda x: x.to(device)  # noqa: E731
    raw = {k: v for k, v in snap["replay"].items() if k != "group_mask"}
    mask, group_gap = groups.derive(raw, snap["replay"]["group_mask"],
                                    snap["num_groups"],
                                    int(cfg.algo.memory_size))
    raw["group_mask"] = mask
    raw["target_action"] = groups.target_actions(dev(raw["action"]),
                                                 mask.shape[0])
    st = snap["stats"]
    stats = RB.EpisodeStats(
        dev(st["current_returns"]), dev(st["current_lengths"]),
        RB.Tracker(*map(dev, st["return_tracker"])),
        RB.Tracker(*map(dev, st["step_tracker"])))
    return RD.DDiffPGState(
        actor=actor, actor_opt=optim.adam_init(list(actor.parameters())),
        critics=critics, critic_targets=copy.deepcopy(critics),
        critic_opts=optim.adam_init(critics.params(), rows=1),
        embeddings=dev(emb).clone(), intrinsic=intr,
        replay=ep.EpisodicReplay(**{k: dev(v) for k, v in raw.items()}),
        env_state=EnvState(*map(dev, snap["env_state"])),
        obs=dev(snap["obs"]), stats=stats,
        global_step=dev(snap["global_step"]),
        density_grid=dev(snap["density_grid"]), obs_rms=None), group_gap


def leaves(ts) -> dict:
    """{leaf name: (parameter, Adam first moment or None)} of the trained
    modules, named as the harness names the weights."""
    out = {}
    for key, params, opt in (
            ("actor", ts.actor.named_parameters(), ts.actor_opt),
            ("critic", ts.critics.named_parameters(), ts.critic_opts),
            ("critic_target", ts.critic_targets.named_parameters(), None),
            ("rnd", ts.intrinsic.net.named_parameters(),
             ts.intrinsic.opt_state)):
        for k, (name, p) in enumerate(params):
            out[f"{key}.{name}"] = (p, None if opt is None else opt.mu[k])
    return out


def follow(ts, agent, steps: int, n_iters: int) -> dict:
    """Readings of n_iters training iterations from `ts`, of the reference
    or of the program (whose state `leaves` reads alike): each iteration's
    losses, each leaf's first-moment norm after the first, and each leaf's
    parameters after the last (live tensors: take `change_norms` before
    the state moves on); with the state and step count reached."""
    spi = agent.env.num_envs * agent.cfg.algo.horizon_len
    logs, moments = [], {}
    for i in range(n_iters):
        ts, lg = agent.train_iter(ts, steps)
        steps += spi
        logs.append({k: float(lg[k]) for k in LOSSES})
        if i == 0:
            moments = {k: float(torch.linalg.vector_norm(m))
                       for k, (p, m) in leaves(ts).items() if m is not None}
    final = {k: p.detach() for k, (p, m) in leaves(ts).items()}
    return {"logs": logs, "moments": moments, "final": final, "ts": ts,
            "steps": steps}


def change_norms(final: dict, weights: dict) -> dict:
    """‖θ_n − θ_0‖ of each leaf; the targets start at the critics'."""
    out = {}
    for k, p in final.items():
        w0 = weights[k.replace("critic_target.", "critic.")].to(p.device)
        out[k] = float(torch.linalg.vector_norm(p.float() - w0))
    return out


def train_readings(file_config: dict, num_envs: int, cfg_seed: int,
                   snap: dict, weights: dict, emb, seeds: dict,
                   n_iters: int, device, lower: bool = False,
                   fault: str | None = None) -> dict:
    cfg = config(file_config, num_envs, cfg_seed)
    with precision(lower, fault):
        env = make_env(cfg, num_envs, device, seeds["env"])
        gen = torch.Generator(device=device).manual_seed(seeds["agent"])
        agent = RD.AgentDDiffPG(env, cfg, device=device, generator=gen)
        agent.num_groups = snap["num_groups"]
        agent.num_clusters = snap["num_clusters"]
        agent.last_goal_counts = dict(snap["last_goal_counts"])
        ts, group_gap = _state(agent, cfg, snap, weights, emb,
                               torch.device(device))
        out = follow(ts, agent, snap["steps"], n_iters)
    out["change"] = change_norms(out.pop("final"), weights)
    out["group_gap"] = group_gap
    del out["ts"], out["steps"]
    return out


# ---------------------------------------------------------------- collect

def collect_outputs(file_config: dict, num_envs: int, weights: dict, emb,
                    calls: list, p: float, num_modes: int, device,
                    lower: bool = False) -> list:
    """For each sampled call (dict: the call's start `state` (qpos, qvel,
    t), `obs0`, the seeds `actor` and `env`, and the program's `action`
    [T, B, A] and `obs` [T, B, D] and step-0/1 `done`): the reference's
    actions at every step from the obs the program's actor saw; its first
    env step from the start state with the program's first actions
    (next obs, reward, done, success); its second step of the envs that
    reset at the first, from their reset states with the program's second
    actions."""
    cfg = config(file_config, num_envs, 0)
    a = cfg.algo
    dev = torch.device(device)
    out = []
    with precision(lower), torch.no_grad():
        env = make_env(cfg, num_envs, dev, 0)
        g = torch.Generator().manual_seed(0)     # replaced by `weights`
        policy = DiffusionPolicy(env.action_dim, env.obs_dim + a.embedding_dim,
                                 cfg.diffusion.diffusion_iter, device=dev,
                                 generator=g)
        load(policy, "actor", weights)
        emb = emb.to(dev)
        modes = torch.tensor(num_modes, device=dev)
        for c in calls:
            gen = torch.Generator(device=dev).manual_seed(c["actor"])
            T = c["action"].shape[0]
            acts = []
            for k in range(T):
                obs_in = c["obs0"] if k == 0 else c["obs"][k - 1]
                acts.append(RD.explore_actions(
                    policy, obs_in.to(dev), p, emb, modes,
                    a.noise.std_min, a.noise.std_max,
                    noise_type=a.noise.type, generator=gen))
            env.env.generator.manual_seed(c["env"])
            state = EnvState(*(x.to(dev) for x in c["state"]))
            s1, obs1, rew1, done1, info1 = env.step(state,
                                                    c["action"][0].to(dev))
            idx = c["done"][0].to(dev).nonzero().flatten()
            step1 = None
            if idx.numel() and T > 1:
                sub = EnvState(s1.qpos[idx], s1.qvel[idx], s1.t[idx])
                _, obs2, rew2, done2, info2 = env.step(
                    sub, c["action"][1].to(dev)[idx])
                step1 = (idx, obs2, rew2, done2, info2["success"])
            out.append({"actions": torch.stack(acts),
                        "step0": (obs1, rew1, done1, info1["success"]),
                        "step1": step1})
    return out
