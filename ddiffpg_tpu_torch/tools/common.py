"""What the checkpoint tools share: their arguments, the agent rebuilt from
a checkpoint, eval envs, the conditionings and the actor under one of
them, one rollout, and a group's Q on its own support.

Every tool runs as `python -m ddiffpg_tpu_torch.tools.<name> CKPT
key=value ...` with the JAX tool's keys and defaults, plus `device=`:
`auto` (the default) is the CUDA card and raises without one, `cpu` runs
on the CPU. A dotted key (`algo.memory_size=64`, `env.resolution=357`)
overrides the config as on `train.main`'s command line, so that the agent
is rebuilt with the shapes of the run that wrote the checkpoint.

Their eval envs take the JAX tools' physics: `use_pallas=False`, the
batched engine `physics/engine_cl.py` (the maze's SDF walls), for the ant
and Panda names, on the card or on the CPU. Pointmaze has no engine in
either package; its envs step as in training.
"""

from __future__ import annotations

import torch

from ddiffpg_tpu_torch import config as C
from ddiffpg_tpu_torch import train
from ddiffpg_tpu_torch.agents import base, make_agent
from ddiffpg_tpu_torch.envs import make
from ddiffpg_tpu_torch.ops.embedding import append_embedding
from ddiffpg_tpu_torch.ops.noise import add_mixed_normal_noise
from ddiffpg_tpu_torch.utils import checkpoint as ckpt


def parse(argv, **defaults):
    """`key=value` arguments -> (the tool's keys, with `defaults` filled
    in and `device` defaulting to auto; the dotted config overrides)."""
    kw, overrides = {"device": "auto", **defaults}, []
    for a in argv:
        k, sep, _ = a.partition("=")
        if not sep:
            raise SystemExit(f"argument {a!r} is not key=value")
        if "." in k:
            overrides.append(a)
        elif k in kw:
            kw[k] = a.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown key {k!r}; the tool takes "
                             f"{sorted(kw)} and dotted config overrides")
    return kw, overrides


def load(path, kw: dict, overrides=()):
    """Rebuild the agent of a checkpoint written by `train.main` (as the
    JAX tools do: the algo's preset, env.name, `preprocess`, num_envs) and
    load the full or light checkpoint into it. Returns (cfg, agent, ts,
    meta)."""
    algo = kw.get("algo", "ddiffpg")
    over = list(overrides)
    cfg = C.Config(algo=C.algo_preset(algo)).override_strings(
        [f"env.name={kw['env']}", f"device={kw['device']}", *over])
    device = train.resolve_device(cfg.device)
    cfg = C.preprocess(cfg, if_ddiffpg=(algo.lower() == "ddiffpg"))
    cfg = cfg.override_strings([f"num_envs={kw['num_envs']}", *over])
    env = make(cfg.env.name, num_envs=cfg.num_envs, device=device,
               seed=cfg.seed, **train.env_kwargs(cfg))
    agent = make_agent(cfg.algo.name, env, cfg, device=device)
    ts, meta = ckpt.load(path, agent.init())
    shown = {k: v for k, v in meta.items()
             if k not in ("last_cluster", "generators")}
    print(f"loaded {path} (meta={shown})", flush=True)
    return cfg, agent, ts, meta


def eval_env(cfg, num_envs: int, seed: int, random_init=None):
    """An env of the config's name on the agent's device, on the JAX
    tools' physics (`use_pallas=False` but for pointmaze); `random_init`
    (antmaze only) as the JAX tool passes it, else the config's."""
    kw = train.env_kwargs(cfg)
    if random_init is not None and "antmaze" in cfg.env.name:
        kw["random_init"] = random_init
    if not cfg.env.name.startswith("pointmaze"):
        kw["use_pallas"] = False
    return make(cfg.env.name, num_envs=num_envs,
                device=train.resolve_device(cfg.device), seed=seed, **kw)


def conditionings(agent, ts, num_groups: int) -> list:
    """(name, embedding [E]): zero, explore and each live mode."""
    zero = torch.zeros(agent.embed_dim, device=agent.device)
    return [("zero", zero), ("explore", ts.embeddings[0])] + [
        (f"mode{i}", ts.embeddings[i]) for i in range(1, num_groups)]


def actor_with(agent, ts, emb: torch.Tensor, generator, noise_std=None):
    """obs -> the actor's actions with the embedding `emb` [E] appended
    to the (normalised, with obs_norm) obs; with `noise_std` (min, max)
    the training path's mixed exploration noise is added."""
    def fn(obs):
        cond = append_embedding(base.norm_obs(agent.cfg, ts.obs_rms, obs),
                                emb)
        act = ts.actor.act(cond, generator=generator)
        if noise_std is None:
            return act
        return add_mixed_normal_noise(act, *noise_std, out_bounds=(-1, 1),
                                      generator=generator)
    return fn


@torch.no_grad()
def q_of(agent, ts, g: int, obs: torch.Tensor, act: torch.Tensor):
    """min over the two heads of group g's critic, decoded on that
    group's atoms [b]: the explore critic (g = 0) on
    v_{min,max}_explore, as the update pass trains it; the mode support
    would shift its Q affinely on dense envs."""
    a = agent.cfg.algo
    vmin, vmax = (a.v_min_explore, a.v_max_explore) if g == 0 else \
        (a.v_min, a.v_max)
    z = torch.linspace(vmin, vmax, a.num_atoms, device=obs.device)
    rows = g + 1   # the stacked critics run rows 0..g; take row g
    q1, q2 = ts.critics(obs.expand(rows, *obs.shape),
                        act.expand(rows, *act.shape))
    return torch.minimum((q1[g] * z).sum(-1), (q2[g] * z).sum(-1))


@torch.no_grad()
def rollout(env, actor_fn, record) -> dict:
    """One `max_episode_length` rollout from a reset. The obs carried to
    the next step is the one `step` returned (the pre-reset obs of an env
    that just ended), as the JAX tools' scans carry it.
    `record(obs, done, info)` gives each step's tensors by name; returns
    them stacked [T, ...] as numpy arrays."""
    state, obs = env.reset()
    steps = []
    for _ in range(env.max_episode_length):
        state, obs, _, done, info = env.step(state, actor_fn(obs))
        steps.append(record(obs, done, info))
    return {k: torch.stack([s[k] for s in steps]).cpu().numpy()
            for k in steps[0]}
