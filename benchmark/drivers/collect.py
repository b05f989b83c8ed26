"""Window driver of kind "collect": DDiffPG's acting path,
`ddiffpg_tpu_torch/agents/ddiffpg.py:collect` (mode-embedding mixing, the
K-step denoise, exploration noise, one batched env step through the
substep kernel, auto-reset), called again and again for `steps_per_call`
control steps of `num_envs` envs.

Set-up: the env and the stock-width diffusion actor with the harness's
weights and mode embeddings, `live_modes` live modes, exploit share
`p_exploit`; episode clocks staggered at reset (so truncations and
auto-resets fall inside every call); `warmup_calls` untimed calls. In the
window each call's draws come from seeds the harness sets just before it
(the actor's generator and the env's reset generator); a sample of
`checked_calls` calls, drawn from the seed over the whole window, keeps
its start state and its outputs for the reference.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.harness import compare, program, weights
from benchmark.harness.seeds import numpy_rng


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def setup(ctx) -> dict:
    from ddiffpg_tpu_torch.agents.ddiffpg import collect
    from ddiffpg_tpu_torch.envs import make
    from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy
    from ddiffpg_tpu_torch.train import env_kwargs

    tr, dev = ctx.traffic, ctx.device
    E = tr["num_envs"]
    cfg = program.program_config(ctx.config["config"], E, 0)
    env = make(cfg.env.name, num_envs=E, device=dev, seed=ctx.sub("env"),
               **env_kwargs(cfg))
    a = cfg.algo
    policy = DiffusionPolicy(env.action_dim, env.obs_dim + a.embedding_dim,
                             cfg.diffusion.diffusion_iter, device=dev,
                             generator=torch.Generator().manual_seed(0))
    wgen = torch.Generator(device=dev).manual_seed(ctx.sub("weights"))
    W = weights.draw({"actor": (policy.named_parameters(), 1.0, False)},
                     wgen, dev)
    emb = torch.randn((a.max_modes + 1, a.embedding_dim), generator=wgen,
                      device=dev)
    weights.load(policy, "actor", W)
    modes = torch.tensor(tr["live_modes"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.sub("stagger"))
    state, obs = env.reset()
    state = state._replace(t=torch.randint(
        0, env.max_episode_length, (E,), generator=gen, device=dev,
        dtype=torch.int32))
    p, steps = tr["p_exploit"], tr["steps_per_call"]

    def call(state, obs):
        return collect(env, policy, state, obs, steps, p, emb, modes,
                       a.noise.std_min, a.noise.std_max, generator=gen)

    # the warm-up calls' outputs are held, as the window holds its sampled
    # calls', so the window finds the memory it needs already cached
    held = []
    for _ in range(tr["warmup_calls"]):
        state, obs, roll = call(state, obs)
        held.append(roll)
    _sync(dev)
    del held
    return {"env": env, "policy": policy, "emb": emb, "modes": modes,
            "gen": gen, "call": call, "state": state, "obs": obs,
            "cfg": cfg, "W": W}


def window(ctx, st: dict, seconds: float, meter=None) -> dict:
    """`collect` calls again and again for `seconds`; with a `meter`
    (`harness/trace.py:DeviceMeter`) each call is metered, and the
    device's busy time an env step is reported too."""
    tr, dev = ctx.traffic, ctx.device
    k = tr["checked_calls"]
    pick = numpy_rng(ctx.seed, "checked calls")
    kept, flags, unit_s = [], [], []
    gen, env_gen = st["gen"], st["env"].env.generator
    block = meter if meter is not None else contextlib.nullcontext()
    n = 0
    _sync(dev)
    t0 = last = time.perf_counter()
    while True:
        s_act, s_env = ctx.sub(f"call {n} actor"), ctx.sub(f"call {n} env")
        gen.manual_seed(s_act)
        env_gen.manual_seed(s_env)
        state, obs = st["state"], st["obs"]
        with block:
            st["state"], st["obs"], roll = st["call"](state, obs)
        flags.append(~(torch.isfinite(roll.obs).all()
                       & torch.isfinite(roll.reward).all()))
        # a uniform sample of the window's calls (reservoir), from the seed
        slot = n if n < k else int(pick.randint(0, n + 1))
        if slot < k:
            entry = {"call": n, "actor": s_act, "env": s_env,
                     "state": tuple(state), "obs0": obs, "roll": roll}
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        n += 1
        now = time.perf_counter()
        unit_s.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    _sync(dev)
    secs = time.perf_counter() - t0
    failed = int(torch.stack(flags).sum())
    E, T = tr["num_envs"], tr["steps_per_call"]
    st["kept"] = kept
    e2e = {"collect_env_steps_per_s": n * E * T / secs}
    if meter is not None:
        e2e["collect_device_us_per_env_step"] = \
            meter.busy_s * 1e6 / (n * E * T)
    return {"attempted": n, "failed": failed, "seconds": secs, "units": n,
            "unit_s": unit_s, "env_steps": n * E * T, "e2e": e2e}


def probes(ctx, st: dict) -> dict:
    """Host ms of the actor (`explore_actions`) and of the env step
    (`env.step`), each call between two synchronizes, in turns, after one
    untimed each; `probe_calls` of each."""
    from ddiffpg_tpu_torch.agents.ddiffpg import explore_actions

    env, dev, a = st["env"], ctx.device, st["cfg"].algo
    state, obs = st["state"], st["obs"]
    p = ctx.traffic["p_exploit"]
    act = [None]

    def actor():
        act[0] = explore_actions(st["policy"], obs, p, st["emb"],
                                 st["modes"], a.noise.std_min,
                                 a.noise.std_max, generator=st["gen"])

    def step():
        env.step(state, act[0])

    times = {"actor": [], "env_step": []}
    for i in range(ctx.traffic["probe_calls"] + 1):
        for name, fn in (("actor", actor), ("env_step", step)):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": times}


def unit(ctx, st: dict):
    def one():
        st["state"], st["obs"], _ = st["call"](st["state"], st["obs"])
    return one


def outputs(ctx, st: dict) -> dict:
    calls = []
    for e in sorted(st["kept"], key=lambda e: e["call"]):
        r = e["roll"]
        calls.append({"call": e["call"], "actor": e["actor"],
                      "env": e["env"], "state": e["state"],
                      "obs0": e["obs0"], "action": r.action, "obs": r.obs,
                      "reward": r.reward, "done": r.done,
                      "success": r.success})
    return {"calls": calls, "weights": st["W"], "emb": st["emb"]}


def _program_outputs(calls: list) -> list:
    out = []
    for c in calls:
        idx = c["done"][0].nonzero().flatten()
        step1 = None
        if idx.numel() and c["action"].shape[0] > 1:
            step1 = (idx, c["obs"][1][idx], c["reward"][1][idx],
                     c["done"][1][idx], c["success"][1][idx])
        out.append({"actions": c["action"],
                    "step0": (c["obs"][0], c["reward"][0], c["done"][0],
                              c["success"][0]),
                    "step1": step1})
    return out


def check(ctx, out: dict, candidate: str = "program") -> list:
    """The gaps of `candidate` against the reference: "program" or
    "control" (the reference one precision down)."""
    from benchmark.reference import follow

    tr = ctx.traffic

    def run(lower=False):
        return follow.collect_outputs(
            ctx.config["config"], tr["num_envs"], out["weights"], out["emb"],
            out["calls"], tr["p_exploit"], tr["live_modes"], ctx.device,
            lower=lower)

    if "reference" not in out:
        out["reference"] = run()
    cand = _program_outputs(out["calls"]) if candidate == "program" \
        else run(lower=True)
    if candidate not in ("program", "control"):
        raise ValueError(f"no candidate {candidate!r} for a collect cell")
    return compare.collect_gaps(cand, out["reference"], tr["limits"])
