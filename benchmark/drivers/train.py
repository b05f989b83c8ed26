"""Window driver of kind "train": DDiffPG's training iteration,
`AgentDDiffPG.train_iter`, as `ddiffpg_tpu_torch/train.py`'s loop calls it
(host-tracked step counts, the logs fetched in bulk every
`config.log_freq` iterations of the configuration), with no eval,
recluster or checkpoint in the window.

Set-up: the stock agent and env, the stock random warm-up, synthetic
successes on the maze's corridors written into the replay, one
`update_cluster` (the run fails unless it finds `expect_groups` groups,
each corridor in one mode), the harness's weights, the generators
re-seeded, then `followed_iters` iterations through the window's own call,
which the reference follows (`benchmark/reference/follow.py`) once the
window has closed.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.harness import compare, program, synthetic, weights
from benchmark.harness.seeds import numpy_rng
from benchmark.reference import follow


def setup(ctx) -> dict:
    from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG
    from ddiffpg_tpu_torch.envs import make
    from ddiffpg_tpu_torch.replay import episodic as ep
    from ddiffpg_tpu_torch.train import env_kwargs

    tr, dev = ctx.traffic, ctx.device
    E = tr["num_envs"]
    cfg = program.program_config(ctx.config["config"], E, ctx.sub("cfg")
                                 % (1 << 31))
    env = make(cfg.env.name, num_envs=E, device=dev,
               seed=ctx.sub("env.warmup"), **env_kwargs(cfg))
    gen = torch.Generator(device=dev).manual_seed(ctx.sub("agent.warmup"))
    agent = AgentDDiffPG(env, cfg, device=dev, generator=gen)
    ts = agent.warmup(agent.init(seed=ctx.sub("init") % (1 << 31)))

    if bool((ts.replay.tmp_len > 0).any()):
        raise RuntimeError("the warm-up left episodes in flight: the "
                           "synthetic trajectories need every env's "
                           "episode flushed (warm_up a multiple of the "
                           "episode length)")
    syn = tr["synthetic"]
    rng = numpy_rng(ctx.seed, "synthetic")
    L = env.max_episode_length
    plans = synthetic.fill_plans(rng, E, syn["successes"], L,
                                 syn["routes_y"], syn["min_len"])
    synthetic.write_trajectories(ep, ts.replay, plans, L, rng,
                                 syn["goal_xy"])
    ts = agent.update_cluster(ts)
    G = agent.num_groups
    if G != tr["expect_groups"] or not synthetic.routes_found(ts.replay, G):
        raise RuntimeError(f"the recluster gave {G} groups, not "
                           f"{tr['expect_groups']} with one corridor each")

    # the harness's weights, zero optimizer states
    wgen = torch.Generator(device=dev).manual_seed(ctx.sub("weights"))
    W = weights.draw({"actor": (ts.actor.named_parameters(), 1.0, False),
                      "critic": (ts.critics.named_parameters(), 1.0, True),
                      "rnd": (ts.intrinsic.net.named_parameters(), 2.0,
                              False)}, wgen, dev)
    emb = torch.randn(ts.embeddings.shape, generator=wgen, device=dev)
    weights.load(ts.actor, "actor", W)
    weights.load(ts.critics, "critic", W)
    weights.load(ts.critic_targets, "critic", W)
    weights.load(ts.intrinsic.net, "rnd", W)
    with torch.no_grad():
        ts.embeddings.copy_(emb)
        for opt in (ts.actor_opt, ts.critic_opts, ts.intrinsic.opt_state):
            for x in opt.mu + opt.nu + [opt.count]:
                x.zero_()

    seeds = {"agent": ctx.sub("agent"), "env": ctx.sub("env")}
    agent.generator.manual_seed(seeds["agent"])
    env.env.generator.manual_seed(seeds["env"])
    steps = int(ts.global_step)
    snap = program.train_snapshot(agent, ts, steps)

    # the first iterations, through the window's own call, read as the
    # reference's are read
    n = tr["followed_iters"]
    got = follow.follow(ts, agent, steps, n)
    got["change"] = follow.change_norms(got.pop("final"), W)
    ts, steps = got.pop("ts"), got.pop("steps")
    _sync(dev)
    return {"agent": agent, "ts": ts, "steps": steps,
            "spi": E * cfg.algo.horizon_len, "groups": G,
            "log_freq": cfg.log_freq,
            "check": {"snap": snap, "weights": {k: program.cpu(v)
                                                for k, v in W.items()},
                      "emb": program.cpu(emb), "seeds": seeds,
                      "cfg_seed": cfg.seed, "n": n,
                      "program": got}}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def window(ctx, st: dict, seconds: float, meter=None) -> dict:
    """`train_iter` again and again for `seconds`; with a `meter`
    (`harness/trace.py:DeviceMeter`) each iteration is metered, and the
    device's busy time an env step is the window's end-to-end number."""
    agent, dev = st["agent"], ctx.device
    log_freq = st["log_freq"]
    block = meter if meter is not None else contextlib.nullcontext()
    rows, unit_s = [], []
    n = 0
    _sync(dev)
    t0 = last = time.perf_counter()
    while True:
        with block:
            st["ts"], logs = agent.train_iter(st["ts"], st["steps"])
            st["steps"] += st["spi"]
            n += 1
            row = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                               .to(dev) for v in logs.values()])
            rows.append(row)
            if n % log_freq == 0:
                row.tolist()          # the loop's bulk fetch of the logs
        now = time.perf_counter()
        unit_s.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    _sync(dev)
    secs = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(rows)).all(dim=1)).sum())
    ts = st["ts"]
    finite = all(bool(torch.isfinite(p).all()) for p in
                 list(ts.actor.parameters()) + ts.critics.params())
    if not finite:
        failed = max(failed, 1)
    e2e = {}
    if meter is not None:
        e2e["train_device_us_per_env_step"] = \
            meter.busy_s * 1e6 / (n * st["spi"])
    return {"attempted": n, "failed": failed, "seconds": secs,
            "units": n, "unit_s": unit_s, "env_steps": n * st["spi"],
            "e2e": e2e}


def probes(ctx, st: dict) -> dict:
    """Host ms of each part of `probe_passes` update passes (the agent's
    `mark` hook, a synchronize at each part's end), after one untimed."""
    agent = st["agent"]
    parts, totals = {}, []
    for i in range(ctx.traffic["probe_passes"] + 1):
        _sync(ctx.device)
        t_start = time.perf_counter()
        last = [t_start]
        mine = {}

        def mark(name):
            _sync(ctx.device)
            now = time.perf_counter()
            mine[name] = (now - last[0]) * 1e3
            last[0] = now

        st["ts"], _ = agent.update_once(st["ts"], mark=mark)
        if i == 0:
            continue
        totals.append((last[0] - t_start) * 1e3)
        for k, v in mine.items():
            parts.setdefault(k, []).append(v)
    return {"host_ms": {"update_pass": totals,
                        "action_gradient": parts.get("action gradient", [])},
            "groups": st["groups"]}


def unit(ctx, st: dict):
    """One unit of the window's work (for the profiled window)."""
    def one():
        st["ts"], _ = st["agent"].train_iter(st["ts"], st["steps"])
        st["steps"] += st["spi"]
    return one


def outputs(ctx, st: dict) -> dict:
    return st["check"]


def check(ctx, out: dict, candidate: str = "program") -> list:
    """The gaps of `candidate` against the reference: "program" (the
    followed iterations' readings and its replay groups), "control" (the
    reference one precision down), "half_batch" (the reference with that
    fault)."""
    def run(**kw):
        return follow.train_readings(
            ctx.config["config"], ctx.traffic["num_envs"], out["cfg_seed"],
            out["snap"], out["weights"], out["emb"], out["seeds"],
            out["n"], ctx.device, **kw)

    if "reference" not in out:
        out["reference"] = run()
    if candidate == "program":
        # the program's groups, judged when the reference worked out its own
        cand = dict(out["program"], group_gap=out["reference"]["group_gap"])
    else:
        # the reference's own groups
        cand = dict(run(lower=True) if candidate == "control" else
                    run(fault=candidate), group_gap=0)
    return compare.train_gaps(cand, out["reference"],
                              ctx.traffic["limits"])
