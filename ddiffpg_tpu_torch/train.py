"""Training entry point of the port: DDiffPG and the baselines on one card.

    python -m ddiffpg_tpu_torch.train algo=ddiffpg env.name=antmaze-v1
    python -m ddiffpg_tpu_torch.train algo=dipo env.name=antmaze-v1
    python -m ddiffpg_tpu_torch.train device=cpu num_envs=8 eval_num_envs=4 \
        algo.warm_up=16 algo.batch_size=64 max_step=160

Counterpart of the root `train.py`: `algo=` ddiffpg (the default), td3,
sac, dipo or diffq. Dotted key=value pairs override the typed config
(`ddiffpg_tpu_torch/config.py`), before and again after the per-env
`preprocess`. `device=auto` (the default) is the CUDA card and raises
without one; `device=cpu` runs everything on the CPU.

The loop: warm-up with random actions, the initial recluster (DDiffPG),
then train iterations; every `eval_freq` iterations a recluster (DDiffPG,
after the first) and an eval rollout; every `eval_freq * ckpt_freq_mult` a
light checkpoint (replay left out; full with `ckpt_full`); logs every
`log_freq`; a full
checkpoint at the end. SIGUSR1 asks for a full checkpoint at the next loop
top, SIGTERM for a full checkpoint and a clean stop, SIGINT exits. Besides
the JAX package's metrics it logs the loop's own costs under `time/`
(host clock, the device synchronized around each timed call): warm-up,
recluster (and its DTW share), eval rollout and checkpoint seconds,
checkpoint bytes, and the seconds per train iteration between log points.
`resume=<path>` restores a full or light checkpoint.

On the mazes every eval also draws the eval's xy over the maze
(`eval_map_<step>.png` in the run directory), and for DDiffPG every
`eval_freq * 5` iterations the last recluster's success clusters, its
dendrogram, the failures by their assigned mode and the exploration
heatmap (`cluster`, `hierarchy`, `unsuccess_cluster`, `exploration_map`),
as the root `train.py` does. The plots need matplotlib: without it the
loop says once that it skips them, and draws none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import sys
import time

import torch

from ddiffpg_tpu_torch import config as C
from ddiffpg_tpu_torch.agents import make_agent
from ddiffpg_tpu_torch.agents.evaluation import eval_rollout
from ddiffpg_tpu_torch.envs import make
from ddiffpg_tpu_torch.physics import maze
from ddiffpg_tpu_torch.utils import checkpoint as ckpt
from ddiffpg_tpu_torch.utils.logger import Logger


def parse_args(argv):
    algo = "ddiffpg"
    resume = None
    overrides = []
    for a in argv:
        if a.startswith("algo="):
            algo = a.split("=", 1)[1]
        elif a.startswith("resume="):
            resume = a.split("=", 1)[1]
        else:
            overrides.append(a)
    return algo, resume, overrides


def resolve_device(name: str) -> torch.device:
    """`auto`: the CUDA card, which must be present; `cpu`: the CPU."""
    if name == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError("device=auto needs a CUDA card and none is "
                               "present; pass device=cpu to train on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device={name!r}: the port runs on 'auto' (the CUDA "
                     "card) or 'cpu'")


def env_kwargs(cfg) -> dict:
    """The config's env options that `envs.make` takes for its env name."""
    if "antmaze" in cfg.env.name:
        return dict(reward_type=cfg.env.reward_type,
                    random_init=cfg.env.random_init)
    if cfg.env.name.startswith("Panda"):
        return dict(control_type=cfg.env.control_type)
    return {}


def make_envs(cfg, device):
    """The train env (cfg.num_envs) and the eval env (cfg.eval_num_envs),
    their reset draws seeded from cfg.seed and cfg.seed + 1."""
    kw = env_kwargs(cfg)
    env = make(cfg.env.name, num_envs=cfg.num_envs, device=device,
               seed=cfg.seed, **kw)
    eval_env = make(cfg.env.name, num_envs=cfg.eval_num_envs, device=device,
                    seed=cfg.seed + 1, **kw)
    return env, eval_env


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def signal_requests(logger):
    """Install the loop's handlers for the duration: SIGUSR1 asks for a full
    checkpoint at the next loop top, SIGTERM for a full checkpoint and a
    stop, SIGINT exits. Yields the requests dict the handlers set; the
    previous handlers come back on exit."""
    requests = {"full_ckpt": False, "stop": False}

    def _sigint(sig, frame):
        logger.console("interrupted — exiting")
        sys.exit(0)

    def _sigusr1(sig, frame):
        requests["full_ckpt"] = True

    def _sigterm(sig, frame):
        requests["full_ckpt"] = True
        requests["stop"] = True

    previous = {s: signal.signal(s, h) for s, h in (
        (signal.SIGINT, _sigint), (signal.SIGUSR1, _sigusr1),
        (signal.SIGTERM, _sigterm))}
    try:
        yield requests
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def plots_available(logger) -> bool:
    """Whether matplotlib imports; says so on the console when it does
    not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        logger.console(f"maze plots skipped: matplotlib cannot be imported "
                       f"({e})")
        return False
    return True


def plot_eval(cfg, agent, ts, xy, iter_t: int, step: int, logger):
    """The maze plots of one eval (root train.py's plot block): the eval's
    xy [T, E, 2] over the maze, and at the `eval_freq * 5` cadence
    DDiffPG's last recluster (clusters, dendrogram, failures by mode) and
    the exploration heatmap."""
    from ddiffpg_tpu_torch.utils import plotting

    mm = maze.MAZES[cfg.env.name.replace("pointmaze", "antmaze")]
    img = plotting.plot_traj(mm, xy.cpu().numpy().reshape(-1, 2))
    logger.log_image("eval/map", img, step)
    if (cfg.algo.name == "DDiffPG" and iter_t % (cfg.eval_freq * 5) == 0
            and agent.last_plot is not None):
        trajs, clusters, Z = agent.last_plot
        if trajs:
            logger.log_image("cluster",
                             plotting.plot_cluster(mm, trajs, clusters), step)
        if Z is not None and len(Z):
            logger.log_image("hierarchy", plotting.plot_hierarchy(Z), step)
        if agent.last_unsuccess_plot is not None:
            utrajs, uclusters = agent.last_unsuccess_plot
            logger.log_image("unsuccess_cluster",
                             plotting.plot_cluster(mm, utrajs, uclusters),
                             step)
        logger.log_image("exploration_map", plotting.plot_heatmap(
            ts.density_grid.cpu().numpy()), step)


def main(argv=None):
    """Train as the command line says; returns the final state."""
    algo, resume, overrides = parse_args(
        argv if argv is not None else sys.argv[1:])
    cfg = C.Config(algo=C.algo_preset(algo)).override_strings(overrides)
    device = resolve_device(cfg.device)
    cfg = C.preprocess(cfg, if_ddiffpg=(algo.lower() == "ddiffpg"))
    cfg = cfg.override_strings(overrides)   # CLI wins over per-env presets

    logger = Logger(cfg.logdir, cfg.run_name, cfg.use_wandb,
                    dataclasses.asdict(cfg))
    logger.console(f"algo={cfg.algo.name} env={cfg.env.name} "
                   f"num_envs={cfg.num_envs} max_step={cfg.max_step} "
                   f"device={device}" + (
                       f" ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else ""))
    env, eval_env = make_envs(cfg, device)
    agent = make_agent(cfg.algo.name, env, cfg, device=device)
    eval_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    generators = {"agent": agent.generator, "env": env.env.generator,
                  "eval_env": eval_env.env.generator, "eval": eval_gen}
    with signal_requests(logger) as requests:
        try:
            return _loop(cfg, agent, eval_env, eval_gen, generators,
                         requests, resume, logger, device)
        finally:
            logger.close()


def _loop(cfg, agent, eval_env, eval_gen, generators, requests, resume,
          logger, device):
    is_ddiffpg = cfg.algo.name == "DDiffPG"
    ts = agent.init()
    need_warmup = True
    if resume:
        ts, meta = ckpt.load(resume, ts)
        for k, g in generators.items():
            g.set_state(meta["generators"][k])
        if is_ddiffpg and meta.get("last_cluster") is not None:
            agent.cluster_manager.scheduler.last_cluster = \
                meta["last_cluster"]
        if meta.get("lin_start") is not None:
            agent._lin_start = meta["lin_start"]
            agent._lin_total = meta["lin_total"]
        if meta.get("light"):
            # weights, optimizers and embeddings restored, the replay
            # fresh: refill it and rebuild the clusters from new data
            logger.console(f"resumed (light) from {resume}: replay is "
                           "fresh, rewarming + reclustering")
        else:
            need_warmup = False
            if is_ddiffpg:
                # re-stamp the walls of the restored density grid, so
                # coverage counts free cells only
                grid0 = agent._density_grid0.to(device)
                ts.density_grid = torch.where(grid0 < 0, grid0,
                                              ts.density_grid)
                agent.num_groups = int(meta.get("num_groups", 1))
                agent.num_clusters = agent.num_groups - 1
            logger.console(f"resumed from {resume} "
                           f"(num_groups={meta.get('num_groups')})")

    def timed(fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t0

    def full_meta():
        meta = {"num_groups": getattr(agent, "num_groups", 1),
                "generators": {k: g.get_state()
                               for k, g in generators.items()}}
        if is_ddiffpg:
            meta["last_cluster"] = \
                agent.cluster_manager.scheduler.last_cluster
        if hasattr(agent, "_lin_start"):
            meta["lin_start"] = agent._lin_start
            meta["lin_total"] = agent._lin_total
        return meta

    def save(name, skip, kind, step):
        nbytes, secs = timed(lambda: ckpt.save(logger.dir / name, ts,
                                               full_meta(), skip=skip))
        logger.log({f"time/ckpt_{kind}_s": secs,
                    f"time/ckpt_{kind}_bytes": nbytes}, step)
        return logger.dir / name

    def recluster(step):
        nonlocal ts
        ts, secs = timed(lambda: agent.update_cluster(ts))
        st = agent.cluster_manager.dtw_stats
        logger.log({"time/recluster_s": secs,
                    "time/recluster_dtw_s": st["seconds"],
                    "time/recluster_dtw_pairs": st["pairs"]}, step)

    if need_warmup:
        logger.console(f"warmup: {cfg.algo.warm_up} random steps x "
                       f"{cfg.num_envs} envs")
        ts, secs = timed(lambda: agent.warmup(ts))
        logger.log({"time/warmup_s": secs}, int(ts.global_step))
        logger.console(f"warmup done in {secs:.1f}s")
        if is_ddiffpg:
            recluster(int(ts.global_step))
            logger.console(f"initial clusters: {agent.num_clusters}")

    plots = "maze" in cfg.env.name and plots_available(logger)
    global_steps = int(ts.global_step)
    iter_t = 0
    steps_per_iter = cfg.algo.horizon_len * cfg.num_envs
    t_start = time.time()
    t_last, s_last = t_start, global_steps
    iter_s, iter_n = 0.0, 0
    prof = None

    def eval_actor(obs):
        return agent.eval_actor(ts, obs, generator=eval_gen)

    while global_steps < cfg.max_step:
        if cfg.max_time and time.time() - t_start > cfg.max_time:
            logger.console(f"max_time {cfg.max_time}s reached — stopping")
            break
        if requests["full_ckpt"]:
            requests["full_ckpt"] = False
            path = save(f"ckpt_{global_steps}_full.pt", (), "full",
                        global_steps)
            logger.console(f"signal: full checkpoint -> {path}")
        if requests["stop"]:
            logger.console("SIGTERM: stopping after full checkpoint")
            break
        if iter_t % cfg.eval_freq == 0:
            if is_ddiffpg and iter_t > 0:
                recluster(global_steps)
                gc = agent.last_goal_counts
                logger.console(
                    f"recluster -> {agent.num_clusters} modes"
                    + (f" (success trajs per goal: {gc})" if gc else ""))
                logger.log({f"replay/goal{g}_successes": float(n)
                            for g, n in gc.items()}
                           | {"replay/num_modes": float(agent.num_clusters)},
                           global_steps)
            (metrics, xy), secs = timed(
                lambda: eval_rollout(eval_env, eval_actor))
            logger.log(metrics | {"time/eval_s": secs}, global_steps)
            logger.console(
                f"iter {iter_t} steps {global_steps}: "
                f"eval return {metrics['eval/return']:.2f} "
                f"success {metrics['eval/success_rate']:.2f} "
                f"len {metrics['eval/episode_length']:.0f}")
            if plots:
                try:
                    plot_eval(cfg, agent, ts, xy, iter_t, global_steps,
                              logger)
                except Exception as e:   # a plot never stops the run
                    logger.console(f"plotting failed: {e!r}")
            if iter_t % (cfg.eval_freq * cfg.ckpt_freq_mult) == 0 and iter_t:
                # a light checkpoint leaves the replay out
                skip = () if cfg.ckpt_full else ("replay",)
                save(f"ckpt_{global_steps}.pt", skip,
                     "full" if cfg.ckpt_full else "light", global_steps)

        if iter_t == 20 and cfg.profile:
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA]
                if device.type == "cuda" else [])
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        ts, logs = agent.train_iter(ts, steps=global_steps)
        iter_s += time.perf_counter() - t0
        iter_n += 1
        if iter_t == 22 and prof is not None:
            _sync(device)
            prof.stop()
            (logger.dir / "profile").mkdir(exist_ok=True)
            prof.export_chrome_trace(str(logger.dir / "profile"
                                         / "trace.json"))
            prof = None
            logger.console(f"profiler trace -> {logger.dir}/profile")
        global_steps += steps_per_iter
        iter_t += 1

        if iter_t % cfg.log_freq == 0:
            # one bulk fetch (it waits for the iterations' device work)
            t0 = time.perf_counter()
            vals = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                .to(device) for v in logs.values()]).tolist()
            iter_s += time.perf_counter() - t0
            logs = dict(zip(logs, vals))
            logs["global_steps"] = global_steps
            logs["time/train_iter_s"] = iter_s / iter_n
            iter_s, iter_n = 0.0, 0
            if time.time() - t_last > 30:
                sps = (global_steps - s_last) / (time.time() - t_last)
                logs["train/env_steps_per_sec"] = sps
                logger.console(
                    f"iter {iter_t} steps {global_steps} "
                    f"({sps:,.0f} steps/s) return "
                    f"{logs.get('train/return', float('nan')):.2f}")
                t_last, s_last = time.time(), global_steps
            logger.log(logs, global_steps)

    save("ckpt_final.pt", (), "final", global_steps)
    logger.console("done")
    return ts


if __name__ == "__main__":
    main()
