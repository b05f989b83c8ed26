"""What the harness takes from the program: its configuration object,
built from a configuration file, and the state a train cell's reference
starts from."""

from __future__ import annotations

import dataclasses

import torch

DROPPED = ("num_envs", "seed", "logdir", "run_name", "use_wandb", "device",
           "profile")


def flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def program_config(file_config: dict, num_envs: int, seed: int):
    """The program's `Config` holding every value of the file's `config`,
    with the run's env count and seed; raises if the program reads any of
    them back differently."""
    from ddiffpg_tpu_torch.config import Config, algo_preset

    cfg = Config(algo=algo_preset(file_config["algo"]["name"]))
    cfg = cfg.override(**flatten(file_config), num_envs=num_envs, seed=seed)
    got = dataclasses.asdict(cfg)
    for k in DROPPED:
        got.pop(k)
    if flatten(got) != flatten(file_config):
        diff = {k for k, v in flatten(got).items()
                if flatten(file_config).get(k, object()) != v}
        raise RuntimeError(f"the program's config differs from the file's "
                           f"on {sorted(diff)}")
    return cfg


def cpu(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def train_snapshot(agent, ts, steps: int) -> dict:
    """The program's own state that a train cell's reference starts from
    (on the host): the replay's raw trajectories and its group mask (which
    the reference judges and works out again), the env state and obs, the
    trackers, the step counts, the density grid, the live groups. The
    weights and optimizer states are the harness's; the target actions
    and the intrinsic statistics the reference's own."""
    st = ts.stats
    return {
        "replay": {k: cpu(v) for k, v in ts.replay._asdict().items()
                   if k != "target_action"},
        "env_state": tuple(cpu(x) for x in ts.env_state),
        "obs": cpu(ts.obs),
        "stats": {"current_returns": cpu(st.current_returns),
                  "current_lengths": cpu(st.current_lengths),
                  "return_tracker": tuple(map(cpu, st.return_tracker)),
                  "step_tracker": tuple(map(cpu, st.step_tracker))},
        "global_step": cpu(ts.global_step),
        "density_grid": cpu(ts.density_grid),
        "num_groups": agent.num_groups,
        "num_clusters": agent.num_clusters,
        "last_goal_counts": dict(agent.last_goal_counts),
        "steps": steps,
    }

