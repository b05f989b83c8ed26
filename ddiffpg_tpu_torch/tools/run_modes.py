"""Where a training run's modes go: the success trajectories of each live
group of a full checkpoint, by position.

    python -m ddiffpg_tpu_torch.tools.run_modes CKPT [key=value ...]

The overrides are the run's own command line (`algo=ddiffpg
env.name=pointmaze-v1 num_envs=256 ...`): the agent is rebuilt as
`train.main` builds it, on the card (`device=auto`, the default) or the
CPU (`device=cpu`), and the full checkpoint CKPT (`ckpt_final.pt`) is
loaded into it. For each group g >= 1 of the replay's group mask
(`num_groups` from the checkpoint), it counts the group's success
trajectories and their goal ids, and takes the mean of each position
channel over every trajectory's steps: the group's mean, and the share of
its trajectories whose mean second channel (y in the mazes) is positive.
On pointmaze-v1 and antmaze-v1 the two routes to the goal pass the
central wall at y = +4 and y = -4. Prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch

from ddiffpg_tpu_torch import config as C
from ddiffpg_tpu_torch import train
from ddiffpg_tpu_torch.agents import make_agent
from ddiffpg_tpu_torch.utils import checkpoint as ckpt


def mode_routes(ts, num_groups: int, pos_dim: int) -> list:
    """Per group g in 1..num_groups-1: its successes, their goal ids, the
    group's mean position and the share of positive mean y."""
    rep = ts.replay
    L = rep.obs.shape[1] - 1
    steps = torch.arange(L + 1, device=rep.obs.device)
    live = (steps[None] <= rep.length[:, None]).to(rep.obs.dtype)
    mean_pos = (rep.obs[:, :, :pos_dim] * live[..., None]).sum(1) \
        / live.sum(1).clamp(min=1)[:, None]
    succ = (rep.traj_id >= 0) & (rep.length > 0) & (rep.success > 0)
    out = []
    for g in range(1, num_groups):
        m = rep.group_mask[g] & succ
        n = int(m.sum())
        goals = torch.unique(rep.success[m]).tolist()
        pos = mean_pos[m]
        out.append({"group": g, "successes": n, "goal_ids": goals,
                    "mean_position": pos.mean(0).tolist() if n else None,
                    "share_y_positive": float((pos[:, 1] > 0).float()
                                              .mean()) if n else None})
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    path, rest = argv[0], argv[1:]
    algo, _, overrides = train.parse_args(rest)
    cfg = C.Config(algo=C.algo_preset(algo)).override_strings(overrides)
    device = train.resolve_device(cfg.device)
    cfg = C.preprocess(cfg, if_ddiffpg=(algo.lower() == "ddiffpg"))
    cfg = cfg.override_strings(overrides)
    env, _ = train.make_envs(cfg, device)
    agent = make_agent(cfg.algo.name, env, cfg, device=device)
    ts, meta = ckpt.load(path, agent.init())
    if meta.get("light"):
        raise SystemExit(f"{path} is a light checkpoint: it has no replay")
    G = int(meta["num_groups"])
    print(json.dumps({"checkpoint": str(path), "env": cfg.env.name,
                      "num_groups": G, "modes": mode_routes(
                          ts, G, agent.cluster_manager.traj_dim)}))


if __name__ == "__main__":
    main()
