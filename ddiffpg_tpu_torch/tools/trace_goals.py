"""Where do a DDiffPG checkpoint's mode-conditioned rollouts go?

    python -m ddiffpg_tpu_torch.tools.trace_goals CKPT [env=antmaze-v2]
        [num_envs=256] [eval_envs=40] [seed=11] [device=auto]

Counterpart of the root `tools/trace_goals.py`. For each conditioning
(the zero embedding, explore, each live mode) one rollout of `eval_envs`
envs from random starts, for one episode length: the episodes, the
timeouts, the successes per goal, the closest approach to each goal over
the whole batch, and the mean and spread of the timeouts' terminal xy. On
a multi-goal maze a mode can head the right way and time out, which the
success rate alone does not show. Takes a full or light checkpoint
written by `train.main` (`num_envs` and any dotted override must be the
run's). The rollouts step `physics/engine_cl.py` (`use_pallas=False`),
as the JAX tool's do, on the card (`device=auto`, the default; it raises
without one) or on the CPU (`device=cpu`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ddiffpg_tpu_torch.tools import common


def _record(obs, done, info):
    return {"done": done, "gid": info["success"], "tout": info["time_outs"],
            "xy": obs[:, :2]}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env="antmaze-v2", num_envs="256",
                            eval_envs="40", seed="11")
    cfg, agent, ts, meta = common.load(argv[0], kw, over)
    G = int(meta.get("num_groups", 1))
    print(f"num_groups={G} global_step={int(ts.global_step)}")
    seed = int(kw["seed"])
    env = common.eval_env(cfg, int(kw["eval_envs"]), seed, random_init=True)
    goals = env.env.goal_xy.cpu().numpy()                 # [n_goals, 2]
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    out = {}
    for name, emb in common.conditionings(agent, ts, G):
        tr = common.rollout(env, common.actor_with(agent, ts, emb, gen),
                            _record)
        done, gid, xy = tr["done"], tr["gid"], tr["xy"]
        per = {g: int(((gid == g) & done).sum())
               for g in range(1, len(goals) + 1)}
        tout = int((done & tr["tout"]).sum())
        mins = np.linalg.norm(xy[:, :, None, :] - goals[None, None],
                              axis=-1).min(axis=(0, 1))
        print(f"[{name:8s}] episodes={int(done.sum())} timeouts={tout} "
              f"per-goal={per} min-dist-to-goal="
              f"{np.array2string(mins, precision=2)}")
        t_idx, e_idx = np.where(done & tr["tout"])
        if len(t_idx):
            term = xy[t_idx, e_idx]
            print(f"           timeout terminal xy: "
                  f"mean={np.array2string(term.mean(0), precision=2)} "
                  f"spread={np.array2string(term.std(0), precision=2)}")
        out[name] = {"episodes": int(done.sum()), "timeouts": tout,
                     "per_goal": per, "min_dist": mins.tolist()}
    return out


if __name__ == "__main__":
    main()
