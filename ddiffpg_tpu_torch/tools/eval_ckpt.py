"""Offline checkpoint evaluation with the termination-cause breakdown
(antmaze forensics).

    python -m ddiffpg_tpu_torch.tools.eval_ckpt CKPT [env=antmaze-v1]
        [num_envs=256] [eval_envs=40] [algo=ddiffpg] [seed=7] [device=auto]

Counterpart of the root `tools/eval_ckpt.py`. Loads a full or light
checkpoint written by `train.main` (`num_envs` and any dotted override
must be the run's) and rolls out the agent's eval policy (DDiffPG: the
zero mode embedding) on `eval_envs` ants from random starts for one
episode length, classifying every episode end:

    goal      reached a goal (success)
    timeout   hit max_episode_steps
    z_high    torso z above the wall-top ceiling (2 m)
    z_low     torso below the floor (-0.5 m)
    escape    |xy| > 60 m (left the world)
    other     none of these

It prints the per-goal successes, the percentiles of torso z, |xy|, the
distance to the nearest goal, |vz| and the largest hinge speed, and the
steps leading to the highest torso z (the launch trace). The rollout
steps `physics/engine_cl.py` (`use_pallas=False`: the maze's SDF walls),
as the JAX tool's does, on the card (`device=auto`, the default; it
raises without one) or on the CPU (`device=cpu`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ddiffpg_tpu_torch.tools import common


def terminations(tr: dict, n_goals: int) -> dict:
    """Episode ends of a trace ([T, E] arrays done, succ, goal_id, tout,
    z and [T, E, 2] xy) by cause, and the successes per goal id 1..n."""
    done, succ, tout = tr["done"], tr["succ"], tr["tout"]
    fail = done & ~succ & ~tout
    out = {"episodes": int(done.sum()), "goal": int((done & succ).sum()),
           "timeout": int((done & tout).sum()),
           "z_high": int((fail & (tr["z"] > 2.0)).sum()),
           "z_low": int((fail & (tr["z"] < -0.5)).sum()),
           "escape": int((fail & (np.abs(tr["xy"]) > 60.0).any(-1)).sum())}
    out["other"] = out["episodes"] - sum(
        out[k] for k in ("goal", "timeout", "z_high", "z_low", "escape"))
    gids = tr["goal_id"][done & succ]
    out["per_goal"] = {g: int((gids == g).sum())
                       for g in range(1, n_goals + 1)}
    return out


def _record(obs, done, info):
    # obs is the pre-reset obs: z and xy of the state that ended
    return {"done": done, "succ": info["success"] > 0,
            "goal_id": info["success"], "tout": info["time_outs"],
            "z": obs[:, 2], "xy": obs[:, :2], "vz": obs[:, 17],
            "hinge": obs[:, 21:29].abs().amax(-1)}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env="antmaze-v1", algo="ddiffpg",
                            num_envs="256", eval_envs="40", seed="7")
    cfg, agent, ts, _ = common.load(argv[0], kw, over)
    seed = int(kw["seed"])
    env = common.eval_env(cfg, int(kw["eval_envs"]), seed, random_init=True)
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    tr = common.rollout(
        env, lambda obs: agent.eval_actor(ts, obs, generator=gen), _record)

    goals = env.env.goal_xy.cpu().numpy()
    out = terminations(tr, len(goals))
    print("  ".join(f"{k}={out[k]}" for k in (
        "episodes", "goal", "timeout", "z_high", "z_low", "escape",
        "other")))
    out["success_rate"] = out["goal"] / max(out["episodes"], 1)
    print(f"success_rate={out['success_rate']:.3f}")
    if len(goals) > 1:
        print(f"per-goal successes: {out['per_goal']}")
    z = tr["z"]
    print(f"z: mean={z.mean():.3f} p50={np.median(z):.3f} "
          f"p95={np.percentile(z, 95):.3f} p99={np.percentile(z, 99):.3f} "
          f"max={z.max():.3f}")
    d = np.linalg.norm(tr["xy"], axis=-1)
    print(f"|xy| from origin: p50={np.median(d):.2f} "
          f"p95={np.percentile(d, 95):.2f} max={d.max():.2f}")
    gd = np.linalg.norm(tr["xy"][:, :, None, :] - goals[None, None],
                        axis=-1).min(-1)
    print(f"goal distance: p5={np.percentile(gd, 5):.2f} "
          f"min={gd.min():.2f} (hit at <=0.5)")
    vz, hs = tr["vz"], tr["hinge"]
    print(f"vz: p99={np.percentile(np.abs(vz), 99):.2f} "
          f"max={np.abs(vz).max():.2f}   hinge: p99="
          f"{np.percentile(hs, 99):.2f} max={hs.max():.2f} "
          f"@clamp={(hs > 19.5).mean():.4f}")
    t_pk, e_pk = np.unravel_index(np.argmax(z), z.shape)
    lo = max(t_pk - 12, 0)
    print(f"launch trace (env {e_pk}, steps {lo}..{t_pk}):")
    for t in range(lo, t_pk + 1):
        print(f"  t={t:4d} z={z[t, e_pk]:7.3f} vz={vz[t, e_pk]:7.2f} "
              f"hinge={hs[t, e_pk]:6.2f} "
              f"xy=({tr['xy'][t, e_pk, 0]:6.2f},{tr['xy'][t, e_pk, 1]:6.2f})")
    out.update(z_max=float(z.max()), goal_dist_min=float(gd.min()),
               hinge_max=float(hs.max()))
    return out


if __name__ == "__main__":
    main()
