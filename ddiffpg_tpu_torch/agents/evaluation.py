"""Evaluation rollouts (the reference's eval loop, ddiffpg_main.py:69-105).

Counterpart of `ddiffpg_tpu/agents/evaluation.py:eval_rollout`. The JAX
version is one jitted `lax.scan`; here it is a loop of `max_episode_length`
eager steps whose sums stay on the device until the end (one transfer). The
eval env integrates through the same substep kernel as training: the CUDA
kernel masks its own tail, so a 20-env batch needs no padding.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def eval_rollout(env, actor_fn, reset_xy: torch.Tensor | None = None):
    """Run one full episode-length rollout on the eval vector env.

    actor_fn(obs) -> action (deterministic or not; no exploration noise is
    added here). `reset_xy` is the initial reset's draw when given (tests
    feed the JAX package's). Returns (metrics, xy [T, E, 2]): the mean
    return and length of the episodes that ended, the success rate
    (successes over episodes), the episode count, and with more than one
    goal each goal's successes per episode (`eval/success_goal{g}`).
    """
    state, obs = env.reset(xy=reset_xy)
    E, dev = env.num_envs, obs.device
    inner = getattr(env, "env", env)
    n_goals = getattr(inner, "num_goals",
                      len(getattr(inner, "goal_xy", [0])))
    goal_ids = torch.arange(1, n_goals + 1, device=dev)
    zero = lambda dtype: torch.zeros((), dtype=dtype, device=dev)  # noqa: E731
    cur_ret = torch.zeros(E, device=dev)
    cur_len = torch.zeros(E, device=dev)
    ret_sum, len_sum = zero(torch.float32), zero(torch.float32)
    episodes, successes = zero(torch.int32), zero(torch.int32)
    per_goal = torch.zeros(n_goals, dtype=torch.int32, device=dev)
    xy = []
    for _ in range(env.max_episode_length):
        action = actor_fn(obs)
        state, next_obs, reward, done, info = env.step(state, action)
        cur_ret = cur_ret + reward
        cur_len = cur_len + 1.0
        d = done.to(torch.bool)
        gid = info["success"]
        ret_sum = ret_sum + torch.where(d, cur_ret, 0.0).sum()
        len_sum = len_sum + torch.where(d, cur_len, 0.0).sum()
        episodes = episodes + d.sum(dtype=torch.int32)
        successes = successes + (gid > 0).sum(dtype=torch.int32)
        per_goal = per_goal + (gid[:, None] == goal_ids[None]).sum(
            0, dtype=torch.int32)
        cur_ret = torch.where(d, 0.0, cur_ret)
        cur_len = torch.where(d, 0.0, cur_len)
        xy.append(obs[:, :2])
        obs = next_obs
    n = torch.clamp(episodes, min=1)
    vals = {
        "eval/return": ret_sum / n,
        "eval/episode_length": len_sum / n,
        "eval/success_rate": successes / torch.clamp(
            episodes + (episodes == 0).to(torch.int32), min=1),
        "eval/episodes": episodes,
    }
    if n_goals > 1:
        for g in range(n_goals):
            vals[f"eval/success_goal{g + 1}"] = per_goal[g] / n
    host = torch.stack([v.to(torch.float32) for v in vals.values()]).tolist()
    return dict(zip(vals, host)), torch.stack(xy)
