"""Synthetic successes on antmaze-v1's two corridors, written into the
program's episodic replay through its `add`.

Copied from `chip_smoke.py` (`path_track`, `route_track`,
`failure_track`, `write_trajectories`, `fill_plans`), with the routes, the
goal and the counts taken from the traffic file: a recluster of the
replay finds one mode per corridor, so the train cell runs at three live
groups (the explore group and two modes).
"""

from __future__ import annotations

import numpy as np
import torch


def path_track(rng, n: int, corners, wander: float,
               noise: float) -> np.ndarray:
    """n + 1 points evenly along the polyline `corners`, with a random
    walk of step `wander` and point noise `noise` added."""
    corners = np.asarray(corners, np.float64)
    seg = np.linalg.norm(np.diff(corners, axis=0), axis=1)
    at = np.concatenate([[0], np.cumsum(seg)])
    s = np.linspace(0.0, seg.sum(), n + 1)
    D = corners.shape[1]
    pts = np.stack([np.interp(s, at, corners[:, d]) for d in range(D)], 1)
    walk = np.cumsum(rng.randn(n + 1, D), axis=0) * wander
    return pts + walk + noise * rng.randn(n + 1, D)


def route_track(rng, n: int, y: float, goal) -> np.ndarray:
    """n + 1 xy points of a success: from the reset cell (0, 0) along the
    corridor at height y to the goal, with a slow wander and point
    noise."""
    gx, gy = goal
    return path_track(rng, n, [[0.0, 0.0], [0.0, y], [gx, y], [gx, gy]],
                      0.02, 0.05)


def failure_track(rng, n: int) -> np.ndarray:
    """n + 1 xy points of a failure: a random walk in the reset cell."""
    return np.clip(np.cumsum(rng.randn(n + 1, 2) * 0.1, axis=0), -1.9, 1.9)


def fill_plans(rng, n_env: int, n_success: int, steps: int, routes,
               min_len: int):
    """Per-env plans: envs 0.. first run a success (the routes in turn,
    lengths min_len to steps - 20) then a failure to the window's end; of
    the n_success of them the last 24 run a success of the whole window;
    the others one failure of the window."""
    plans = []
    for e in range(n_env):
        y = routes[e % len(routes)]
        if e < n_success - 24:
            n = int(rng.randint(min_len, steps - 19))
            plans.append([("success", n, y), ("failure", steps - n, 0.0)])
        elif e < n_success:
            plans.append([("success", steps, y)])
        else:
            plans.append([("failure", steps, 0.0)])
    return plans


def write_trajectories(ep, rep, plans, steps: int, rng, goal):
    """Record the plans through `ep.add` (the program's replay module),
    one env step at a time for `steps` steps: a success gets reward 10 and
    goal id 1 on its last step. Obs are the track's xy and zeros."""
    E, D = rep.tmp_obs.shape[0], rep.obs.shape[-1]
    A = rep.action.shape[-1]
    xy = np.zeros((2, steps, E, 2), np.float32)
    end = np.zeros((steps, E), bool)
    succ = np.zeros((steps, E), np.int32)
    for e, plan in enumerate(plans):
        t = 0
        for kind, n, y in plan + [("flight", steps - sum(
                p[1] for p in plan), 0.0)]:
            if n <= 0:
                continue
            tr = route_track(rng, n, y, goal) if kind == "success" else \
                failure_track(rng, n)
            xy[0, t: t + n, e], xy[1, t: t + n, e] = tr[:-1], tr[1:]
            if kind != "flight":
                end[t + n - 1, e] = True
                succ[t + n - 1, e] = kind == "success"
            t += n
    dev = rep.obs.device
    xy, end, succ = (torch.tensor(a, device=dev) for a in (xy, end, succ))
    g = torch.tensor([list(goal)], device=dev, dtype=torch.float32)
    obs = torch.zeros((2, steps, E, D), device=dev)
    obs[..., :2] = xy
    for t in range(steps):
        ep.add(rep, obs[0, t], torch.zeros((E, A), device=dev),
               10.0 * succ[t], obs[1, t], end[t] & (succ[t] > 0), end[t],
               succ[t], goal_dist=torch.linalg.vector_norm(
                   obs[1, t, :, None, :2] - g, dim=-1))


def routes_found(rep, num_groups: int) -> bool:
    """Each corridor's successes lie in one mode, the two modes differ and
    their masks are disjoint on the successes (`chip_smoke.py`'s
    `recluster_checks`)."""
    valid = (rep.traj_id >= 0) & (rep.length > 0)
    succ = valid & (rep.success > 0)
    L = rep.obs.shape[1] - 1
    steps = torch.arange(L + 1, device=rep.obs.device)
    live = (steps[None] <= rep.length[:, None]).float()
    mean_y = (rep.obs[:, :, 1] * live).sum(1) / live.sum(1).clamp(min=1)
    upper, lower = succ & (mean_y > 0), succ & (mean_y < 0)
    m = rep.group_mask
    g_up = [g for g in range(1, num_groups) if bool(m[g][upper].all())]
    g_lo = [g for g in range(1, num_groups) if bool(m[g][lower].all())]
    return (len(g_up) == len(g_lo) == 1 and g_up != g_lo
            and not bool((m[1:num_groups].sum(0) > 1)[succ].any())
            and bool(upper.any()) and bool(lower.any()))
