"""Slot-based episodic trajectory store, the DDiffPG replay.

Counterpart of `ddiffpg_tpu/replay/episodic.py` (the reference's
DiffusionGoalBuffer + DiffusionReplayBuffer), the same function on the same
integer data:

  * S trajectory slots x (L+1) steps: obs[s, t] is the t-th obs, so the
    next obs of transition t is obs[s, t+1] (the true terminal obs).
  * per-slot length, success goal id, increasing traj id (-1: empty) and
    the per-goal closest approach (`frontier`).
  * group_mask [G_max, S]: group membership (row 0: every trajectory).
  * target_action [G_max, S, L, A]: the per-group improved actions.
  * in-flight per-env episodes (`tmp_*`) until they finish.
  * `sample_group` draws uniformly over a group's transitions; group 0
    also over the in-flight ones.

Unlike the JAX package, tables are updated in place, and `add` writes only
the finishing envs' slot rows. The JAX formulation rewrites E slot rows of
every table on each env step (non-finishing envs write their slot's
current content back, so its scatter has no duplicate indices); writing
only the finishers' rows gives the same tables. Choosing those rows needs
their indices on the host, so `add` waits once on the device per env step
(`torch.nonzero`); with no finisher, it skips the flush entirely.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ddiffpg_tpu_torch.utils import trace

# "never recorded" sentinel for per-goal closest-approach distances
FRONTIER_INF = 1.0e9


class EpisodicReplay(NamedTuple):
    obs: torch.Tensor            # [S, L+1, D] float32
    action: torch.Tensor         # [S, L, A] float32
    reward: torch.Tensor         # [S, L] float32
    done: torch.Tensor           # [S, L] bool (termination XOR timeout)
    length: torch.Tensor         # [S] int32 (0: empty)
    success: torch.Tensor        # [S] int32 goal id (0: failure)
    traj_id: torch.Tensor        # [S] int32 (-1: empty)
    frontier: torch.Tensor       # [S, NG] float32 closest approach per goal
    next_id: torch.Tensor        # [1] int32
    group_mask: torch.Tensor     # [G, S] bool
    target_action: torch.Tensor  # [G, S, L, A] float32
    tmp_obs: torch.Tensor        # [E, L+1, D] float32
    tmp_action: torch.Tensor     # [E, L, A] float32
    tmp_reward: torch.Tensor     # [E, L] float32
    tmp_done: torch.Tensor       # [E, L] bool
    tmp_len: torch.Tensor        # [E] int32 (steps stored)
    tmp_frontier: torch.Tensor   # [E, NG] float32 running per-goal min

    @staticmethod
    def create(capacity: int, max_len: int, num_envs: int, obs_dim: int,
               action_dim: int, max_groups: int, num_goals: int = 1,
               device: str | torch.device = "cuda") -> "EpisodicReplay":
        if capacity < 2 * num_envs:
            raise ValueError(f"episodic capacity {capacity} must be >= 2 * "
                             f"num_envs ({num_envs})")
        S, L, E, G, NG = capacity, max_len, num_envs, max_groups, num_goals
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        b = dict(dtype=torch.bool, device=device)
        group_mask = torch.zeros((G, S), **b)
        group_mask[0] = True
        return EpisodicReplay(
            obs=torch.zeros((S, L + 1, obs_dim), **f32),
            action=torch.zeros((S, L, action_dim), **f32),
            reward=torch.zeros((S, L), **f32),
            done=torch.zeros((S, L), **b),
            length=torch.zeros((S,), **i32),
            success=torch.zeros((S,), **i32),
            traj_id=torch.full((S,), -1, **i32),
            frontier=torch.full((S, NG), FRONTIER_INF, **f32),
            next_id=torch.zeros((1,), **i32),
            group_mask=group_mask,
            target_action=torch.zeros((G, S, L, action_dim), **f32),
            tmp_obs=torch.zeros((E, L + 1, obs_dim), **f32),
            tmp_action=torch.zeros((E, L, action_dim), **f32),
            tmp_reward=torch.zeros((E, L), **f32),
            tmp_done=torch.zeros((E, L), **b),
            tmp_len=torch.zeros((E,), **i32),
            tmp_frontier=torch.full((E, NG), FRONTIER_INF, **f32))

    @property
    def capacity(self):
        return self.obs.shape[0]

    @property
    def max_len(self):
        return self.action.shape[1]


def _unreached_goals(buf: EpisodicReplay) -> torch.Tensor:
    """[NG] bool: goals with no success on record; all True when every
    goal is reached, and for NG == 1."""
    ng = buf.frontier.shape[1]
    dev = buf.frontier.device
    if ng == 1:
        return torch.ones((1,), dtype=torch.bool, device=dev)
    valid = buf.traj_id >= 0
    goal = torch.arange(1, ng + 1, device=dev, dtype=torch.int32)[:, None]
    un = ~(valid[None] & (buf.success[None] == goal)).any(dim=1)
    return torch.where(un.any(), un, torch.ones_like(un))


def frontier_scores(buf: EpisodicReplay) -> Tuple[torch.Tensor, torch.Tensor]:
    """([S] score, [S] bool candidates): score = -closest approach to the
    nearest unreached goal of a stored failure."""
    cand = (buf.traj_id >= 0) & (buf.success == 0) & \
        (buf.frontier.min(dim=-1).values < FRONTIER_INF / 2)
    un = _unreached_goals(buf)
    d = torch.where(un[None, :], buf.frontier,
                    torch.inf).min(dim=-1).values
    ok = cand & torch.isfinite(d)
    return torch.where(ok, -d, -torch.inf), ok


def frontier_mask(buf: EpisodicReplay, keep: int) -> torch.Tensor:
    """[S] bool: the `keep` stored failures closest to an unreached goal
    (ties may admit a few more); empty for keep <= 0."""
    if keep <= 0:
        return torch.zeros((buf.capacity,), dtype=torch.bool,
                           device=buf.traj_id.device)
    score, cand = frontier_scores(buf)
    kth = torch.sort(score, descending=True).values[
        min(keep, buf.capacity) - 1]
    return cand & (score >= kth)


def frontier_dist(buf: EpisodicReplay) -> torch.Tensor:
    """Scalar: the closest any stored failure came to an unreached goal
    (FRONTIER_INF with none on record)."""
    score, cand = frontier_scores(buf)
    return torch.where(cand.any(), -score.max(),
                       torch.tensor(FRONTIER_INF, device=score.device))


@torch.no_grad()
def add(buf: EpisodicReplay, obs, action, reward, next_obs, done_bootstrap,
        episode_end, success, goal_dist=None,
        frontier_keep: int = 0) -> EpisodicReplay:
    """Record one vector-env transition in place; flush finished episodes
    into slots. Returns `buf`.

    obs/next_obs [E, D], action [E, A], reward [E], done_bootstrap [E]
    (termination for bootstrapping), episode_end [E] (terminated or
    truncated: flush), success [E] goal id at this step, goal_dist [E, NG]
    (optional) distances to the goal anchors whose episode minimum is the
    trajectory's frontier record. frontier_keep > 0 protects the K failures
    closest to an unreached goal from age eviction.

    Slot choice, as the JAX package: free slots first, then the oldest
    failures, then the oldest successes (+2^28 on the traj id), then the
    oldest protected frontier failures (+2^29), by a stable argsort; the
    k-th finishing env (in env order) takes the k-th slot.
    """
    with trace.span("replay_add"):
        E = obs.shape[0]
        if buf.capacity < 2 * E:
            raise ValueError("episodic capacity must be >= 2 * num_envs")
        dev = obs.device
        t = buf.tmp_len.long()
        env = torch.arange(E, device=dev)
        buf.tmp_obs[env, t] = obs
        buf.tmp_obs[env, t + 1] = next_obs
        buf.tmp_action[env, t] = action
        buf.tmp_reward[env, t] = reward
        buf.tmp_done[env, t] = done_bootstrap.to(torch.bool)
        if goal_dist is not None:
            torch.minimum(buf.tmp_frontier, goal_dist, out=buf.tmp_frontier)
        buf.tmp_len.add_(1)

        fin = torch.nonzero(episode_end.to(torch.bool)).squeeze(1)
        n = fin.numel()
        if n == 0:
            return buf
        protect = (buf.traj_id >= 0) & (buf.success > 0)
        fmask = frontier_mask(buf, frontier_keep)
        zero = torch.zeros_like(buf.traj_id)
        sort_key = torch.where(
            buf.traj_id < 0, torch.full_like(buf.traj_id, -2 ** 30),
            buf.traj_id + torch.where(protect, 2 ** 28, zero)
            + torch.where(fmask, 2 ** 29, zero))
        slot = torch.argsort(sort_key, stable=True)[:n]

        buf.obs[slot] = buf.tmp_obs[fin]
        buf.action[slot] = buf.tmp_action[fin]
        buf.reward[slot] = buf.tmp_reward[fin]
        buf.done[slot] = buf.tmp_done[fin]
        buf.length[slot] = buf.tmp_len[fin]
        buf.success[slot] = success[fin].to(torch.int32)
        buf.traj_id[slot] = buf.next_id + torch.arange(n, device=dev,
                                                       dtype=torch.int32)
        buf.frontier[slot] = buf.tmp_frontier[fin]
        buf.next_id.add_(n)
        # group 0 takes the fresh slots at once; other groups drop them
        buf.group_mask[:, slot] = False
        buf.group_mask[0, slot] = True
        # fresh trajectories start with target_action = raw actions in every
        # group row (the reference initialises buf_target_action to actions)
        buf.target_action[:, slot] = buf.tmp_action[fin][None]

        for x in (buf.tmp_obs, buf.tmp_action, buf.tmp_reward, buf.tmp_done,
                  buf.tmp_len):
            x[fin] = 0
        buf.tmp_frontier[fin] = FRONTIER_INF
        return buf


class GroupBatch(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    target_action: torch.Tensor
    reward: torch.Tensor       # [b, 1]
    next_obs: torch.Tensor
    done: torch.Tensor         # [b, 1] float32
    slot: torch.Tensor         # [b] trajectory slot of each sample
    step: torch.Tensor         # [b]
    from_buffer: torch.Tensor  # [b] bool (False: an in-flight sample)


def draw(batch: int, total: torch.Tensor,
         generator: torch.Generator | None = None) -> torch.Tensor:
    """`batch` uniform ints in [0, total) for an int tensor `total`,
    computed on its device (no host sync)."""
    r = torch.rand((batch,), generator=generator, device=total.device)
    return torch.minimum((r * total).to(torch.int64), total - 1)


def group_totals(buf: EpisodicReplay, group: int, mix_temp: bool,
                 frontier_keep: int = 0):
    """The ranges of `sample_group`'s three draws, as int64 tensors: every
    transition of the group (and the in-flight ones with mix_temp), its
    successes', its frontier failures' (each at least 1)."""
    mask = buf.group_mask[group] & (buf.length > 0)
    lens = torch.where(mask, buf.length, 0).long()
    total = lens.sum()
    if mix_temp:
        total = total + buf.tmp_len.long().sum()
    succ = torch.where(mask & (buf.success > 0), lens, 0).sum()
    front = torch.where(mask & frontier_mask(buf, frontier_keep), lens,
                        0).sum()
    return tuple(torch.clamp(x, min=1) for x in (total, succ, front))


def _draw(u, batch, total, generator, device):
    if u is not None:
        return u.to(device=device, dtype=torch.int64)
    return draw(batch, total, generator)


def _invert(cum, u, max_len: int, rows: int):
    """(row, step) of flat transition index u over cumulative lengths."""
    row = torch.searchsorted(cum, u, right=True).clamp(0, rows - 1)
    prev = torch.where(row > 0, cum[row - 1], 0)
    return row, (u - prev).clamp(0, max_len - 1)


def sample_group(buf: EpisodicReplay, group: int, batch: int,
                 mix_temp: bool, success_frac: float = 0.0,
                 frontier_frac: float = 0.0, frontier_keep: int = 0,
                 frontier_frac_near: float = 0.0,
                 frontier_near_dist: float = 0.0, *,
                 generator: torch.Generator | None = None,
                 u: torch.Tensor | None = None,
                 u_success: torch.Tensor | None = None,
                 u_frontier: torch.Tensor | None = None) -> GroupBatch:
    """Uniform sample of `batch` transitions of a group (and of the
    in-flight episodes for group 0, `mix_temp`); each draw goes to the
    in-flight pool with probability temp / (temp + group) transitions.

    `u` [batch] (in [0, total)), `u_success` and `u_frontier` are the
    integer draws, taken from `generator` when not given. success_frac
    (mode groups) draws the head of the batch from the group's successes;
    frontier_frac (group 0) the tail from the frontier failures, escalated
    to frontier_frac_near when the frontier is within frontier_near_dist
    of an unreached goal (see the JAX package's docstring).
    """
    dev = buf.length.device
    S, L = buf.capacity, buf.max_len
    mask = buf.group_mask[group] & (buf.length > 0)
    lens = torch.where(mask, buf.length, 0).long()
    cum = torch.cumsum(lens, 0)
    total_buf = cum[-1]
    total_tmp = buf.tmp_len.long().sum() if mix_temp else \
        torch.zeros((), dtype=torch.int64, device=dev)
    total = torch.clamp(total_buf + total_tmp, min=1)
    u = _draw(u, batch, total, generator, dev)
    from_buffer = (u < torch.clamp(total_buf, min=1)) & (total_buf > 0)
    ub = torch.minimum(u, torch.clamp(total_buf - 1, min=0))
    slot, step = _invert(cum, ub, L, S)
    rows = torch.arange(batch, device=dev)

    if success_frac > 0.0 and group > 0:
        k_rows = int(round(batch * success_frac))
        lens_s = torch.where(mask & (buf.success > 0), buf.length, 0).long()
        cum_s = torch.cumsum(lens_s, 0)
        us = _draw(u_success, batch, torch.clamp(cum_s[-1], min=1),
                   generator, dev)
        slot_s, step_s = _invert(cum_s, us, L, S)
        use_s = (rows < k_rows) & (cum_s[-1] > 0)
        slot = torch.where(use_s, slot_s, slot)
        step = torch.where(use_s, step_s, step)
        from_buffer = from_buffer | use_s

    frontier_on = frontier_frac > 0.0 or (
        frontier_frac_near > 0.0 and frontier_near_dist > 0.0)
    if frontier_on and group == 0:
        k_rows = int(round(batch * frontier_frac))
        lens_f = torch.where(mask & frontier_mask(buf, frontier_keep),
                             buf.length, 0).long()
        cum_f = torch.cumsum(lens_f, 0)
        uf = _draw(u_frontier, batch, torch.clamp(cum_f[-1], min=1),
                   generator, dev)
        slot_f, step_f = _invert(cum_f, uf, L, S)
        cut = torch.tensor(batch - k_rows, device=dev)
        if frontier_near_dist > 0.0 and frontier_frac_near > frontier_frac:
            k_hi = min(int(round(batch * frontier_frac_near)), batch)
            near = frontier_dist(buf) < frontier_near_dist
            cut = torch.where(near, batch - k_hi, cut)
        use_f = (rows >= cut) & (cum_f[-1] > 0)
        slot = torch.where(use_f, slot_f, slot)
        step = torch.where(use_f, step_f, step)
        from_buffer = from_buffer | use_f

    # in-flight route
    tcum = torch.cumsum(buf.tmp_len.long(), 0)
    ut = torch.clamp(torch.minimum(u - total_buf,
                                   torch.clamp(total_tmp - 1, min=0)), min=0)
    tenv, tstep = _invert(tcum, ut, L, buf.tmp_len.shape[0])

    def pick(slots, tmps, s_idx, t_idx):
        a, b = slots[slot, s_idx], tmps[tenv, t_idx]
        fb = from_buffer.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(fb, a, b)

    return GroupBatch(
        obs=pick(buf.obs, buf.tmp_obs, step, tstep),
        action=pick(buf.action, buf.tmp_action, step, tstep),
        target_action=torch.where(from_buffer[:, None],
                                  buf.target_action[group, slot, step],
                                  buf.tmp_action[tenv, tstep]),
        reward=pick(buf.reward, buf.tmp_reward, step, tstep)[:, None],
        next_obs=pick(buf.obs, buf.tmp_obs, step + 1, tstep + 1),
        done=pick(buf.done, buf.tmp_done, step,
                  tstep).to(torch.float32)[:, None],
        slot=slot.to(torch.int32), step=step.to(torch.int32),
        from_buffer=from_buffer)


@torch.no_grad()
def write_target_actions(buf: EpisodicReplay, group, slot, step,
                         from_buffer, new_action) -> EpisodicReplay:
    """Scatter improved actions [n, A] into the target-action table in
    place at (group, slot, step) [n] (`group` an int or [n] ints); the
    in-flight samples are skipped (the reference's update_target_action,
    simple_replay.py:198-200).

    Without a host sync: an in-flight row is redirected to the first
    buffer row and writes that row's value, so every write to one index
    carries the same value and the result does not depend on the order
    of duplicate writes (two buffer samples of one transition of one
    group start from the same action and get the same update)."""
    n = slot.shape[0]
    group = torch.as_tensor(group, device=slot.device).expand(n)
    first = torch.argmax(from_buffer.to(torch.int32))
    j = torch.where(from_buffer, torch.arange(n, device=slot.device), first)
    g, s, t = group[j].long(), slot[j].long(), step[j].long()
    cur = buf.target_action[g, s, t]
    val = torch.where(from_buffer.any(), new_action[j], cur)
    buf.target_action[g, s, t] = val
    return buf


@torch.no_grad()
def set_groups(buf: EpisodicReplay, group_mask, parent_idx) -> EpisodicReplay:
    """Recluster result -> tables. group_mask [G, S] bool (row 0: every
    valid trajectory); parent_idx [G] int: the old target-action row each
    new row inherits (0: the explore row, -1: reset to the raw actions)."""
    G = buf.group_mask.shape[0]
    parent_idx = torch.as_tensor(parent_idx, device=buf.action.device)
    src = parent_idx.clamp(0, G - 1).long()
    inherited = buf.target_action[src]
    raw = buf.action[None].expand_as(inherited)
    ta = torch.where((parent_idx < 0)[:, None, None, None], raw, inherited)
    buf.target_action.copy_(ta)
    buf.group_mask.copy_(torch.as_tensor(group_mask,
                                         device=buf.action.device).bool())
    return buf
