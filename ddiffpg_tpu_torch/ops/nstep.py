"""N-step return folding over vectorized rollouts.

Counterpart of `ddiffpg_tpu/ops/nstep.py` (the reference's `NStepReplay`
and `compute_nstep_return`): a FIFO window of the last n transitions per
env that emits the n-step-folded transition, with early-done masking, once
the window is full. Every function returns a new window; the validity is a
bool tensor, so nothing waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NStepState(NamedTuple):
    obs: torch.Tensor        # [E, n, D]
    action: torch.Tensor     # [E, n, A]
    reward: torch.Tensor     # [E, n, 1]
    next_obs: torch.Tensor   # [E, n, D]
    done: torch.Tensor       # [E, n, 1] bool
    count: torch.Tensor      # int32 scalar

    @staticmethod
    def create(num_envs: int, nstep: int, obs_dim: int, action_dim: int,
               device="cuda") -> "NStepState":
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return NStepState(
            obs=z(num_envs, nstep, obs_dim),
            action=z(num_envs, nstep, action_dim),
            reward=z(num_envs, nstep, 1),
            next_obs=z(num_envs, nstep, obs_dim),
            done=torch.zeros((num_envs, nstep, 1), dtype=torch.bool,
                             device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))


def _shift(buf, new):
    return torch.cat([buf[:, 1:], new[:, None].to(buf.dtype)], dim=1)


def fold_window(reward, done, next_obs, gamma: float):
    """Fold an [E, n, ...] window into n-step (reward [E, 1], next_obs
    [E, D], done [E, 1]): rewards discount-summed up to and including the
    first done, next_obs at the first done (or the last slot), done if
    any slot is."""
    n = reward.shape[1]
    d = done[..., 0]                                        # [E, n]
    done_any = d.any(dim=1)
    first_done = torch.argmax(d.to(torch.int32), dim=1)    # 0 if none
    steps = torch.where(done_any, first_done, n - 1)        # [E]
    mask = torch.arange(n, device=d.device)[None, :] <= steps[:, None]
    gammas = torch.tensor(gamma ** np.arange(n), dtype=reward.dtype,
                          device=reward.device)[None, :, None]
    r = (reward * gammas * mask[..., None]).sum(dim=1)
    nobs = torch.take_along_dim(next_obs, steps[:, None, None], dim=1)[:, 0]
    return r, nobs, done_any[:, None]


def push(state: NStepState, obs, action, reward, done, next_obs,
         gamma: float):
    """Push one vector-env transition (reward [E, 1], done [E, 1] bool).
    Returns (state, (obs0, act0, r, nobs, dn, valid)): the window's oldest
    transition folded, and `valid` (a bool tensor) false until the window
    has filled."""
    st = NStepState(
        obs=_shift(state.obs, obs), action=_shift(state.action, action),
        reward=_shift(state.reward, reward),
        next_obs=_shift(state.next_obs, next_obs),
        done=_shift(state.done, done), count=state.count + 1)
    n = st.obs.shape[1]
    r, nobs, dn = fold_window(st.reward, st.done, st.next_obs, gamma)
    return st, (st.obs[:, 0], st.action[:, 0], r, nobs, dn, st.count >= n)
