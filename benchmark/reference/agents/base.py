"""Shared agent machinery: observation normalisation, episode trackers,
exploration noise, target-policy smoothing, the C51 critic loss and the
DIPO action gradient.

Counterpart of `ddiffpg_tpu/agents/base.py` (:57-232). The optimizer chains
(`make_optimizer`, `apply_update`) are in `ops/optim.py`. Functions that
the JAX package vmaps over the group axis take `[G, b, ...]` tensors here.
A policy is any module with `act(obs, *, generator, x_init, noise)`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import torch

from benchmark.reference.ops import distributional, optim, schedules
from benchmark.reference.ops import running_stats as rs
from benchmark.reference.ops.noise import (add_mixed_normal_noise,
                                         add_normal_noise)


# --- the data-parallel hook -----------------------------------------------
# Inside `data_parallel(group)` (parallel/dp.py's train step) every
# optimizer update (`ops/optim.py:apply_update`), `update_rms` and the
# density coverage average across the ranks of `group`, a torch.distributed
# process group, where the JAX package pmeans across its mesh axis
# (`ddiffpg_tpu/agents/base.py:27-76`). Outside it nothing is reduced.
_DP_GROUP = None
# all_reduce calls and float32 elements reduced, for the caller to read
DP_COUNTS = {"all_reduce": 0, "elements": 0}


class data_parallel:
    """Context: reduce across the ranks of `group` (see above)."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        global _DP_GROUP
        self._prev = _DP_GROUP
        _DP_GROUP = self.group

    def __exit__(self, *exc):
        global _DP_GROUP
        _DP_GROUP = self._prev


def dp_group():
    """The process group of the enclosing `data_parallel`, or None."""
    return _DP_GROUP


def maybe_psum(x):
    """The sum across the ranks of x (a tensor or a list of float32
    tensors, one all_reduce for the list) inside `data_parallel`, else x.
    Every rank gets the same bits."""
    if _DP_GROUP is None:
        return x
    import torch.distributed as dist

    one = isinstance(x, torch.Tensor)
    xs = [x] if one else list(x)
    flat = torch.cat([t.reshape(-1) for t in xs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_DP_GROUP)
    DP_COUNTS["all_reduce"] += 1
    DP_COUNTS["elements"] += flat.numel()
    out = [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in xs]), xs)]
    return out[0] if one else out


def maybe_pmean(x):
    """The mean across the ranks of x (as `maybe_psum`) inside
    `data_parallel`, else x: the psum over the world size, as JAX's
    pmean."""
    if _DP_GROUP is None:
        return x
    import torch.distributed as dist

    n = dist.get_world_size(_DP_GROUP)
    s = maybe_psum(x)
    return s / n if isinstance(s, torch.Tensor) else [t / n for t in s]


def update_rms(rms: rs.RunningMeanStd, x: torch.Tensor) -> rs.RunningMeanStd:
    """Fold the batch x [N, D] into `rms` with its central moments. Inside
    `data_parallel` the ranks' batch moments are reduced first, with the
    between-rank spread of the means added to the mean within-rank
    variance (equal batch sizes; Chan's combination), so the replicated
    rms stays bitwise alike on every rank. Outside, the cross-rank terms
    vanish (the spread is exactly 0) and this is `rs.update`."""
    if _DP_GROUP is None:
        return rs.update(rms, x)
    import torch.distributed as dist

    local_mean = x.mean(dim=0)
    local_var = x.var(dim=0, unbiased=False)       # central, stable
    mean, var = maybe_pmean([local_mean, local_var])
    var = var + maybe_pmean(torch.square(local_mean - mean))
    return rs.update_from_stats(rms, mean, var,
                                x.shape[0] * dist.get_world_size(_DP_GROUP))


def norm_obs(cfg, obs_rms: rs.RunningMeanStd | None,
             obs: torch.Tensor) -> torch.Tensor:
    """obs normalised by `obs_rms` when `cfg.algo.obs_norm` is on, else
    obs as it is."""
    if cfg.algo.obs_norm and obs_rms is not None:
        return rs.normalize(obs_rms, obs)
    return obs


def to_device(x, device):
    """A copy of a state's tensors, modules, NamedTuples and lists on
    `device` (a copy on any device); None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).to(device)
    if isinstance(x, (list, tuple)):
        vals = [to_device(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_device(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    raise TypeError(type(x))


@torch.no_grad()
def soft_update(target, current, tau: float):
    """target <- current * tau + target * (1 - tau), in place, tensor by
    tensor (the JAX package's `c * tau + t * (1 - tau)`)."""
    for t, c in zip(target, current):
        t.copy_(c * tau + t * (1.0 - tau))


class Tracker(NamedTuple):
    """Fixed-window ring of finished-episode values (the reference's
    zero-initialised deque: the mean counts zeros until full)."""
    buf: torch.Tensor   # [W] float32
    ptr: torch.Tensor   # [1] int32

    @staticmethod
    def create(window: int, device="cuda") -> "Tracker":
        return Tracker(buf=torch.zeros(window, device=device),
                       ptr=torch.zeros(1, dtype=torch.int32, device=device))

    def mean(self):
        return self.buf.mean()


def tracker_push_masked(tr: Tracker, values, mask) -> Tracker:
    """Push values[mask] in ring order; values [E], mask [E] bool. A gather
    over window positions, as the JAX package (the first env wins a
    position that several land on)."""
    W = tr.buf.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    pos = (tr.ptr[0] + rank) % W
    hit = mask[None, :] & (pos[None, :] == torch.arange(
        W, device=pos.device)[:, None])                     # [W, E]
    land = hit.any(dim=1)
    src = torch.argmax(hit.to(torch.int32), dim=1)
    buf = torch.where(land, values[src], tr.buf)
    ptr = ((tr.ptr + mask.sum()) % W).to(torch.int32)
    return Tracker(buf=buf, ptr=ptr)


class EpisodeStats(NamedTuple):
    """Running per-env return and length, and finished-episode windows
    (the reference's update_tracker, ac_base.py:69-81)."""
    current_returns: torch.Tensor
    current_lengths: torch.Tensor
    return_tracker: Tracker
    step_tracker: Tracker

    @staticmethod
    def create(num_envs: int, window: int, device="cuda") -> "EpisodeStats":
        return EpisodeStats(
            current_returns=torch.zeros(num_envs, device=device),
            current_lengths=torch.zeros(num_envs, device=device),
            return_tracker=Tracker.create(window, device),
            step_tracker=Tracker.create(window, device))


def update_stats(st: EpisodeStats, reward, done) -> EpisodeStats:
    cr = st.current_returns + reward
    cl = st.current_lengths + 1.0
    done = done.to(torch.bool)
    return EpisodeStats(
        current_returns=torch.where(done, 0.0, cr),
        current_lengths=torch.where(done, 0.0, cl),
        return_tracker=tracker_push_masked(st.return_tracker, cr, done),
        step_tracker=tracker_push_masked(st.step_tracker, cl, done))


class TargetDraws(NamedTuple):
    """The standard-normal draws of `tgt_policy_action` (and of
    `explore_action`) for B rows: the policy's (a diffusion actor's
    initial sample and step noise; None for a deterministic one) and the
    added noise's."""
    x_init: torch.Tensor | None      # [B, A]
    step_noise: torch.Tensor | None  # [K, B, A]
    noise: torch.Tensor | None       # [B, A]


def noise_std(noise_cfg, it):
    """The decayed exploration std of 'fixed' noise at iteration `it` (the
    reference's noise_scheduler; decay is None in every shipped config)."""
    if noise_cfg.decay == "linear":
        return schedules.linear(it, noise_cfg.std_max, noise_cfg.std_min,
                                noise_cfg.lin_decay_iters)
    if noise_cfg.decay == "exp":
        return schedules.exponential(it, noise_cfg.std_max,
                                     noise_cfg.exp_decay_rate,
                                     noise_cfg.std_min)
    return noise_cfg.std_max


@torch.no_grad()
def explore_action(policy, obs, noise_cfg, noise_val=None, *,
                   generator: torch.Generator | None = None,
                   draws: TargetDraws | None = None):
    """The policy's action plus exploration noise, 'fixed' (N(0,
    noise_val), default std_max) or 'mixed' (std annealed across the
    batch), in [-1, 1] (the reference's get_actions, td3.py:54-73)."""
    d = draws or TargetDraws(None, None, None)
    actions = policy.act(obs, generator=generator, x_init=d.x_init,
                         noise=d.step_noise)
    if noise_cfg.type == "fixed":
        std = noise_cfg.std_max if noise_val is None else noise_val
        return add_normal_noise(actions, std, out_bounds=(-1.0, 1.0),
                                generator=generator, noise=d.noise)
    if noise_cfg.type == "mixed":
        return add_mixed_normal_noise(
            actions, noise_cfg.std_min, noise_cfg.std_max,
            out_bounds=(-1.0, 1.0), generator=generator, noise=d.noise)
    raise ValueError(f"unknown noise type {noise_cfg.type!r}")


@torch.no_grad()
def tgt_policy_action(policy, obs, noise_cfg, *,
                      generator: torch.Generator | None = None,
                      draws: TargetDraws | None = None):
    """Target-policy smoothing (td3.py:75-84): the policy's action plus
    N(0, tgt_pol_std) noise clipped to +-tgt_pol_noise_bound, in [-1, 1]."""
    d = draws or TargetDraws(None, None, None)
    actions = policy.act(obs, generator=generator, x_init=d.x_init,
                         noise=d.step_noise)
    b = noise_cfg.tgt_pol_noise_bound
    return add_normal_noise(actions, noise_cfg.tgt_pol_std,
                            noise_bounds=(-b, b), out_bounds=(-1.0, 1.0),
                            generator=generator, noise=d.noise)


def distributional_critic_loss(critic, target, z, obs, action, reward,
                               next_obs, next_actions, done, gamma: float,
                               v_min, v_max, num_atoms: int):
    """Per-group C51 double-critic BCE with the projected, elementwise-min
    target (the reference's update_critic, ddiffpg.py:322-351): [G] losses
    for groups 0..G-1 of the stacked `critic`; `target` is its target
    stack. z [G, 1, A], v_min/v_max [G, 1, 1]; the batch is [G, b, ...]."""
    with torch.no_grad():
        q1_t, q2_t = target(next_obs, next_actions)
        proj = lambda q: distributional.projection(  # noqa: E731
            q, reward, done, gamma, v_min, v_max, num_atoms, z)
        target_q = torch.minimum(proj(q1_t), proj(q2_t))
    q1, q2 = critic(obs, action)
    bce = lambda q: distributional.binary_cross_entropy(  # noqa: E731
        q, target_q, dim=(1, 2))
    return bce(q1) + bce(q2)


def action_gradient(q_min_fn, action, n_steps: int, lr: float,
                    max_grad_norm: Optional[float] = 1.0):
    """DIPO action gradient (the reference's update_target_action,
    ddiffpg.py:358-373): n Adam(eps 1e-5) ascent steps on mean Qmin per
    group, the actions kept in +-(1 - 1e-5). action [G, b, A];
    q_min_fn(a) -> [G, b]. Each group is its own problem (its own global
    norm and step count); only the actions are differentiated, so the
    critics collect no gradient."""
    lim = 1.0 - 1e-5
    spec = optim.make_optimizer(lr, max_grad_norm, weight_decay=False)
    a = torch.clamp(action, -lim, lim).detach()
    state = optim.adam_init([a], rows=1)
    for _ in range(n_steps):
        a.requires_grad_(True)
        loss = -q_min_fn(a).mean(dim=1).sum()
        (g,) = torch.autograd.grad(loss, [a])
        a = a.detach()
        optim.adam_step([a], [g], state, spec)
        a.clamp_(-lim, lim)
    return a
