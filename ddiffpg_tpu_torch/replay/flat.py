"""Preallocated ring replay of transitions with a target-action column.

Counterpart of `ddiffpg_tpu/replay/flat.py` (the reference's
`ReplayBuffer`): wraparound writes, uniform sampling, and
`update_target_action` writing DIPO-improved actions back at the sampled
rows. The tables live on the agent's device and are written in place;
`ptr` and `size` are int32 scalar tensors there, so no call waits on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddiffpg_tpu_torch.replay.episodic import draw


class FlatReplay(NamedTuple):
    obs: torch.Tensor            # [C, D]
    action: torch.Tensor         # [C, A]
    target_action: torch.Tensor  # [C, A]
    reward: torch.Tensor         # [C, 1]
    next_obs: torch.Tensor       # [C, D]
    done: torch.Tensor           # [C, 1] bool
    ptr: torch.Tensor            # int32 scalar
    size: torch.Tensor           # int32 scalar

    @staticmethod
    def create(capacity: int, obs_dim: int, action_dim: int,
               device="cuda") -> "FlatReplay":
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        i32 = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                                  device=device)
        return FlatReplay(
            obs=z(capacity, obs_dim), action=z(capacity, action_dim),
            target_action=z(capacity, action_dim), reward=z(capacity, 1),
            next_obs=z(capacity, obs_dim),
            done=torch.zeros((capacity, 1), dtype=torch.bool, device=device),
            ptr=i32(), size=i32())

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


@torch.no_grad()
def add(buf: FlatReplay, obs, action, reward, next_obs, done,
        valid=True) -> FlatReplay:
    """Write B transitions at ptr.. with wraparound, in place. The rows
    are written either way; `ptr` and `size` advance only where `valid`
    (a bool or a bool tensor) holds, as the JAX TD3 gates its n-step
    window's output."""
    B, C = obs.shape[0], buf.capacity
    idx = (buf.ptr + torch.arange(B, device=obs.device)) % C
    for dst, src in ((buf.obs, obs), (buf.action, action),
                     (buf.target_action, action),
                     (buf.reward, reward.reshape(B, 1)),
                     (buf.next_obs, next_obs),
                     (buf.done, done.reshape(B, 1).to(torch.bool))):
        dst.index_copy_(0, idx, src.to(dst.dtype))
    valid = torch.as_tensor(valid, device=obs.device)
    buf.ptr.copy_(torch.where(valid, (buf.ptr + B) % C, buf.ptr))
    buf.size.copy_(torch.where(valid, torch.clamp(buf.size + B, max=C),
                               buf.size))
    return buf


def draw_indices(buf: FlatReplay, batch_size: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """`batch_size` uniform rows in [0, max(size, 1)), on the device."""
    return draw(batch_size, torch.clamp(buf.size.long(), min=1), generator)


def sample(buf: FlatReplay, batch_size: int,
           generator: torch.Generator | None = None,
           idx: torch.Tensor | None = None):
    """Uniform sample (rows `idx` when given). Returns ((obs, action,
    target_action, reward, next_obs, done as float32), idx)."""
    if idx is None:
        idx = draw_indices(buf, batch_size, generator)
    return (buf.obs[idx], buf.action[idx], buf.target_action[idx],
            buf.reward[idx], buf.next_obs[idx],
            buf.done[idx].to(torch.float32)), idx


@torch.no_grad()
def update_target_action(buf: FlatReplay, idx, new_action) -> FlatReplay:
    """target_action[idx] = new_action in place. Rows sampled twice carry
    equal new actions (the action gradient is per row and Adam
    elementwise), so which duplicate lands last does not matter."""
    buf.target_action.index_put_((idx,), new_action)
    return buf
