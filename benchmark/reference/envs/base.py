"""Env state and the batched env wrapper.

Counterpart of `ddiffpg_tpu/envs/base.py`. The JAX `EnvState` carries a
PRNG key per env for auto-reset draws; here the env draws its resets from a
`torch.Generator` on its device, so the state is (qpos, qvel, t).
`Transition` is the JAX package's record of a step's outputs.
`pallas_step_padded` has no counterpart: the CUDA kernel masks its own
tail, so eval batches (20 envs) and training batches (256 or 4096)
integrate through the same kernel unpadded. `physics_of` and
`step_physics` pick and step an env's physics by the JAX keyword
`use_pallas`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from benchmark.reference.physics.substep import substep_reference


class EnvState(NamedTuple):
    qpos: torch.Tensor      # [B, nq] float32
    qvel: torch.Tensor      # [B, nv] float32
    t: torch.Tensor         # [B] int32 step count within the episode


class Transition(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor      # terminated | truncated (after auto-reset)
    info: Dict[str, torch.Tensor]  # 'success' (int32), 'time_outs' (bool)


class VecEnv:
    """A batch of `num_envs` envs of one kind, stepped together.

    `step` auto-resets finished envs while still returning the true
    terminal observation of the finished transition.

    `xy` / `reset_xy` is the env's random reset draw for the whole batch,
    given instead of drawn from the env's generator (tests feed the JAX
    package's draws): the ant's torso xy [B, 2], or the Panda arm's joint
    noise [B, 7].
    """

    def __init__(self, env, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    @property
    def obs_dim(self):
        return self.env.obs_dim

    @property
    def action_dim(self):
        return self.env.action_dim

    @property
    def max_episode_length(self):
        return self.env.max_episode_steps

    def reset(self, xy: torch.Tensor | None = None):
        return self.env.reset_batched(self.num_envs, xy=xy)

    def step(self, state: EnvState, action: torch.Tensor,
             reset_xy: torch.Tensor | None = None):
        return self.env.step_batched(state, action, reset_xy=reset_xy)


def physics_of(model, consts, device: torch.device, use_pallas):
    """The reference steps the plain substep on every device: (None,
    None)."""
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"an env on {device}")
    return None, None


def step_physics(env, qpos, qvel, ctrl):
    """One control step of `env`'s physics: the plain substep."""
    return substep_reference(env.consts, qpos, qvel, ctrl)
