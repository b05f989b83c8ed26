"""2-D point-mass maze, batched on torch tensors: the fast debug env.

Counterpart of `ddiffpg_tpu/envs/pointmass.py:PointMazeEnv`, which is one
env vmapped by `VecEnv`; here the batch is written out
(`reset_batched`, `step_batched`, as the other envs of the port).
Semantics as there:
  * obs = [xy, velocity] (4-D); action = a 2-D force, clipped to [-1, 1]
  * vel = clip(0.95 vel + action * dt * 10, +-4), pos += vel * dt (dt 0.1)
  * walls: the maze's wall AABBs (the antmaze of the same version, cells
    of 4 m); a disc of radius 0.4 is pushed out of every box it overlaps,
    the pushes summed, and the velocity's normal part removed where it
    points into a hit box; two such passes over all boxes in order
  * a goal is reached within 0.5 m; the first goal hit gives the id and
    the reward (`physics/maze.py:GOALS`); dense: that reward minus 0.05
    times the distance to the nearest goal
  * an episode ends on a goal or at `max_episode_steps` (100, reported as
    `time_outs`); finished envs auto-reset in the same call, which still
    returns the true terminal obs; resets draw xy ~ U(-1, 1)

Plain PyTorch: no kernel, as the JAX env is plain XLA. Built on the card
unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ddiffpg_tpu_torch.envs.base import EnvState
from ddiffpg_tpu_torch.physics import maze


class PointMazeEnv:
    def __init__(self, name: str = "pointmaze-v1",
                 max_episode_steps: int = 100, dt: float = 0.1,
                 size_scaling: float = 4.0, reward_type: str = "sparse",
                 device: str | torch.device = "cuda", seed: int = 0):
        self.name = name
        self.reward_type = reward_type
        maze_name = name.replace("pointmaze", "antmaze")
        self.maze_map = maze.MAZES[maze_name]
        self.boxes = maze.compile_boxes(self.maze_map, size_scaling)
        self.device = torch.device(device)

        def const(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.box_min = const(self.boxes[:, 0, :2])              # [K, 2]
        self.box_max = const(self.boxes[:, 1, :2])
        goals = maze.GOALS[maze_name]
        self.goal_xy = const([g[0] for g in goals])             # [G, 2]
        self.goal_reward = const([g[1] for g in goals])         # [G]
        self.max_episode_steps = max_episode_steps
        self.dt = dt
        self.obs_dim = 4
        self.action_dim = 2
        self.radius = 0.4
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _init_state(self, B: int, xy: torch.Tensor | None = None
                    ) -> EnvState:
        """Fresh states at `xy` [B, 2] when given (tests feed the JAX
        package's draws), else at xy ~ U(-1, 1)."""
        if xy is None:
            xy = torch.rand((B, 2), generator=self.generator,
                            device=self.device) * 2.0 - 1.0
        return EnvState(qpos=xy.to(torch.float32).clone(),
                        qvel=torch.zeros((B, 2), device=self.device),
                        t=torch.zeros((B,), dtype=torch.int32,
                                      device=self.device))

    def reset_batched(self, B: int, xy: torch.Tensor | None = None):
        state = self._init_state(B, xy)
        return state, torch.cat([state.qpos, state.qvel], dim=-1)

    def _collide(self, pos, vel):
        """Push each disc out of the wall boxes and zero the normal
        velocity into them: two passes over all boxes."""
        for _ in range(2):
            clamped = torch.clamp(pos[:, None], self.box_min, self.box_max)
            delta = pos[:, None] - clamped                       # [B, K, 2]
            d = torch.linalg.vector_norm(delta, dim=-1)
            pen = torch.clamp_min(self.radius - d, 0.0)
            n = delta / torch.where(d > 1e-6, d, 1.0)[..., None]
            pos = pos + (pen[..., None] * n).sum(1)
            hit = pen > 0
            vn = (vel[:, None] * n).sum(-1)
            vel = vel - (torch.where(hit & (vn < 0), vn, 0.0)[..., None]
                         * n).sum(1)
        return pos, vel

    def step_batched(self, state: EnvState, action: torch.Tensor,
                     reset_xy: torch.Tensor | None = None):
        action = torch.clamp(action, -1.0, 1.0)
        vel = 0.95 * state.qvel + action * self.dt * 10.0
        vel = torch.clamp(vel, -4.0, 4.0)
        pos = state.qpos + vel * self.dt
        pos, vel = self._collide(pos, vel)

        d = torch.linalg.vector_norm(pos[:, None] - self.goal_xy[None],
                                     dim=-1)                     # [B, G]
        hit = d <= 0.5
        reached = hit.any(dim=-1)
        first = torch.argmax(hit.to(torch.int32), dim=-1)     # first hit
        goal_id = torch.where(reached, first + 1, 0).to(torch.int32)
        reward = torch.where(reached, self.goal_reward[first], 0.0)
        if self.reward_type == "dense":
            reward = reward - 0.05 * d.min(dim=-1).values

        t = state.t + 1
        truncated = t >= self.max_episode_steps
        done = reached | truncated
        obs = torch.cat([pos, vel], dim=-1)

        reset = self._init_state(pos.shape[0], reset_xy)
        m = done[:, None]
        new_state = EnvState(qpos=torch.where(m, reset.qpos, pos),
                             qvel=torch.where(m, reset.qvel, vel),
                             t=torch.where(done, reset.t, t))
        info = {"success": goal_id, "time_outs": truncated & ~reached}
        return new_state, obs, reward, done, info
