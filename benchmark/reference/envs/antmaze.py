"""AntMaze, batched on torch tensors: every maze of `physics/maze.py`
(antmaze-v1, v2, v2-hard, v3, v4, v5).

Counterpart of `ddiffpg_tpu/envs/antmaze.py` (`_init_state`, `reset`,
`step_batched`). Semantics as there:
  * obs = qpos[:15] ++ qvel[:14] (29-D), with non-finite entries zeroed
  * sparse reward: the reward of the first goal within 0.5 m (10; v2's
    first goal 20), info["success"] its 1-based id (dense: -distance to
    the nearest goal)
  * an episode ends on reaching a goal, at `max_episode_steps`
    (`maze.EPISODE_LEN`: 700 for v3 and v4, else 500; reported as
    `time_outs`), or on a broken state (non-finite, escaped,
    below the floor or over the wall top); finished envs auto-reset in the
    same call, and the call still returns the true terminal obs
  * random_init: torso xy ~ U(-2, 2) at every (re)set
  * control dt 0.1 s = 10 substeps of 0.01 s

Physics, by `use_pallas` (the JAX keyword and values): with "auto" (the
default) or True, every control step on a CUDA device is one launch of
the CUDA substep kernel (`physics/substep_cuda.py`), for any batch size,
and on the CPU its plain PyTorch version (`physics/substep.py`); both test
the maze's wall AABBs, like the Pallas kernel every archived TPU run
trained on. The wall count is a compile-time size of the kernel and the
walls' coordinates go into its model block, so each maze has its own
build (v4 and v5, both 29 walls, too). With False the env steps
`physics/engine_cl.py`, whose walls are the maze's SDF, on whichever
device it lives (on a card through a CUDA graph a batch size), as the
JAX tools ask for it. JAX's "auto" on the CPU is `engine_cl`; the port's
is the kernel's plain version. The env is built on the card unless the
caller passes `device="cpu"`, and the choice follows the device of the
state tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.envs.base import EnvState, physics_of, step_physics
from benchmark.reference.physics import ant as ant_model
from benchmark.reference.physics import maze
from benchmark.reference.physics.substep import SubstepConstants


class AntMazeEnv:
    def __init__(self, name: str = "antmaze-v1", reward_type: str = "sparse",
                 random_init: bool = False, maze_size_scaling: float = 4.0,
                 dt: float = 0.01, n_substeps: int = 10,
                 use_pallas: str | bool = "auto",
                 device: str | torch.device = "cuda", seed: int = 0):
        self.name = name
        self.maze_map = maze.MAZES[name]
        self.boxes = maze.compile_boxes(self.maze_map, maze_size_scaling)
        sdf = maze.compile_sdf(self.maze_map, maze_size_scaling)
        self.model = ant_model.build_ant(static_boxes=self.boxes, dt=dt,
                                         n_substeps=n_substeps, **sdf)
        self.consts = SubstepConstants.from_model(self.model)
        self.device = torch.device(device)
        goals = maze.GOALS[name]
        self.goal_xy = torch.tensor([g[0] for g in goals], dtype=torch.float32,
                                    device=self.device)          # [G, 2]
        self.num_goals = len(goals)
        self.goal_reward = torch.tensor([g[1] for g in goals],
                                        dtype=torch.float32,
                                        device=self.device)      # [G]
        self.max_episode_steps = maze.EPISODE_LEN.get(name, 500)
        self.random_init = random_init
        self.reward_type = reward_type
        self.obs_dim = 29
        self.action_dim = 8
        self.maze_size_scaling = maze_size_scaling
        self.init_qpos = torch.tensor(np.asarray(self.model.init_qpos),
                                      dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.kernel, self.engine = physics_of(self.model, self.consts,
                                              self.device, use_pallas)

    # -- physics --------------------------------------------------------------

    def _physics(self, qpos, qvel, ctrl):
        return step_physics(self, qpos, qvel, ctrl.contiguous())

    # -- batched API ------------------------------------------------------------

    def _obs(self, qpos, qvel):
        return torch.cat([qpos[:, :15], qvel[:, :14]], dim=-1)

    def _init_state(self, B: int, xy: torch.Tensor | None = None) -> EnvState:
        """Fresh states; with random_init the torso xy is `xy` [B, 2] when
        given (tests feed the JAX package's draws), else U(-2, 2)."""
        qpos = self.init_qpos.expand(B, -1).clone()
        if self.random_init:
            if xy is None:
                xy = torch.rand((B, 2), generator=self.generator,
                                device=self.device) * 4.0 - 2.0
            qpos[:, :2] = xy
        elif xy is not None:
            raise ValueError("xy given but random_init is off")
        qvel = torch.zeros((B, self.model.nv), dtype=torch.float32,
                           device=self.device)
        t = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return EnvState(qpos=qpos, qvel=qvel, t=t)

    def reset_batched(self, B: int, xy: torch.Tensor | None = None):
        state = self._init_state(B, xy)
        return state, self._obs(state.qpos, state.qvel)

    def step_batched(self, state: EnvState, action: torch.Tensor,
                     reset_xy: torch.Tensor | None = None):
        qpos, qvel = self._physics(state.qpos, state.qvel, action)
        d = torch.linalg.vector_norm(
            qpos[:, None, :2] - self.goal_xy[None], dim=-1)     # [B, G]
        hit = d <= 0.5
        reached = hit.any(dim=-1)
        first = torch.argmax(hit.to(torch.int32), dim=-1)     # first hit
        goal_id = torch.where(reached, first + 1, 0).to(torch.int32)
        if self.reward_type == "dense":
            reward = -d.min(dim=-1).values
        else:
            reward = torch.where(reached, self.goal_reward[first], 0.0)

        t = state.t + 1
        truncated = t >= self.max_episode_steps
        bad = (~(torch.isfinite(qpos).all(dim=-1)
                 & torch.isfinite(qvel).all(dim=-1))
               | (qpos[:, :2].abs() > 60.0).any(dim=-1)
               | (qpos[:, 2] < -0.5) | (qpos[:, 2] > 2.0))
        done = reached | truncated | bad
        obs = torch.nan_to_num(self._obs(qpos, qvel), nan=0.0, posinf=0.0,
                               neginf=0.0)

        reset = self._init_state(qpos.shape[0], reset_xy)
        m = done[:, None]
        new_state = EnvState(qpos=torch.where(m, reset.qpos, qpos),
                             qvel=torch.where(m, reset.qvel, qvel),
                             t=torch.where(done, reset.t, t))
        info = {"success": goal_id, "time_outs": truncated & ~reached}
        return new_state, obs, reward, done, info
