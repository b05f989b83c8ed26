"""Panda manipulation, batched on torch tensors: Reach, PegInsertion,
DrawerMulti, Cabinet.

Counterpart of `ddiffpg_tpu/envs/panda.py` (`PandaTaskEnv`'s batched path:
`_ee_state`, `_obs_from`, `_init_state`, `_success_reward`,
`_ctrl_from_action`, `step_batched`, and `make_panda_env`). Semantics as
there:
  * obs = [ee pos (3), ee vel (3)] (+ fingers' width when the gripper is
    free) ++ task obs (drawer joints / cabinet joint)
  * actions in [-1, 1]: `control_type="joints"`: delta q * 0.05 as the arm
    servos' position targets; `"ee"`: an end-effector displacement * 0.05
    (its z kept >= 0) turned into arm targets by three steps of DLS IK
    (`physics/panda.py:Arm.dls_ik`); either way clamped to the joint
    limits. The last dim drives the finger width (+-0.2 max) unless the
    gripper is blocked (Reach)
  * sparse reward 10 at success, else 0 (dense: -distance); an episode ends
    on success or at `max_episode_steps` (100, reported as `time_outs`);
    finished envs auto-reset in the same call, which still returns the
    true terminal obs. There is no bad-state reset and no `nan_to_num`.
  * random_init_pos: arm joints + U(-0.1, 0.1) at every (re)set
  * control dt 0.04 s = 20 substeps of 0.002 s

Physics, by `use_pallas` (the JAX keyword and values): with "auto" (the
default) or True, every control step on a CUDA device is one launch of
the CUDA substep kernel (`physics/substep_cuda.py`), for any batch size,
and on the CPU its plain PyTorch version (`physics/substep.py`); with
False the env steps `physics/engine_cl.py` on whichever device it lives
(on a card through a CUDA graph a batch size). The env is built on the
card unless the caller passes `device="cpu"`. The observation's ee state
follows the physics: through the substep kernel, one launch of its
ee-state entry (`SubstepKernel.ee_state`); otherwise, and for the `ee`
control's FK and IK, the kinematics of `physics/panda.py:Arm`, which read
index and constant tensors the env builds once.
"""

from __future__ import annotations

import numpy as np
import torch

from ddiffpg_tpu_torch.envs.base import EnvState, physics_of, step_physics
from ddiffpg_tpu_torch.physics import panda as P
from ddiffpg_tpu_torch.physics.substep import SubstepConstants
from ddiffpg_tpu_torch.utils import trace


class PandaTaskEnv:
    def __init__(self, task: str = "Reach", reward_type: str = "sparse",
                 control_type: str = "joints", random_init_pos: bool = False,
                 max_episode_steps: int = 100,
                 use_pallas: str | bool = "auto",
                 device: str | torch.device = "cuda", seed: int = 0):
        if control_type not in ("joints", "ee"):
            raise ValueError(f"control_type={control_type!r}: 'joints' or "
                             "'ee'")
        self.task = task
        self.control_type = control_type
        self.reward_type = reward_type
        self.random_init_pos = random_init_pos
        self.max_episode_steps = max_episode_steps
        self.model, self.meta = P.build_panda_scene(task)
        self.consts = SubstepConstants.from_model(self.model)
        self.block_gripper = task == "Reach"
        self.device = torch.device(device)
        n_task_obs = {"Reach": 0, "PegInsertion": 0, "DrawerMulti": 4,
                      "Cabinet": 1}[task]
        self.obs_dim = 6 + (0 if self.block_gripper else 1) + n_task_obs
        self.action_dim = ((3 if control_type == "ee" else 7)
                           + (0 if self.block_gripper else 1))

        def const(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        # 1-based goal ids of info["success"], for the eval's per-goal rates
        self.num_goals = {"Reach": 1,
                          "PegInsertion": len(self.meta.get("goals", [0])),
                          "DrawerMulti": len(self.meta["task_qposadr"]),
                          "Cabinet": 1}[task]
        self.arm = P.Arm(self.model, self.meta, self.device)
        self.init_qpos = const(self.model.init_qpos)
        self.arm_adr = self.arm.arm_qposadr
        self.finger_adr = const(self.meta["finger_qposadr"], torch.long)
        self.task_adr = const(self.meta["task_qposadr"], torch.long)
        self.q_lo = const(np.asarray(P.JOINT_LIMIT_LO, np.float32))
        self.q_hi = const(np.asarray(P.JOINT_LIMIT_HI, np.float32))
        if task == "Reach":
            self.goal = const(np.asarray(self.meta["goal"], np.float32))
        elif task == "PegInsertion":
            self.goal = const(np.asarray(self.meta["goals"], np.float32))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.kernel, self.engine = physics_of(self.model, self.consts,
                                              self.device, use_pallas)

    # -- physics --------------------------------------------------------------

    def _physics(self, qpos, qvel, ctrl):
        return step_physics(self, qpos, qvel, ctrl)

    # -- obs ------------------------------------------------------------------

    def _ee_state(self, qpos, qvel):
        """End-effector position and velocity [B, 3] each (the span
        `ee_state`): one launch of the substep kernel's ee-state entry
        where the env steps through that kernel, else `Arm.ee_state`."""
        with trace.span("ee_state"):
            if self.kernel is None:
                return self.arm.ee_state(qpos, qvel)
            out = self.kernel.ee_state(qpos, qvel, self.arm.hand,
                                       self.arm.ee_offset_host)
            return out[:, :3], out[:, 3:]

    def _obs_from(self, qpos, p_ee, v_ee):
        parts = [p_ee, v_ee]
        if not self.block_gripper:
            parts.append(qpos[:, self.finger_adr].sum(-1, keepdim=True))
        if self.task in ("DrawerMulti", "Cabinet"):
            parts.append(qpos[:, self.task_adr])
        return torch.cat(parts, dim=-1)

    # -- reset ------------------------------------------------------------------

    def _init_state(self, B: int, noise: torch.Tensor | None = None
                    ) -> EnvState:
        """Fresh states; with random_init_pos the arm joints get `noise`
        [B, 7] when given (tests feed the JAX package's draws), else
        U(-0.1, 0.1)."""
        qpos = self.init_qpos.expand(B, -1).clone()
        if self.random_init_pos:
            if noise is None:
                noise = torch.rand((B, 7), generator=self.generator,
                                   device=self.device) * 0.2 - 0.1
            qpos[:, self.arm_adr] = qpos[:, self.arm_adr] + noise
        elif noise is not None:
            raise ValueError("reset noise given but random_init_pos is off")
        qvel = torch.zeros((B, self.model.nv), dtype=torch.float32,
                           device=self.device)
        t = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return EnvState(qpos=qpos, qvel=qvel, t=t)

    def reset_batched(self, B: int, xy: torch.Tensor | None = None):
        state = self._init_state(B, xy)
        p_ee, v_ee = self._ee_state(state.qpos, state.qvel)
        return state, self._obs_from(state.qpos, p_ee, v_ee)

    # -- goals ------------------------------------------------------------------

    def _success_reward(self, qpos, p_ee):
        """(success [B] bool, goal id [B] int32, reward [B] float32)."""
        if self.task == "Reach":
            d = torch.linalg.vector_norm(p_ee - self.goal, dim=-1)
            succ = d < self.meta["threshold"]
            goal_id = succ.to(torch.int32)
            dense = -d
        elif self.task == "PegInsertion":
            d = torch.linalg.vector_norm(p_ee[:, None] - self.goal, dim=-1)
            succ = (d < self.meta["threshold"]).any(dim=-1)
            goal_id = torch.where(succ, torch.argmin(d, dim=-1) + 1, 0)
            dense = -d.min(dim=-1).values
        elif self.task == "DrawerMulti":
            j = qpos[:, self.task_adr]
            succ = (j <= self.meta["goal"]).any(dim=-1)
            goal_id = torch.where(succ, torch.argmin(j, dim=-1) + 1, 0)
            dense = -j.min(dim=-1).values
        else:   # Cabinet
            j = qpos[:, self.task_adr[0]]
            succ = j >= self.meta["goal"]
            goal_id = succ.to(torch.int32)
            dense = -torch.abs(j - self.meta["goal"])
        if self.reward_type == "dense":
            reward = dense.to(torch.float32)
        else:
            reward = torch.where(succ, 10.0, 0.0)
        return succ, goal_id.to(torch.int32), reward

    # -- stepping -----------------------------------------------------------------

    def _ctrl_from_action(self, qpos, action):
        """action [B, A] in [-1, 1] -> servo targets [B, nu]: 7 arm joints,
        then the 2 fingers."""
        action = torch.clamp(action, -1.0, 1.0)
        if self.control_type == "ee":
            with trace.span("ik"):
                body_pos, body_quat = self.arm.kin.fk(qpos)
                p_ee = self.arm.ee_position(body_pos, body_quat)
                target_p = p_ee + action[:, :3] * 0.05
                target_p = torch.cat(
                    [target_p[:, :2], torch.clamp_min(target_p[:, 2:], 0.0)],
                    -1)
                target_q = self.arm.dls_ik(qpos, target_p)
        else:
            target_q = qpos[:, self.arm_adr] + action[:, :7] * 0.05
        target_q = torch.clamp(target_q, self.q_lo, self.q_hi)
        if self.block_gripper:
            finger_t = torch.full((qpos.shape[0], 2), 0.03 / 2,
                                  device=qpos.device)
        else:
            target_w = qpos[:, self.finger_adr].sum(-1) + action[:, -1] * 0.2
            finger_t = torch.clamp(torch.stack([target_w / 2, target_w / 2],
                                               dim=-1), 0.0, 0.04)
        return torch.cat([target_q, finger_t], dim=-1)

    def step_batched(self, state: EnvState, action: torch.Tensor,
                     reset_xy: torch.Tensor | None = None):
        ctrl = self._ctrl_from_action(state.qpos, action)
        qpos, qvel = self._physics(state.qpos, state.qvel, ctrl)
        p_ee, v_ee = self._ee_state(qpos, qvel)
        succ, goal_id, reward = self._success_reward(qpos, p_ee)

        t = state.t + 1
        truncated = t >= self.max_episode_steps
        done = succ | truncated
        obs = self._obs_from(qpos, p_ee, v_ee)

        reset = self._init_state(qpos.shape[0], reset_xy)
        m = done[:, None]
        new_state = EnvState(qpos=torch.where(m, reset.qpos, qpos),
                             qvel=torch.where(m, reset.qvel, qvel),
                             t=torch.where(done, reset.t, t))
        info = {"success": goal_id, "time_outs": truncated & ~succ}
        return new_state, obs, reward, done, info


def make_panda_env(name: str, **kwargs) -> PandaTaskEnv:
    """Parse reference env ids: Panda{Task}{Joints}{Dense}{Random}-v3."""
    base = name.replace("-v3", "")
    if not base.startswith("Panda"):
        raise ValueError(f"not a Panda env: {name!r}")
    base = base[len("Panda"):]
    random_init = base.endswith("Random")
    if random_init:
        base = base[: -len("Random")]
    dense = base.endswith("Dense")
    if dense:
        base = base[: -len("Dense")]
    joints = base.endswith("Joints")
    if joints:
        base = base[: -len("Joints")]
    kwargs.setdefault("control_type", "joints" if joints else "ee")
    kwargs.setdefault("reward_type", "dense" if dense else "sparse")
    kwargs.setdefault("random_init_pos", random_init)
    return PandaTaskEnv(task=base, **kwargs)
