"""The bound of the Panda `ee` control's IK, from a count over the frozen
plain reference.

The count is the operations, per env, of the `ee` branch of the frozen
`PandaTaskEnv._ctrl_from_action` (`benchmark/reference/envs/panda.py`),
the work the program's span `ik` encloses: the FK of qpos
(`Arm.kin.fk`), the end effector's position (`Arm.ee_position`), the
target (the displacement x 0.05 added, its z clamped at 0) and
`Arm.dls_ik`'s three iterations (FK, the Jacobian, the damped 3x3 system
solved in closed form, the clipped joint step). It counts, on tensors of
B rows:
  elementwise ops  as `substep_bound.RowOpCounter` counts them (an op
                   whose output has k B elements counts k; a sqrt, sin,
                   cos or division counts one); the 3x7 product J^T x is
                   an elementwise multiply and a sum, counted so
  cross products   3 an element of the output (two multiplies, a
                   subtract)
  sums             n - 1 adds for each output summed over n elements
  matrix products  2 n m k (n m k multiply-adds) for [n, k] @ [k, m]: the
                   3x3 J J^T, 63 multiply-adds an env an iteration
Index, copy, concatenation and view ops count nothing, nor ops on the
constants (no B rows). The count does not depend on the state (the code
has no branch on it), so it is counted once on a fixed seeded batch and
written into the configuration's file (`ik.ops_per_env`); a CPU test
counts it again. The bound of one control step over B envs is the larger
of those operations at the float32 peak and the bytes that must move
(qpos read once, the 7 arm targets written once) at the HBM rate.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness.peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES
from benchmark.harness.substep_bound import ROW_OPS

N_TARGETS = 7


class IKOpCounter(TorchDispatchMode):
    """The count of the module's docstring, in `ops`."""

    def __init__(self, B: int):
        super().__init__()
        self.B = B
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if not isinstance(out, torch.Tensor) or out.numel() % self.B:
            return out
        per_row = out.numel() // self.B
        if name in ROW_OPS:
            self.ops += per_row
        elif name == "linalg_cross":
            self.ops += 3 * per_row
        elif name == "sum":
            self.ops += args[0].numel() // self.B - per_row
        elif name == "bmm":
            self.ops += 2 * per_row * args[0].shape[-1]
        return out


def count_ik_ops(env, B: int = 64, seed: int = 0) -> int:
    """The count on a reference env's `ee` branch (a batch of B states
    near its initial state and B actions in [-1, 1], seeded)."""
    arm = env.arm
    st = env._init_state(B)
    g = torch.Generator().manual_seed(seed)
    qpos = st.qpos + 0.05 * torch.randn(st.qpos.shape, generator=g)
    action = torch.rand((B, env.action_dim), generator=g) * 2.0 - 1.0
    counter = IKOpCounter(B)
    with counter:
        # `_ctrl_from_action`'s `ee` branch, call for call
        body_pos, body_quat = arm.kin.fk(qpos)
        p_ee = arm.ee_position(body_pos, body_quat)
        target_p = p_ee + action[:, :3] * 0.05
        target_p = torch.cat([target_p[:, :2],
                              torch.clamp_min(target_p[:, 2:], 0.0)], -1)
        arm.dls_ik(qpos, target_p)
    return counter.ops


def bound_ms(ik: dict, B: int):
    """(bound ms of one control step's IK over B envs, "operations" or
    "bytes")."""
    t_ops = ik["ops_per_env"] * B / PEAK_FP32_FLOPS
    t_bytes = 4 * B * (ik["nq"] + N_TARGETS) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")

