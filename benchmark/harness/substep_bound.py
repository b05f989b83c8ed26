"""The substep kernel's bound, from a count over the frozen plain substep.

The count is the elementwise operations the plain substep
(`benchmark/reference/physics/substep.py`) issues on tensors of B rows for
one substep, per env (an op whose output has k B elements counts k; a
sqrt, sin, cos or division counts one). It does not depend on the state,
so it is counted once on a fixed seeded batch and written into each
configuration's file (`substep.row_ops_per_env_substep`); a CPU test
counts it again. The bound of one launch over B envs is the larger of
those operations for `n_substeps` substeps at the float32 peak and the
bytes that must move (qpos, qvel, ctrl read once; qpos, qvel written
once) at the HBM rate.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness.peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES

ROW_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin",
           "cos", "clamp", "clamp_min", "clamp_max", "maximum", "minimum",
           "where", "gt", "lt", "ge", "le", "eq", "ne", "bitwise_and",
           "bitwise_or", "bitwise_not", "logical_and", "logical_or",
           "logical_not"}


class RowOpCounter(TorchDispatchMode):
    def __init__(self, B: int):
        super().__init__()
        self.B = B
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if (name in ROW_OPS and isinstance(out, torch.Tensor)
                and out.numel() % self.B == 0):
            self.ops += out.numel() // self.B
        return out


def count_row_ops(env, B: int = 64, seed: int = 0) -> int:
    """The count on a reference env's plain substep (a batch of B states
    near its initial state, seeded)."""
    from benchmark.reference.physics.substep import substep_reference

    c = env.consts
    st = env._init_state(B)
    g = torch.Generator().manual_seed(seed)
    qpos = st.qpos + 0.05 * torch.randn(st.qpos.shape, generator=g)
    qvel = torch.randn(st.qvel.shape, generator=g)
    ctrl = torch.rand((B, c.nu), generator=g) * 2.0 - 1.0
    counter = RowOpCounter(B)
    with counter:
        substep_reference(c, qpos, qvel, ctrl, n_substeps=1)
    return counter.ops


def bound_ms(sub: dict, B: int):
    """(bound ms of one launch over B envs, "operations" or "bytes")."""
    t_ops = sub["row_ops_per_env_substep"] * sub["n_substeps"] * B \
        / PEAK_FP32_FLOPS
    t_bytes = 4 * B * (2 * sub["nq"] + 2 * sub["nv"] + sub["nu"]) \
        / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")
