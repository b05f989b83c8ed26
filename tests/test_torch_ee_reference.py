"""The port's collect on PandaDrawerMulti-v3 (the `ee` control: FK, a
target and three DLS IK steps before the physics) held to the benchmark's
frozen plain reference (`benchmark/reference/`) on the CPU: 4 envs, 2
control steps, the stock-width diffusion actor with seeded random
weights. The reference computes each step's actions from the obs the
port's actor saw, with the same generator seed, and steps its own env
from the same start state with the port's actions.

Tolerances: actions exact (the same plain float32 ops on the same inputs
in both); obs within 1e-6 of 1 + |o| (the frozen copy issues the port's
ops, so they agree to the last bit today; the room is for a reordered
sum in either, far below what a lost IK iteration moves, ~0.05); reward,
done and success exact (flags). The plain substep is most of a CPU
step's time, so both envs step two substeps of 0.002 s a control step
instead of 20: in the first the arm's servo torques sit at their limits
whatever the targets (kp 20000), from the second on the IK's targets show
in the obs. One intra-op thread.
"""

import pytest

torch = pytest.importorskip("torch")

from benchmark.reference.agents import ddiffpg as RD  # noqa: E402
from benchmark.reference.envs import base as R_base  # noqa: E402
from benchmark.reference.envs import panda as R_panda  # noqa: E402
from benchmark.reference.models.diffusion import (  # noqa: E402
    DiffusionPolicy as RefPolicy)
from ddiffpg_tpu_torch.agents.ddiffpg import collect  # noqa: E402
from ddiffpg_tpu_torch.envs import base as env_base  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

NAME, B, T, K, EMB = "PandaDrawerMulti-v3", 4, 2, 5, 5
P_EXPLOIT, STD_MIN, STD_MAX = 0.5, 0.05, 0.6


def _two_substeps(substep):
    return lambda consts, qpos, qvel, ctrl: substep(consts, qpos, qvel, ctrl,
                                                    n_substeps=2)


def test_ee_collect_matches_the_frozen_reference(monkeypatch):
    monkeypatch.setattr(env_base, "substep_reference",
                        _two_substeps(env_base.substep_reference))
    monkeypatch.setattr(R_base, "substep_reference",
                        _two_substeps(R_base.substep_reference))
    env = make(NAME, num_envs=B, device="cpu", seed=3)
    assert env.env.control_type == "ee" and env.action_dim == 4
    policy = DiffusionPolicy(env.action_dim, env.obs_dim + EMB, K,
                             device="cpu",
                             generator=torch.Generator().manual_seed(7))
    emb = torch.randn(3, EMB, generator=torch.Generator().manual_seed(8))
    modes = torch.tensor(2)
    state, obs = env.reset()
    # staggered episode clocks: envs 0 and 1 truncate inside the 2 steps
    state = state._replace(t=torch.tensor([98, 99, 5, 0], dtype=torch.int32))
    env.env.generator.manual_seed(11)
    _, _, roll = collect(env, policy, state, obs, T, P_EXPLOIT, emb, modes,
                         STD_MIN, STD_MAX,
                         generator=torch.Generator().manual_seed(12))
    assert bool(roll.done[:, :2].any())

    ref_env = R_base.VecEnv(R_panda.make_panda_env(NAME, device="cpu",
                                                   seed=3), B)
    assert ref_env.env.control_type == "ee"
    ref_policy = RefPolicy(env.action_dim, env.obs_dim + EMB, K,
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
    ref_policy.load_state_dict(policy.state_dict())
    gen = torch.Generator().manual_seed(12)
    ref_env.env.generator.manual_seed(11)
    s = R_base.EnvState(*state)
    for k in range(T):
        seen = obs if k == 0 else roll.obs[k - 1]
        with torch.no_grad():
            a = RD.explore_actions(ref_policy, seen, P_EXPLOIT, emb, modes,
                                   STD_MIN, STD_MAX, generator=gen)
        assert torch.equal(a, roll.action[k]), k
        s, o, r, d, info = ref_env.step(s, roll.action[k])
        gap = ((o - roll.obs[k]).abs() / (1.0 + o.abs())).max()
        assert float(gap) <= 1e-6, (k, float(gap))
        assert torch.equal(r, roll.reward[k]), k
        assert torch.equal(d, roll.done[k]), k
        assert torch.equal(info["success"], roll.success[k]), k
