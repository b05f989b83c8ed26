"""The port's Panda env (joint control) against the JAX package's
`step_batched`, plus the goal probe, truncation and the registry's Panda
names; `ee` control is held to JAX in tests/test_torch_envs_all.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.envs.base import EnvState as JaxState  # noqa: E402
from ddiffpg_tpu.envs.panda import PandaTaskEnv as JaxPanda  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.envs.base import EnvState  # noqa: E402
from ddiffpg_tpu_torch.envs.panda import PandaTaskEnv  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

B = 8


def _jax_reset_noise(keys):
    """The arm noise the JAX env draws for its auto-resets from these
    per-env keys (`step_batched` -> `_init_state`)."""
    k = jax.vmap(jax.random.split)(keys)[:, 0]
    k_noise = jax.vmap(jax.random.split)(k)[:, 0]
    return np.asarray(jax.vmap(lambda kk: jax.random.uniform(
        kk, (7,), minval=-0.1, maxval=0.1))(k_noise))


@pytest.mark.parametrize("task,reward_type,random_init", [
    ("Reach", "dense", True), ("DrawerMulti", "sparse", False)])
def test_step_batched_parity(task, reward_type, random_init):
    """Two control steps at B=8 against the JAX CPU path (engine_cl),
    JAX's reset draws fed in. DrawerMulti's env 0 starts with drawer 0 at
    0.031, next to the goal, and env 1 at 0.02, inside it (success, reward
    10, auto-reset); env 2 is at its last step. The physics is 20 substeps
    in engine_cl's order against the Pallas order, and the arm's stiff
    servos make small differences grow fast (see
    test_servo_chatter_amplifies_small_changes). So the ee position, task
    joints and dense reward get 1e-4, qpos 1e-3, and the velocities (qvel,
    ee velocity) 5e-2; reward, done, success id and time-outs are exact."""
    jenv = JaxPanda(task, reward_type=reward_type,
                    random_init_pos=random_init, use_pallas=False)
    env = PandaTaskEnv(task, reward_type=reward_type,
                       random_init_pos=random_init, device="cpu")
    m, meta = env.model, env.meta
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (B, 7))
    if task == "DrawerMulti":
        qpos[0, meta["task_qposadr"][0]] = 0.031
        qpos[1, meta["task_qposadr"][2]] = 0.02
    t = rng.randint(0, 90, B).astype(np.int32)
    t[2] = 99
    jstate = JaxState(jnp.asarray(qpos), jnp.zeros((B, m.nv)),
                      jnp.asarray(t),
                      jax.random.split(jax.random.PRNGKey(0), B))
    state = EnvState(torch.tensor(qpos), torch.zeros(B, m.nv),
                     torch.tensor(t))
    dones = []
    jstep = jax.jit(jenv.step_batched)      # one compile for both steps
    for step in range(2):
        act = rng.uniform(-1, 1, (B, env.action_dim)).astype(np.float32)
        noise = (torch.tensor(_jax_reset_noise(jstate.key)) if random_init
                 else None)
        jstate, jobs, jrew, jdone, jinfo = jstep(jstate, jnp.asarray(act))
        state, obs, rew, done, info = env.step_batched(
            state, torch.tensor(act), reset_xy=noise)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(info["success"].numpy(),
                                      np.asarray(jinfo["success"]))
        np.testing.assert_array_equal(info["time_outs"].numpy(),
                                      np.asarray(jinfo["time_outs"]))
        if reward_type == "dense":
            np.testing.assert_allclose(rew.numpy(), np.asarray(jrew),
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        jobs = np.asarray(jobs)
        np.testing.assert_allclose(obs[:, :3].numpy(), jobs[:, :3],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(obs[:, 3:6].numpy(), jobs[:, 3:6],
                                   atol=5e-2, rtol=0)
        np.testing.assert_allclose(obs[:, 6:].numpy(), jobs[:, 6:],
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        np.testing.assert_allclose(state.qpos.numpy(),
                                   np.asarray(jstate.qpos), atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(state.qvel.numpy(),
                                   np.asarray(jstate.qvel), atol=5e-2,
                                   rtol=0)
        dones.append(done)
    assert bool(dones[0][2])                       # truncated at 100 steps
    if task == "DrawerMulti":
        assert dones[0][:2].tolist() == [False, True]
        assert float(rew.abs().max()) <= 10.0


def test_servo_chatter_amplifies_small_changes():
    """Why the Panda comparisons over whole control steps have wide
    velocity tolerances: the force-limited kp = 2e4, kd = 300 arm servos
    at dt = 0.002 make the motion chaotic. In the port alone, moving the
    start joint angles by 1e-6 rad moves the ee velocity by more than 1e-2
    two control steps later."""
    env = PandaTaskEnv("DrawerMulti", device="cpu")
    m, meta = env.model, env.meta
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (16, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (16, 7))
    acts = [torch.tensor(rng.uniform(-1, 1, (16, 8)).astype(np.float32))
            for _ in range(2)]

    def ee_velocity(q):
        state = EnvState(torch.tensor(q), torch.zeros(16, m.nv),
                         torch.zeros(16, dtype=torch.int32))
        for act in acts:
            state, obs, _, _, _ = env.step_batched(state, act)
        return obs[:, 3:6]

    nudged = qpos.copy()
    nudged[:, meta["arm_qposadr"]] += 1e-6
    assert float((ee_velocity(qpos) - ee_velocity(nudged)).abs().max()) \
        > 1e-2


def test_goal_probe_drawer():
    env = make("PandaDrawerMultiJoints-v3", num_envs=4, device="cpu")
    state, obs = env.reset()
    qpos = state.qpos.clone()
    qpos[0, int(env.env.task_adr[0])] = 0.0
    state, obs, rew, done, info = env.step(state._replace(qpos=qpos),
                                           torch.zeros(4, 8))
    assert float(rew[0]) == 10.0 and bool(done[0])
    assert int(info["success"][0]) == 1 and int(state.t[0]) == 0
    assert not bool(info["time_outs"][0])
    assert float(obs[0, 7]) < 0.03                 # the true terminal obs
    assert torch.equal(state.qpos[0], env.env.init_qpos)      # reset
    assert not done[1:].any() and (state.t[1:] == 1).all()
    assert float(rew[1:].abs().sum()) == 0.0


def test_truncation_at_100_steps():
    env = make("PandaReachJoints-v3", num_envs=3, device="cpu")
    state, _ = env.reset()
    state = state._replace(t=torch.tensor([99, 98, 0], dtype=torch.int32))
    state, _, rew, done, info = env.step(state, torch.zeros(3, 7))
    assert done.tolist() == [True, False, False]
    assert info["time_outs"].tolist() == [True, False, False]
    assert state.t.tolist() == [0, 99, 1]


@pytest.mark.parametrize("name,obs_dim,action_dim,reward,random_init", [
    ("PandaDrawerMultiJoints-v3", 11, 8, "sparse", False),
    ("PandaReachJointsDenseRandom-v3", 6, 7, "dense", True),
    ("PandaPegInsertionJoints-v3", 7, 8, "sparse", False),
    ("PandaCabinetJointsDense-v3", 8, 8, "dense", False)])
def test_registry_parses_panda_names(name, obs_dim, action_dim, reward,
                                     random_init):
    env = make(name, num_envs=2, device="cpu")
    assert (env.obs_dim, env.action_dim) == (obs_dim, action_dim)
    assert env.env.reward_type == reward
    assert env.env.random_init_pos == random_init
    assert env.max_episode_length == 100
    state, obs = env.reset()
    assert obs.shape == (2, obs_dim) and bool(torch.isfinite(obs).all())
