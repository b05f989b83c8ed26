"""The port's antmaze envs against the JAX package's `step_batched`
(antmaze-v1, then every other maze with its goals and episode length),
plus the goal probe, truncation, broken-state reset and the mazes' wall
counts in the kernel's build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.envs.antmaze import AntMazeEnv as JaxAntMaze  # noqa: E402
from ddiffpg_tpu.envs.base import EnvState as JaxState  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv  # noqa: E402
from ddiffpg_tpu_torch.envs.base import EnvState  # noqa: E402
from ddiffpg_tpu_torch.physics import maze  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

B = 16


def _batch(env, seed=0):
    """Envs inside the start cell (walls out of reach, so the JAX CPU
    path's SDF walls and the port's AABB walls agree), env 0 at the goal,
    env 1 at the last step of its episode, env 2 with a NaN velocity."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(env.model.init_qpos)[None], (B, 1))
    qpos = qpos.astype(np.float32)
    qpos[:, :2] = rng.uniform(-0.8, 0.8, (B, 2))
    qpos[0, :2] = (-7.8, 0.1)
    qvel = rng.uniform(-0.5, 0.5, (B, 14)).astype(np.float32)
    qvel[2, 4] = np.nan
    act = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    t = rng.randint(0, 400, B).astype(np.int32)
    t[1] = 499
    return qpos, qvel, t, act


def _jax_reset_xy(env, keys):
    """The xy the JAX env draws for its auto-resets from these keys."""
    k = jax.vmap(jax.random.split)(keys)[:, 0]
    return np.asarray(jax.vmap(env._init_state)(k).qpos[:, :2])


@pytest.mark.parametrize("reward_type", ["sparse", "dense"])
def test_step_batched_parity(reward_type):
    """obs, reward, done, success, time_outs and the auto-reset state
    against the JAX CPU path (engine_cl), JAX's reset draws fed in.
    Physics float32 in another order: tests/test_engine_cl.py's 2e-5 on
    positions and 2e-4 on velocities (and the dense reward, a distance);
    the rest exact."""
    jenv = JaxAntMaze(random_init=True, reward_type=reward_type)
    env = AntMazeEnv(random_init=True, reward_type=reward_type,
                     device="cpu")
    qpos, qvel, t, act = _batch(jenv)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = JaxState(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(t),
                      keys)
    jnew, jobs, jrew, jdone, jinfo = jenv.step_batched(jstate,
                                                       jnp.asarray(act))
    state = EnvState(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(t))
    new, obs, rew, done, info = env.step_batched(
        state, torch.tensor(act),
        reset_xy=torch.tensor(_jax_reset_xy(jenv, keys)))

    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done[:3].all() and not done[3:].all()
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(info["success"].numpy(),
                                  np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(info["time_outs"].numpy(),
                                  np.asarray(jinfo["time_outs"]))
    jobs = np.asarray(jobs)
    np.testing.assert_allclose(obs[:, :15].numpy(), jobs[:, :15], atol=2e-5)
    np.testing.assert_allclose(obs[:, 15:].numpy(), jobs[:, 15:], atol=2e-4)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_allclose(new.qpos.numpy(), np.asarray(jnew.qpos),
                               atol=2e-5)
    np.testing.assert_allclose(new.qvel.numpy(), np.asarray(jnew.qvel),
                               atol=2e-4)


def test_goal_probe():
    env = make("antmaze-v1", num_envs=4, random_init=True, device="cpu")
    state, _ = env.reset()
    qpos = state.qpos.clone()
    qpos[0, :2] = torch.tensor([-7.8, 0.1])
    state, obs, rew, done, info = env.step(state._replace(qpos=qpos),
                                           torch.zeros(4, 8))
    assert float(rew[0]) == 10.0 and bool(done[0])
    assert int(info["success"][0]) == 1 and int(state.t[0]) == 0
    assert not bool(info["time_outs"][0])
    assert float(obs[0, 0]) < -7.0          # the true terminal obs
    assert float(state.qpos[0, :2].abs().max()) <= 2.0   # reset
    assert not done[1:].any() and (state.t[1:] == 1).all()


def test_truncation_at_500_steps():
    env = make("antmaze-v1", num_envs=3, device="cpu")
    state, _ = env.reset()
    state = state._replace(t=torch.tensor([499, 498, 0], dtype=torch.int32))
    state, _, rew, done, info = env.step(state, torch.zeros(3, 8))
    assert done.tolist() == [True, False, False]
    assert info["time_outs"].tolist() == [True, False, False]
    assert state.t.tolist() == [0, 499, 1]
    assert float(rew.abs().sum()) == 0.0


def test_nan_velocity_resets_with_finite_obs():
    env = make("antmaze-v1", num_envs=2, random_init=True, device="cpu")
    state, _ = env.reset()
    qvel = state.qvel.clone()
    qvel[0, 3] = float("nan")
    xy = torch.tensor([[0.5, -0.25], [1.0, 1.0]])
    state, obs, _, done, info = env.step(state._replace(qvel=qvel),
                                         torch.zeros(2, 8), reset_xy=xy)
    assert bool(done[0]) and not bool(done[1])
    assert bool(torch.isfinite(obs).all())
    assert not bool(info["time_outs"][0])
    assert state.qpos[0, :2].tolist() == [0.5, -0.25]
    assert int(state.t[0]) == 0 and float(state.qvel[0].abs().sum()) == 0.0


def test_reset_draws_start_cell_xy():
    env = make("antmaze-v1", num_envs=256, random_init=True, seed=3,
               device="cpu")
    state, obs = env.reset()
    xy = state.qpos[:, :2]
    assert float(xy.abs().max()) <= 2.0 and float(xy.std()) > 0.5
    assert obs.shape == (256, 29) and state.t.dtype == torch.int32
    assert float(state.qpos[0, 2]) == pytest.approx(0.55)
    assert env.max_episode_length == 500


@pytest.mark.parametrize("name", ["antmaze-v2", "antmaze-v2-hard",
                                  "antmaze-v3", "antmaze-v4", "antmaze-v5"])
def test_other_mazes_step_batched_parity(name):
    """One step of 16 envs of each other maze against the JAX CPU path
    (engine_cl), JAX's reset draws fed in, at test_step_batched_parity's
    bounds (positions 2e-5, velocities 2e-4, the rest exact). Every env
    sits 2 m or more from a wall (the reset cell, and each goal's cell):
    env k < G starts 0.3 m from goal k (its reward, 20 at v2's first
    goal, and id k + 1), env G at the last step of its episode (700 for
    v3 and v4, else 500), the others in the reset cell."""
    jenv = JaxAntMaze(name, random_init=True)
    env = AntMazeEnv(name, random_init=True, device="cpu")
    goals = maze.GOALS[name]
    G = len(goals)
    rng = np.random.RandomState(1)
    qpos = np.tile(np.asarray(env.model.init_qpos)[None], (B, 1))
    qpos = qpos.astype(np.float32)
    qpos[:, :2] = rng.uniform(-0.8, 0.8, (B, 2))
    for k, (xy, _) in enumerate(goals):
        qpos[k, :2] = np.asarray(xy, np.float32) + (0.2, -0.1)
    qvel = rng.uniform(-0.5, 0.5, (B, 14)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    L = maze.EPISODE_LEN.get(name, 500)
    assert env.max_episode_steps == jenv.max_episode_steps == L
    t = rng.randint(0, L - 100, B).astype(np.int32)
    t[G] = L - 1
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jnew, jobs, jrew, jdone, jinfo = jenv.step_batched(
        JaxState(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(t), keys),
        jnp.asarray(act))
    new, obs, rew, done, info = env.step_batched(
        EnvState(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(t)),
        torch.tensor(act), reset_xy=torch.tensor(_jax_reset_xy(jenv, keys)))

    want_rew = [r for _, r in goals] + [0.0] * (B - G)
    assert rew.tolist() == want_rew
    assert info["success"].tolist() == list(range(1, G + 1)) + [0] * (B - G)
    assert done[: G + 1].all() and not done[G + 1:].any()
    assert info["time_outs"].tolist() == [False] * G + [True] + \
        [False] * (B - G - 1)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(info["success"].numpy(),
                                  np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(info["time_outs"].numpy(),
                                  np.asarray(jinfo["time_outs"]))
    jobs = np.asarray(jobs)
    np.testing.assert_allclose(obs[:, :15].numpy(), jobs[:, :15], atol=2e-5)
    np.testing.assert_allclose(obs[:, 15:].numpy(), jobs[:, 15:], atol=2e-4)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_allclose(new.qpos.numpy(), np.asarray(jnew.qpos),
                               atol=2e-5)
    np.testing.assert_allclose(new.qvel.numpy(), np.asarray(jnew.qvel),
                               atol=2e-4)


@pytest.mark.parametrize("name,walls", [
    ("antmaze-v2", 36), ("antmaze-v2-hard", 36), ("antmaze-v3", 41),
    ("antmaze-v4", 29), ("antmaze-v5", 29)])
def test_maze_walls_reach_the_kernel(name, walls):
    """Each maze's wall AABBs are the kernel's static boxes (NSB), and its
    build fits one block's shared memory at 16 lanes an env."""
    from ddiffpg_tpu_torch.physics.substep_cuda import launch_geometry

    env = AntMazeEnv(name, device="cpu")
    assert env.consts.nsb == walls == len(env.boxes)
    np.testing.assert_array_equal(env.consts.box_min, env.boxes[:, 0])
    lanes, groups, shared = launch_geometry(env.consts)
    assert (lanes, groups) == (16, 16) and shared < 232_448
