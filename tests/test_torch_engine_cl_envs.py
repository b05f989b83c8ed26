"""`envs.make(name, use_pallas=False)` steps the port's `engine_cl`: one
control step against the JAX package's `make(name, use_pallas=False)`
(its `engine_cl`) from the same states, JAX's reset draws fed in, for
antmaze-v1 (envs against the SDF walls); and `"auto"` still steps the
kernel's plain version on the CPU. DrawerMulti `ee` with
`use_pallas=False` is in tests/test_torch_envs_all.py, beside the JAX
program it shares.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddiffpg_tpu.envs.antmaze import AntMazeEnv as JaxAntMaze
from ddiffpg_tpu.envs.base import EnvState as JaxState
from ddiffpg_tpu_torch.envs import make
from ddiffpg_tpu_torch.envs.base import EnvState
from ddiffpg_tpu_torch.physics.engine_cl import Engine
from tests.port_fixtures import (  # noqa: F401
    fresh_structure_cache, one_torch_thread)

B = 8


def test_antmaze_engine_cl_step_matches_jax():
    """antmaze-v1 with use_pallas=False: envs beside and inside the reach
    of the inner wall (x = -2, the SDF walls act), env 0 at the goal, env
    1 at its last step; obs, reward, done, success, time-outs and the
    auto-reset state against JAX's, physics at tests/test_engine_cl.py's
    2e-5 (positions) and 2e-4 (velocities), the rest exact."""
    jenv = JaxAntMaze(random_init=True, use_pallas=False)
    env = make("antmaze-v1", num_envs=B, random_init=True, device="cpu",
               use_pallas=False)
    assert isinstance(env.env.engine, Engine) and env.env.kernel is None
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jenv.model.init_qpos)[None], (B, 1))
    qpos = qpos.astype(np.float32)
    qpos[:, 0] = rng.uniform(-1.9, -1.5, B)
    qpos[:, 1] = rng.uniform(-1.0, 1.0, B)
    qpos[0, :2] = (-7.8, 0.1)
    qvel = rng.uniform(-0.5, 0.5, (B, 14)).astype(np.float32)
    qvel[:, 0] -= 2.0
    act = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    t = rng.randint(0, 400, B).astype(np.int32)
    t[1] = 499
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jnew, jobs, jrew, jdone, jinfo = jax.jit(jenv.step_batched)(
        JaxState(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(t), keys),
        jnp.asarray(act))
    k = jax.vmap(jax.random.split)(keys)[:, 0]
    reset_xy = np.asarray(jax.vmap(jenv._init_state)(k).qpos[:, :2])
    new, obs, rew, done, info = env.step(
        EnvState(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(t)),
        torch.tensor(act), reset_xy=torch.tensor(reset_xy))

    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done[:2].all() and not done[2:].all()
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(info["success"].numpy(),
                                  np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(info["time_outs"].numpy(),
                                  np.asarray(jinfo["time_outs"]))
    jobs = np.asarray(jobs)
    np.testing.assert_allclose(obs[:, :15].numpy(), jobs[:, :15], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(obs[:, 15:].numpy(), jobs[:, 15:], atol=2e-4,
                               rtol=0)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_allclose(new.qpos.numpy(), np.asarray(jnew.qpos),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(new.qvel.numpy(), np.asarray(jnew.qvel),
                               atol=2e-4, rtol=0)
    # the walls acted: the same step without them differs
    free = make("antmaze-v1", num_envs=B, random_init=True, device="cpu",
                use_pallas=False)
    free.env.engine = Engine(dataclasses.replace(
        free.env.model, sdf_dist=np.zeros((0, 0), np.float32),
        sdf_grad=np.zeros((0, 0, 2), np.float32), nsb=0,
        static_box_min=np.zeros((0, 3), np.float32),
        static_box_max=np.zeros((0, 3), np.float32)), "cpu")
    _, obs_free, _, _, _ = free.step(
        EnvState(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(t)),
        torch.tensor(act))
    assert float((obs_free[2:, 15:] - obs[2:, 15:]).abs().max()) > 1e-2


@pytest.mark.parametrize("use_pallas", ["auto", True, False, "yes"])
def test_use_pallas_picks_the_physics(use_pallas):
    """On the CPU "auto" and True step the kernel's plain version (no
    engine, no kernel object), False `engine_cl`; anything else raises.
    Pointmaze, as JAX's, takes no `use_pallas`."""
    if use_pallas == "yes":
        with pytest.raises(ValueError, match="use_pallas"):
            make("antmaze-v1", num_envs=2, device="cpu",
                 use_pallas=use_pallas)
        with pytest.raises(TypeError):
            make("pointmaze-v1", num_envs=2, device="cpu", use_pallas=False)
        return
    for name in ("antmaze-v1", "PandaReachJoints-v3"):
        env = make(name, num_envs=2, device="cpu", use_pallas=use_pallas)
        assert env.env.kernel is None
        assert (env.env.engine is not None) == (use_pallas is False)
