"""The port's collect path on PandaDrawerMultiJoints-v3 as a whole against
the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu.envs.base import EnvState as JaxState  # noqa: E402
from ddiffpg_tpu.models.diffusion import \
    DiffusionPolicy as JaxPolicy  # noqa: E402
from ddiffpg_tpu.ops import noise as jnoise  # noqa: E402
from ddiffpg_tpu.ops.embedding import \
    add_embedding as jax_add_embedding  # noqa: E402
from ddiffpg_tpu_torch.agents.ddiffpg import (collect,  # noqa: E402
                                              explore_actions)
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.envs.base import EnvState  # noqa: E402
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy  # noqa: E402
from ddiffpg_tpu_torch.utils.convert import load_diffusion  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

B, EMB, K, P = 16, 5, 5, 0.5
STD_MIN, STD_MAX = 0.05, 0.6
NAME = "PandaDrawerMultiJoints-v3"


def test_two_control_steps_match_jax():
    """Two control steps of mode-embedding mixing, the K=5 denoise, mixed
    noise and the env step at B=16 against the JAX path on the CPU
    (engine_cl physics) with JAX's draws fed in; step 1 runs the no-modes
    branch, step 2 two live modes. Env 0 starts with a drawer at 0.02, in
    the goal. Actions (float32 through the 1024-wide MLP in another order):
    1e-4. The obs comes from 20 substeps in engine_cl's order, and the
    force-limited kp = 2e4 arm servos make the motion chaotic (in the port
    alone a 1e-6 rad change of the start joint angles moves the ee
    velocity by more than 1e-2 two control steps later, tests/
    test_torch_panda_env.py), so two free-running steps part by ~0.1 m/s
    in ee velocity. Each step therefore starts the JAX env from the port's
    state and obs, and is held to one control step's differences: ee
    position 1e-5, ee velocity 1e-3 (ee velocities up to ~0.9 m/s), finger
    width and drawer joints 1e-5; reward and done exact."""
    jenv = jax_make(NAME, num_envs=B)
    env = make(NAME, num_envs=B, device="cpu")
    m, meta = env.env.model, env.env.meta
    A, O = env.action_dim, env.obs_dim
    actor = JaxPolicy(action_dim=A, diffusion_iter=K)
    key = jax.random.PRNGKey(0)
    params = actor.init(key, jnp.zeros((1, A)), jnp.zeros((1,)),
                        jnp.zeros((1, O + EMB)))
    policy = load_diffusion(DiffusionPolicy(A, O + EMB, K, device="cpu"),
                            jax.tree.map(np.asarray, params))
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (11, EMB)))

    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (B, 7))
    qpos[0, meta["task_qposadr"][1]] = 0.02
    jstate = JaxState(jnp.asarray(qpos), jnp.zeros((B, m.nv)),
                      jnp.zeros(B, jnp.int32),
                      jax.random.split(jax.random.PRNGKey(2), B))
    jobs = jax.vmap(jenv.env._obs)(jstate.qpos, jstate.qvel)
    state = EnvState(torch.tensor(qpos), torch.zeros(B, m.nv),
                     torch.zeros(B, dtype=torch.int32))
    obs = torch.tensor(np.asarray(jobs))

    for step, num_modes in enumerate((0, 2)):
        k = jax.random.split(jax.random.PRNGKey(10 + step), 3)
        emb_obs = jax_add_embedding(k[0], jobs, jnp.asarray(table[0]), P,
                                    jnp.asarray(table[1:]), num_modes)
        jact = actor.apply(params, k[1], emb_obs, method=JaxPolicy.act)
        jact = jnoise.add_mixed_normal_noise(k[2], jact, STD_MIN, STD_MAX,
                                             out_bounds=(-1, 1))
        jstate, jobs, jrew, jdone, _ = jenv.step(jstate, jact)

        k_init, k_scan = jax.random.split(k[1])
        draws = dict(
            zero_mask=jax.random.permutation(k[0], jnp.arange(B) < B * P),
            x_init=jax.random.normal(k_init, (B, A)),
            step_noise=jnp.stack([jax.random.normal(kk, (B, A))
                                  for kk in jax.random.split(k_scan, K)]),
            action_noise=jax.random.normal(k[2], (B, A)))
        draws = {n: torch.tensor(np.asarray(v)) for n, v in draws.items()}
        act = explore_actions(policy, obs, P, torch.tensor(table),
                              num_modes, STD_MIN, STD_MAX, **draws)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=1e-4)
        state, obs, rew, done, _ = env.step(state, act)
        want = np.asarray(jobs)
        for cols, tol in ((slice(0, 3), 1e-5), (slice(3, 6), 1e-3),
                          (slice(6, O), 1e-5)):
            np.testing.assert_allclose(obs[:, cols].numpy(), want[:, cols],
                                       atol=tol, rtol=0)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        if step == 0:
            assert float(rew[0]) == 10.0 and bool(done[0])
        jstate = jstate._replace(qpos=jnp.asarray(state.qpos.numpy()),
                                 qvel=jnp.asarray(state.qvel.numpy()))
        jobs = jnp.asarray(obs.numpy())


def test_collect_records_and_auto_reset():
    """collect's records on DrawerMulti have the right shapes and values,
    and an env whose episode ends inside the window restarts its clock."""
    env = make(NAME, num_envs=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    policy = DiffusionPolicy(8, 11 + EMB, K, device="cpu", generator=g)
    state, obs = env.reset()
    state = state._replace(t=torch.tensor([98, 0, 10, 50],
                                          dtype=torch.int32))
    state, obs, roll = collect(env, policy, state, obs, 3, P,
                               torch.randn(11, EMB, generator=g), 0,
                               STD_MIN, STD_MAX, generator=g)
    assert roll.action.shape == (3, 4, 8) and roll.obs.shape == (3, 4, 11)
    assert float(roll.action.abs().max()) <= 1.0
    assert bool(torch.isfinite(roll.obs).all())
    assert roll.done[:, 0].tolist() == [False, True, False]
    assert state.t.tolist() == [1, 3, 13, 53]
    torch.testing.assert_close(obs, roll.obs[-1])
