"""The port's collect path as a whole against the JAX package, and the
port's independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

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
REPO = Path(__file__).resolve().parents[1]


def test_two_control_steps_match_jax():
    """Two control steps of mode-embedding mixing, the K=5 denoise, mixed
    noise and the env step at B=16, from inside the start cell, against
    the JAX path on the CPU (engine_cl physics) with JAX's draws fed in.
    Step 1 runs the no-modes branch, step 2 two live modes. Actions
    (float32 through the 1024-wide MLP in another order): 1e-4. The ants
    drop onto the floor, and 20 contact-rich substeps in engine_cl's order
    widen the physics' differences: obs positions 1e-4 and velocities 2e-3,
    5x and 10x tests/test_engine_cl.py's bounds for 5 substeps."""
    jenv = jax_make("antmaze-v1", num_envs=B, random_init=True)
    env = make("antmaze-v1", num_envs=B, random_init=True, device="cpu")
    actor = JaxPolicy(action_dim=8, diffusion_iter=K)
    key = jax.random.PRNGKey(0)
    params = actor.init(key, jnp.zeros((1, 8)), jnp.zeros((1,)),
                        jnp.zeros((1, 29 + EMB)))
    policy = load_diffusion(DiffusionPolicy(8, 29 + EMB, K, device="cpu"),
                            jax.tree.map(np.asarray, params))
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (11, EMB)))

    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jenv.env.model.init_qpos)[None], (B, 1))
    qpos[:, :2] = rng.uniform(-0.8, 0.8, (B, 2))
    qpos = qpos.astype(np.float32)
    jstate = JaxState(jnp.asarray(qpos), jnp.zeros((B, 14)),
                      jnp.zeros(B, jnp.int32),
                      jax.random.split(jax.random.PRNGKey(2), B))
    jobs = jnp.concatenate([jstate.qpos[:, :15], jstate.qvel], -1)
    state = EnvState(torch.tensor(qpos), torch.zeros(B, 14),
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
            x_init=jax.random.normal(k_init, (B, 8)),
            step_noise=jnp.stack([jax.random.normal(kk, (B, 8))
                                  for kk in jax.random.split(k_scan, K)]),
            action_noise=jax.random.normal(k[2], (B, 8)))
        draws = {n: torch.tensor(np.asarray(v)) for n, v in draws.items()}
        act = explore_actions(policy, obs, P, torch.tensor(table),
                              num_modes, STD_MIN, STD_MAX, **draws)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=1e-4)
        state, obs, rew, done, _ = env.step(state, act)
        want = np.asarray(jobs)
        np.testing.assert_allclose(obs[:, :15].numpy(), want[:, :15],
                                   atol=1e-4)
        np.testing.assert_allclose(obs[:, 15:].numpy(), want[:, 15:],
                                   atol=2e-3)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_collect_records_and_auto_reset():
    """collect's records have the right shapes and values, and an env
    whose episode ends inside the window restarts its clock."""
    env = make("antmaze-v1", num_envs=4, random_init=True, device="cpu")
    g = torch.Generator().manual_seed(0)
    policy = DiffusionPolicy(8, 29 + EMB, K, device="cpu", generator=g)
    state, obs = env.reset()
    state = state._replace(t=torch.tensor([498, 0, 10, 100],
                                          dtype=torch.int32))
    state, obs, roll = collect(env, policy, state, obs, 3, P,
                               torch.randn(11, EMB, generator=g), 0,
                               STD_MIN, STD_MAX, generator=g)
    assert roll.action.shape == (3, 4, 8) and roll.obs.shape == (3, 4, 29)
    assert float(roll.action.abs().max()) <= 1.0
    assert bool(torch.isfinite(roll.obs).all())
    assert roll.done[:, 0].tolist() == [False, True, False]
    assert state.t.tolist() == [1, 3, 13, 103]
    torch.testing.assert_close(obs, roll.obs[-1])


def test_port_runs_without_jax():
    """Importing every module of the port (the entry point, the recluster
    and its native linkage, the DTW kernel's binding, the eval and the
    logger among them), chip_smoke and the port tests' shared set-up
    (tests/port_fixtures.py, its structure-cache reset run once), then
    building and stepping antmaze-v1 and
    PandaDrawerMultiJoints-v3 on the CPU, and building the DDiffPG agent
    there, running one small train iteration, a recluster and a
    checkpoint's save and load, never loads jax, jaxlib, flax or the JAX
    package (the card's machine has no JAX, and the port keeps its own
    copies of what it needs). The child runs on one intra-op thread, as
    the port's test files do."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import ddiffpg_tpu_torch\n"
        "for mod in pkgutil.walk_packages(ddiffpg_tpu_torch.__path__,\n"
        "                                 'ddiffpg_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "import tests.port_fixtures\n"
        "tests.port_fixtures._clear_structure_cache()\n"
        "from ddiffpg_tpu_torch.agents.ddiffpg import collect\n"
        "from ddiffpg_tpu_torch.envs import make\n"
        "from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy\n"
        "for name, obs_dim in (('antmaze-v1', 29),\n"
        "                      ('PandaDrawerMultiJoints-v3', 11)):\n"
        "    env = make(name, num_envs=2, device='cpu')\n"
        "    s, o = env.reset()\n"
        "    pol = DiffusionPolicy(8, obs_dim + 5, 5, device='cpu')\n"
        "    collect(env, pol, s, o, 1, 0.5, torch.zeros(11, 5), 0, .05, .6)\n"
        "from ddiffpg_tpu_torch import config as C\n"
        "from ddiffpg_tpu_torch.agents import make_agent\n"
        "cfg = C.preprocess(C.Config()).override(**{\n"
        "    'num_envs': 2, 'algo.batch_size': 16, 'algo.memory_size': 4,\n"
        "    'algo.update_times': 1, 'diffusion.update_times': 2,\n"
        "    'diffusion.diffusion_iter': 2})\n"
        "env = make('antmaze-v1', num_envs=2, random_init=True, device='cpu')\n"
        "agent = make_agent('DDiffPG', env, cfg, device='cpu')\n"
        "ts, logs = agent.train_iter(agent.init(), steps=0)\n"
        "assert all(torch.isfinite(v) for v in logs.values()), logs\n"
        "ts = agent.update_cluster(ts)\n"
        "import tempfile\n"
        "from ddiffpg_tpu_torch.utils import checkpoint\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    checkpoint.save(d + '/c.pt', ts, {'num_groups': 1})\n"
        "    checkpoint.load(d + '/c.pt', agent.init())\n"
        "for m in ('ddiffpg_tpu_torch.train',\n"
        "          'ddiffpg_tpu_torch.modes._native',\n"
        "          'ddiffpg_tpu_torch.modes.cluster',\n"
        "          'ddiffpg_tpu_torch.ops.dtw_cuda',\n"
        "          'ddiffpg_tpu_torch.agents.evaluation',\n"
        "          'ddiffpg_tpu_torch.utils.logger'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(m for m in ('jax', 'jaxlib', 'flax', 'ddiffpg_tpu')\n"
        "             if m in sys.modules)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
