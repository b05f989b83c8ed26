"""The port's AgentDDiffPG.update_cluster against the JAX agent's.

A mid-training JAX state (tests/test_torch_update.py's: 12 slots, 9 stored
trajectories) is carried into the port with `utils/convert.py:
ddiffpg_state`. The successes' xy tracks are set so the recluster finds
two modes (1 -> 3 groups); then both replays gain a success beside one of
them and both recluster again (a re-match: rows inherited, an embedding
kept). The fresh embeddings are JAX's draw, fed in. After each recluster
the replay tables, the critic rows, targets and optimizer rows, and the
embeddings must equal JAX's bit for bit (a gather and a masked reset move
no bits), and the group counts must agree. Then one update pass at G = 3
agrees with `jax.jit(_update_once)` within tests/test_torch_update.py's
bounds (parameters 1e-5, target actions 1e-4, logs rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu import config as JC  # noqa: E402
from ddiffpg_tpu.agents import make_agent as jax_make_agent  # noqa: E402
from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu_torch import config as C  # noqa: E402
from ddiffpg_tpu_torch.replay import episodic as ep  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.test_torch_update import (E, _cfg, _draws, _fill_state,  # noqa
                                     _port_agent)
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


def _corridor(rng, n, y):
    """n xy points from (0, 0) along y = `y` to (-8, y), with noise."""
    s = np.linspace(0.0, 1.0, n)
    xy = np.stack([-8.0 * s, y * np.sin(np.pi * s)], axis=1)
    return (xy + 0.05 * rng.randn(n, 2)).astype(np.float32)


def _with_modes(jts, rng):
    """Successes in slots 1 (upper route) and 5 (lower route)."""
    obs = np.array(jts.replay.obs)
    length = np.asarray(jts.replay.length)
    obs[1, : length[1] + 1, :2] = _corridor(rng, length[1] + 1, 4.0)
    obs[5, : length[5] + 1, :2] = _corridor(rng, length[5] + 1, -4.0)
    return jax.tree.map(jnp.asarray,
                        jts._replace(replay=jts.replay._replace(obs=obs)))


def _fresh_embeddings(jts):
    """JAX update_cluster's draw (agents/ddiffpg.py:598-599)."""
    key = jax.random.fold_in(jts.key, int(jts.global_step))
    return T(jax.random.normal(key, jts.embeddings.shape))


def _assert_same_state(agent, ts, jagent, jts):
    assert agent.num_groups == jagent.num_groups
    assert agent.num_clusters == jagent.num_clusters
    assert agent.last_goal_counts == jagent.last_goal_counts
    want = jax.tree.map(np.asarray, jts)
    for f in ep.EpisodicReplay._fields:
        np.testing.assert_array_equal(getattr(ts.replay, f).numpy(),
                                      getattr(want.replay, f), err_msg=f)
    for got, w in ((ts.critics, want.critics),
                   (ts.critic_targets, want.critic_targets)):
        for x, y in zip(got.params(), convert.critic_arrays(w)):
            np.testing.assert_array_equal(x.detach().numpy(), y)
    adam = convert.find_adam(want.critic_opts)
    for x, y in zip(ts.critic_opts.mu + ts.critic_opts.nu,
                    convert.critic_arrays(adam.mu)
                    + convert.critic_arrays(adam.nu)):
        np.testing.assert_array_equal(x.numpy(), y)
    np.testing.assert_array_equal(ts.critic_opts.count.numpy(), adam.count)
    np.testing.assert_array_equal(ts.embeddings.numpy(), want.embeddings)


@pytest.fixture(scope="module")
def carried():
    """The JAX agent and state after two reclusters, the port's likewise,
    and the jitted JAX update pass."""
    cfg = _cfg(JC)
    jagent = jax_make_agent("DDiffPG", jax_make("antmaze-v1", num_envs=E,
                                                 random_init=True), cfg)
    rng = np.random.RandomState(3)
    jts = jagent.init(jax.random.PRNGKey(0))
    filled = _fill_state(jts, np.random.RandomState(0))
    # _fill_state's moments turn optax's EmptyStates into (); update_cluster
    # maps the critics' chain state against a fresh one, so keep its tree
    filled = filled._replace(critic_opts=jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jts.critic_opts),
        jax.tree_util.tree_leaves(filled.critic_opts)))
    jts = _with_modes(filled, rng)
    agent = _port_agent()
    assert agent.cfg.algo.cluster_threshold == 50.0 == \
        _cfg(C).algo.cluster_threshold
    ts = convert.ddiffpg_state(agent, jax.tree.map(np.asarray, jts))
    steps = []
    for i in range(2):
        if i == 1:
            # a stored failure of both replays becomes a third success,
            # beside slot 1's route
            s = int(np.flatnonzero((np.asarray(jts.replay.traj_id) >= 0)
                                   & (np.asarray(jts.replay.success) == 0))[0])
            track = _corridor(rng, int(jts.replay.length[s]) + 1, 4.0)
            obs = np.array(jts.replay.obs)
            obs[s, : len(track), :2] = track
            success = np.array(jts.replay.success)
            success[s] = 1
            jts = jts._replace(replay=jts.replay._replace(
                obs=jnp.asarray(obs), success=jnp.asarray(success)))
            ts.replay.obs[s, : len(track), :2] = T(track)
            ts.replay.success[s] = 1
            steps.append(s)
        fresh = _fresh_embeddings(jts)
        jts = jagent.update_cluster(jts)
        ts = agent.update_cluster(ts, fresh_embeddings=fresh)
        steps.append((agent.num_groups, list(jagent.cluster_manager.scheduler
                                             .last_cluster)))
        _assert_same_state(agent, ts, jagent, jts)
    return jagent, jts, agent, ts, steps, \
        jax.jit(jagent._update_once, static_argnums=2)


def test_recluster_one_to_three_groups_then_rematch(carried):
    """Both reclusters find the two routes; the second keeps each route's
    critic row, optimizer row and embedding (no fresh rows), and the new
    success joins the upper route."""
    jagent, jts, agent, ts, steps, _ = carried
    (g1, first), s, (g2, second) = steps
    assert (g1, g2) == (3, 3)
    assert sorted(map(sorted, first)) == [[1], [5]]
    ids = np.asarray(jts.replay.traj_id)
    upper = [c for c in second if 1 in c][0]
    assert sorted(upper) == sorted([1, int(ids[s])])
    assert ts.critic_opts.count[1:3].tolist() == \
        np.asarray(convert.find_adam(jts.critic_opts).count)[1:3].tolist()


def _warm_fresh_rows(opt, rng):
    """The critic rows whose optimizer the recluster reset get moments at
    a count of 3, as tests/test_torch_update.py's states have: from zero
    moments Adam's first step is the gradient's sign, which float32 noise
    flips on a near-zero gradient."""
    if hasattr(opt, "mu"):
        fresh = np.asarray(opt.count) == 0

        def rows(x, draw):
            x = np.array(x)
            x[fresh] = draw(x[fresh].shape).astype(np.float32)
            return jnp.asarray(x)

        return opt._replace(
            mu=jax.tree.map(lambda x: rows(x, lambda sh: rng.randn(*sh)
                                           * 1e-3), opt.mu),
            nu=jax.tree.map(lambda x: rows(x, lambda sh: rng.rand(*sh)
                                           * 1e-6), opt.nu),
            count=jnp.where(fresh, 3, opt.count))
    if isinstance(opt, tuple) and not hasattr(opt, "_fields"):
        return tuple(_warm_fresh_rows(x, rng) for x in opt)
    return opt


def test_update_once_after_recluster_matches_jax(carried):
    """One update pass at the recluster's G = 3 from the carried states,
    with JAX's draws (tests/test_torch_update.py's bounds)."""
    jagent, jts, agent, ts, _, jupd = carried
    G = agent.num_groups
    jts = jts._replace(critic_opts=_warm_fresh_rows(
        jts.critic_opts, np.random.RandomState(5)))
    ts.critic_opts = convert.adam_state(
        jax.tree.map(np.asarray, jts.critic_opts), convert.critic_arrays)
    key = jax.random.PRNGKey(7)
    jts2, jlogs = jupd(jts, key, G)
    ts, logs = agent.update_once(ts, G, _draws(jts, key, G,
                                               agent.action_dim))
    want = jax.tree.map(np.asarray, jts2)
    close = lambda got, w, tol: np.testing.assert_allclose(  # noqa: E731
        got.detach().numpy(), w, atol=tol, rtol=0)
    for got, w in zip(ts.critics.params(),
                      convert.critic_arrays(want.critics)):
        close(got, w, 1e-5)
    for got, w in zip(ts.critic_targets.params(),
                      convert.critic_arrays(want.critic_targets)):
        close(got, w, 1e-5)
    for got, w in zip(ts.actor.parameters(),
                      convert.actor_arrays(want.actor_params)):
        close(got, w, 1e-5)
    close(ts.replay.target_action, want.replay.target_action, 1e-4)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
