"""The port's episodic replay against the JAX package, bit for bit: the
same function on the same integer data, float data only copied."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.replay import episodic as jep  # noqa: E402
from ddiffpg_tpu_torch.replay import episodic as ep  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

E, S, L, D, A, G, NG = 4, 10, 6, 3, 2, 4, 2
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
jadd = jax.jit(jep.add, static_argnames=("frontier_keep",))


def _assert_same(got, want):
    for f in want._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def _fill(frontier_keep, n_steps=40, seed=0):
    """A run of adds: episodes end at random (every env by step L), a
    third of them on a goal (1 or 2), with per-goal distances. The store
    holds S = 10 slots for 4 envs, so successes, frontier failures and
    age decide every eviction."""
    rng = np.random.RandomState(seed)
    jbuf = jep.EpisodicReplay.create(S, L, E, D, A, G, num_goals=NG)
    buf = ep.EpisodicReplay.create(S, L, E, D, A, G, num_goals=NG,
                                   device="cpu")
    _assert_same(buf, jbuf)
    t = np.zeros(E, np.int32)
    for _ in range(n_steps):
        obs, nxt = (rng.randn(E, D).astype(np.float32) for _ in range(2))
        act = rng.uniform(-1, 1, (E, A)).astype(np.float32)
        rew = rng.randn(E).astype(np.float32)
        end = (rng.rand(E) < 0.3) | (t + 1 >= L)
        succ = np.where(end & (rng.rand(E) < 0.35),
                        rng.randint(1, NG + 1, E), 0).astype(np.int32)
        done_b = end & (succ > 0)
        dist = rng.uniform(0, 10, (E, NG)).astype(np.float32)
        args = (obs, act, rew, nxt, done_b, end, succ)
        jbuf = jadd(jbuf, *map(jnp.asarray, args), goal_dist=dist,
                    frontier_keep=frontier_keep)
        buf = ep.add(buf, *map(T, args), goal_dist=T(dist),
                     frontier_keep=frontier_keep)
        _assert_same(buf, jbuf)
        t = np.where(end, 0, t + 1)
    return jbuf, buf


@pytest.mark.parametrize("frontier_keep", [0, 3])
def test_add_sequence_bitwise(frontier_keep):
    """Forty adds (~50 flushes into 10 slots): every table, id and flag
    equal after every add, with and without the frontier tier."""
    jbuf, buf = _fill(frontier_keep)
    assert int(buf.next_id[0]) > 3 * S
    assert bool(((buf.success > 0) & (buf.traj_id >= 0)).any())
    np.testing.assert_array_equal(
        ep.frontier_mask(buf, 3).numpy(),
        np.asarray(jep.frontier_mask(jbuf, 3)))
    assert float(ep.frontier_dist(buf)) == float(jep.frontier_dist(jbuf))


def _groups(rng):
    mask = rng.rand(G, S) < 0.6
    mask[0] = True
    return mask, np.array([0, 0, -1, 1], np.int32)


def test_set_groups_and_write_target_actions_bitwise():
    """set_groups (inheritance from rows 0 and 1, a reset row) and the
    scatter of new target actions for groups 0 and 2 (in-flight samples
    skipped): bitwise."""
    jbuf, buf = _fill(3, seed=1)
    rng = np.random.RandomState(1)
    mask, parent = _groups(rng)
    jbuf = jep.set_groups(jbuf, jnp.asarray(mask), jnp.asarray(parent))
    buf = ep.set_groups(buf, T(mask), T(parent))
    _assert_same(buf, jbuf)
    for g in (0, 2):
        jgb = jep.sample_group(jbuf, jax.random.PRNGKey(g), g, 16,
                               mix_temp=(g == 0))
        new = rng.uniform(-1, 1, (16, A)).astype(np.float32)
        fb = np.asarray(jgb.from_buffer)
        idx = set(zip(np.asarray(jgb.slot)[fb], np.asarray(jgb.step)[fb]))
        # an in-flight row that lands on a sampled buffer transition would
        # make XLA's write order decide; this draw has none
        assert not idx & set(zip(np.asarray(jgb.slot)[~fb],
                                 np.asarray(jgb.step)[~fb]))
        jbuf = jep.write_target_actions(jbuf, g, jgb, jnp.asarray(new))
        buf = ep.write_target_actions(buf, g, T(jgb.slot), T(jgb.step),
                                      T(jgb.from_buffer), T(new))
        _assert_same(buf, jbuf)


def _totals(jbuf, g, mix_temp, frontier_keep):
    mask = np.asarray(jbuf.group_mask[g]) & (np.asarray(jbuf.length) > 0)
    lens = np.where(mask, np.asarray(jbuf.length), 0)
    total = lens.sum() + (np.asarray(jbuf.tmp_len).sum() if mix_temp else 0)
    succ = np.where(mask & (np.asarray(jbuf.success) > 0), lens, 0).sum()
    fm = np.asarray(jep.frontier_mask(jbuf, frontier_keep))
    front = np.where(mask & fm, lens, 0).sum()
    return max(total, 1), max(succ, 1), max(front, 1)


@pytest.mark.parametrize("biased", [False, True])
def test_sample_group_bitwise(biased):
    """sample_group for groups 0 and 2 with JAX's integer draws fed in;
    `biased` turns on success_frac (mode groups) and frontier_frac with
    the near-goal escalation (explore group). Every field bitwise."""
    keep = 3
    jbuf, buf = _fill(keep, seed=2)
    mask, parent = _groups(np.random.RandomState(2))
    jbuf = jep.set_groups(jbuf, jnp.asarray(mask), jnp.asarray(parent))
    buf = ep.set_groups(buf, T(mask), T(parent))
    kw = dict(success_frac=0.25, frontier_frac=0.25, frontier_keep=keep,
              frontier_frac_near=0.5, frontier_near_dist=20.0) \
        if biased else {}
    b = 24
    for g in (0, 2):
        key = jax.random.PRNGKey(10 + g)
        jgb = jep.sample_group(jbuf, key, g, b, mix_temp=(g == 0), **kw)
        total, tot_s, tot_f = _totals(jbuf, g, g == 0, keep)
        k_u, k_s, k_f = jax.random.split(key, 3)
        draws = dict(u=T(jax.random.randint(k_u, (b,), 0, total)),
                     u_success=T(jax.random.randint(k_s, (b,), 0, tot_s)),
                     u_frontier=T(jax.random.randint(k_f, (b,), 0, tot_f)))
        gb = ep.sample_group(buf, g, b, mix_temp=(g == 0), **kw, **draws)
        for f in jgb._fields:
            w = np.asarray(getattr(jgb, f))
            got = getattr(gb, f).numpy()
            assert got.dtype == w.dtype, f
            np.testing.assert_array_equal(got, w, err_msg=f)
        assert gb.from_buffer.any() and (g > 0 or not gb.from_buffer.all())
