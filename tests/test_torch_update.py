"""The port's update pass against the JAX agent's, and its train iteration.

`update_once` at G = 1 and G = 3 runs from a JAX `DDiffPGState` converted
with `utils/convert.py`, with JAX's draws rebuilt from the pass's key,
against `jax.jit(AgentDDiffPG._update_once)` on the CPU. The config is the
stock one after `preprocess` (stock widths), cut to 4 envs, batch 48, 12
replay slots, a 3-step action gradient and K = 3.
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
from ddiffpg_tpu_torch.agents import make_agent  # noqa: E402
from ddiffpg_tpu_torch.agents.base import TargetDraws  # noqa: E402
from ddiffpg_tpu_torch.agents.ddiffpg import UpdateDraws  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.replay import episodic as ep  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

E, B, K, AG_STEPS, SLOTS = 4, 48, 3, 3, 12
OVER = {"num_envs": E, "algo.batch_size": B, "algo.memory_size": SLOTS,
        "diffusion.update_times": AG_STEPS, "diffusion.diffusion_iter": K}
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


def _cfg(mod):
    cfg = mod.Config(algo=mod.algo_preset("ddiffpg")).override(
        **{"env.name": "antmaze-v1"})
    return mod.preprocess(cfg).override(**OVER)


@pytest.fixture(scope="module")
def jax_agent():
    cfg = _cfg(JC)
    agent = jax_make_agent("DDiffPG", jax_make("antmaze-v1", num_envs=E,
                                                random_init=True), cfg)
    ts = agent.init(jax.random.PRNGKey(0))
    return agent, _fill_state(ts, np.random.RandomState(0)), \
        jax.jit(agent._update_once, static_argnums=2)


def _fill_state(ts, rng):
    """A mid-training JAX state: 9 stored trajectories (two successes),
    in-flight episodes, critic rows that differ, and adam moments at a
    count of 3 (from fresh moments Adam's first step is the gradient's
    sign, which float32 noise can flip on a near-zero gradient)."""
    rep = ts.replay
    S, L1, D = rep.obs.shape
    L, A = L1 - 1, rep.action.shape[-1]
    Gm = rep.group_mask.shape[0]
    length = np.zeros(S, np.int32)
    length[:9] = rng.randint(20, L + 1, 9)
    length[3] = 5
    xy = lambda *s: rng.uniform(-2, 10, s + (2,))  # noqa: E731
    obs = rng.randn(S, L1, D).astype(np.float32) * 0.5
    obs[..., :2] = xy(S, L1)
    tmp_len = np.array([0, 7, 130, 499], np.int32)
    tmp_obs = rng.randn(E, L1, D).astype(np.float32) * 0.5
    tmp_obs[..., :2] = xy(E, L1)
    rep = rep._replace(
        obs=obs, action=rng.uniform(-1, 1, (S, L, A)).astype(np.float32),
        reward=(rng.rand(S, L) < 0.02).astype(np.float32) * 10,
        done=rng.rand(S, L) < 0.01, length=length,
        success=np.array([0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0], np.int32),
        traj_id=np.where(length > 0, np.arange(S), -1).astype(np.int32),
        frontier=np.where(length[:, None] > 0, rng.uniform(1, 9, (S, 1)),
                          1e9).astype(np.float32),
        next_id=np.array([9], np.int32),
        target_action=rng.uniform(-1, 1, (Gm, S, L, A)).astype(np.float32),
        tmp_obs=tmp_obs,
        tmp_action=rng.uniform(-1, 1, (E, L, A)).astype(np.float32),
        tmp_reward=np.zeros((E, L), np.float32),
        tmp_done=np.zeros((E, L), bool), tmp_len=tmp_len)
    perturb = lambda tree, s: jax.tree.map(  # noqa: E731
        lambda x: x * (1.0 + s * jnp.arange(x.shape[0]).reshape(
            (-1,) + (1,) * (x.ndim - 1))), tree)

    def moments(s):
        if not hasattr(s, "mu"):
            return tuple(moments(x) for x in s) if isinstance(s, tuple) \
                else s
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        return s._replace(
            mu=jax.tree.map(lambda x: f32(rng.randn(*x.shape) * 1e-3), s.mu),
            nu=jax.tree.map(lambda x: f32(rng.rand(*x.shape) * 1e-6), s.nu),
            count=jnp.full(s.count.shape, 3, jnp.int32))

    return ts._replace(
        replay=rep, critics=perturb(ts.critics, 0.02),
        critic_targets=perturb(ts.critics, 0.03),
        critic_opts=moments(ts.critic_opts),
        actor_opt=moments(ts.actor_opt),
        intrinsic=ts.intrinsic._replace(
            opt_state=moments(ts.intrinsic.opt_state)))


def _with_groups(ts, G):
    """Groups 1.. hold stored trajectories picked by hand."""
    if G == 1:
        return ts
    mask = np.zeros(ts.replay.group_mask.shape, bool)
    mask[0] = np.asarray(ts.replay.length) > 0
    mask[1, [0, 1, 2, 5]] = True
    mask[2, [3, 4, 6, 7, 8]] = True
    return ts._replace(replay=ts.replay._replace(group_mask=mask))


def _draws(ts, key, G, A):
    """The draws of JAX's `_update_once(ts, key, G)`, rebuilt from its
    keys (agents/ddiffpg.py:308-424)."""
    b = B // G
    rep = jax.tree.map(np.asarray, ts.replay)
    keys = jax.random.split(key, G + 4)
    u = []
    for i in range(G):
        lens = np.where(rep.group_mask[i] & (rep.length > 0), rep.length, 0)
        total = max(lens.sum() + (rep.tmp_len.sum() if i == 0 else 0), 1)
        u.append(jax.random.randint(jax.random.split(keys[i], 3)[0], (b,),
                                    0, total))
    drop = jax.random.split(keys[G + 1], 2 * G)
    masks = [jax.random.permutation(k, jnp.arange(b) < b // 2) for k in drop]
    k1, k2 = jax.random.split(keys[G])
    k_init, k_scan = jax.random.split(k1)
    n = G * b
    k_noise, k_t = jax.random.split(keys[G + 2])
    return UpdateDraws(
        u=T(jnp.stack(u)), emb_masks=T(jnp.stack(masks)),
        target=TargetDraws(
            x_init=T(jax.random.normal(k_init, (n, A))),
            step_noise=T(jnp.stack([jax.random.normal(kk, (n, A)) for kk in
                                    jax.random.split(k_scan, K)])),
            noise=T(jax.random.normal(k2, (n, A)))),
        loss_noise=T(jax.random.normal(k_noise, (n, A))),
        loss_t=T(jax.random.randint(k_t, (n,), 0, K)))


def _port_agent():
    env = make("antmaze-v1", num_envs=E, random_init=True, device="cpu")
    return make_agent("DDiffPG", env, _cfg(C), device="cpu")


@pytest.mark.parametrize("G", [1, 3])
def test_update_once_matches_jax(jax_agent, G):
    """One update pass from the same converted state with JAX's draws.
    Tolerances: parameters and adam moments after one step 1e-5 (float32
    GEMMs summed in another order, through the C51 loss and Adam);
    target actions after the 3-step action gradient 1e-4; losses, norms
    and logs rtol 1e-4; replay tables off the target actions, counts and
    the intrinsic step exact. Rows >= G of the critics, targets and their
    adam states stay bit for bit."""
    jagent, jts, jupd = jax_agent
    jts = _with_groups(jts, G)
    agent = _port_agent()
    ts = convert.ddiffpg_state(agent, jax.tree.map(np.asarray, jts))
    before = [x.detach().clone() for x in ts.critics.params()
              + ts.critic_targets.params() + ts.critic_opts.mu
              + ts.critic_opts.nu]
    key = jax.random.PRNGKey(100 + G)
    jts2, jlogs = jupd(jts, key, G)
    ts, logs = agent.update_once(ts, G, _draws(jts, key, G,
                                               agent.action_dim))
    want = jax.tree.map(np.asarray, jts2)

    close = lambda got, w, tol: np.testing.assert_allclose(  # noqa: E731
        got.detach().numpy(), w, atol=tol, rtol=0)
    for got, w in zip(ts.critics.params(), convert.critic_arrays(
            want.critics)):
        close(got[:G], w[:G], 1e-5)
    for got, w in zip(ts.critic_targets.params(), convert.critic_arrays(
            want.critic_targets)):
        close(got[:G], w[:G], 1e-5)
    for got, w in zip(ts.actor.parameters(), convert.actor_arrays(
            want.actor_params)):
        close(got, w, 1e-5)
    for got, w in zip(ts.intrinsic.net.params(), convert.rnd_arrays(
            want.intrinsic.params)):
        close(got, w, 1e-5)
    for got, w, fn in ((ts.critic_opts, want.critic_opts,
                        convert.critic_arrays),
                       (ts.actor_opt, want.actor_opt, convert.actor_arrays),
                       (ts.intrinsic.opt_state, want.intrinsic.opt_state,
                        convert.rnd_arrays)):
        w = convert.find_adam(w)
        for x, y in zip(got.mu + got.nu, fn(w.mu) + fn(w.nu)):
            close(x[:G] if got is ts.critic_opts else x,
                  y[:G] if got is ts.critic_opts else y, 1e-5)
        np.testing.assert_array_equal(got.count.numpy(), w.count)
    after = (ts.critics.params() + ts.critic_targets.params()
             + ts.critic_opts.mu + ts.critic_opts.nu)
    for x, old in zip(after, before):
        assert torch.equal(x[G:], old[G:])
        assert not torch.equal(x[:G], old[:G])

    close(ts.replay.target_action, want.replay.target_action, 1e-4)
    for f in ep.EpisodicReplay._fields:
        if f != "target_action":
            np.testing.assert_array_equal(getattr(ts.replay, f).numpy(),
                                          getattr(want.replay, f))
    moved = ts.replay.target_action != T(jts.replay.target_action)
    assert int(moved.any(-1).sum()) > B // 2
    np.testing.assert_array_equal(ts.intrinsic.update_step.numpy(),
                                  want.intrinsic.update_step)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert set(logs) == set(jlogs)


def test_train_iter_on_cpu():
    """The port's train iteration alone: envs at t = 498 and 499 truncate
    inside the window and flush into slots, the logs are finite,
    global_step advances by envs x horizon per iteration, and with G = 2
    live groups rows 2.. of the critics, targets and adam states stay bit
    for bit while rows 0 and 1 move."""
    agent = _port_agent()
    agent.cfg = agent.cfg.override(**{"algo.update_times": 2})
    ts = agent.init()
    ts.env_state = ts.env_state._replace(
        t=torch.tensor([498, 499, 3, 0], dtype=torch.int32))
    mask = torch.zeros(agent.G_max, SLOTS, dtype=torch.bool)
    mask[0] = True
    ep.set_groups(ts.replay, mask, torch.tensor([0, 0] + [-1] * 9))
    agent.num_groups = 2
    before = [x.detach().clone() for x in ts.critics.params()
              + ts.critic_targets.params() + ts.critic_opts.mu]
    for i in range(3):
        ts, logs = agent.train_iter(ts, steps=i * E)
        assert all(np.isfinite(float(v)) for v in logs.values()), logs
    assert int(ts.global_step) == 3 * E
    assert sorted(ts.replay.length[ts.replay.traj_id >= 0].tolist()) == \
        [1, 2]
    assert ts.env_state.t.tolist() == [1, 2, 6, 3]
    assert ts.critic_opts.count.tolist() == [6, 6] + [0] * 9
    assert logs["train/num_groups"] == 2.0
    after = (ts.critics.params() + ts.critic_targets.params()
             + ts.critic_opts.mu)
    for x, old in zip(after, before):
        assert torch.equal(x[2:], old[2:])
        assert not torch.equal(x[:2], old[:2])


def test_agent_defaults_to_card():
    """Without device="cpu" the agent belongs on the card: with none it
    raises. (`algo.obs_norm` is ported: tests/test_torch_baselines.py::
    test_obs_norm_every_agent.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default builds there")
    env = make("antmaze-v1", num_envs=E, random_init=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_agent("DDiffPG", env, _cfg(C))
