"""The port's DIPO and DiffQ, and the baseline diffusion actor, against the
JAX package on the CPU.

1e-5: `BaselineMLP`, and `Diffusion.loss` (l2, l1, huber) and `sample`
(the vp schedule, clipped) on JAX's draws. One update pass of DIPO and of
DiffQ from a converted JAX state at stock widths (antmaze-v1, batch 48,
320 replay rows, a 3-step action gradient, K = 3), with obs_norm off and
on, with JAX's draws rebuilt from the pass's key: parameters and adam moments 1e-5, the
replay's target actions 1e-4, logs rtol 1e-4 (tests/test_torch_update.py's
bounds). The duplicate-index case of `update_target_action`: rows sampled
twice get bitwise equal new actions, so the scatter's winner does not
matter. `train.main` for DIPO on the CPU; its final checkpoint reloads bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.models import baseline_diffusion as jbd  # noqa: E402
from ddiffpg_tpu_torch.models import baseline_diffusion as bd  # noqa: E402
from ddiffpg_tpu_torch.replay import flat  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)
from tests.test_torch_baselines import (B, N, T, assert_reloaded,  # noqa
                                        check_core, check_logs, check_rms,
                                        close, equal, fill_core, jax_agent,
                                        jax_td3_draws, port_agent, run_main)

K = 3


@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
def test_baseline_diffusion_matches_jax(loss_type):
    """The eps net, the loss on JAX's noise and steps, and the K-step
    vp sample on JAX's draws, at stock widths (obs 29, action 8)."""
    rng = np.random.RandomState(0)
    D, A, n = 29, 8, 64
    obs = rng.randn(n, D).astype(np.float32)
    act = rng.uniform(-1, 1, (n, A)).astype(np.float32)
    jm = jbd.Diffusion(action_dim=A, n_timesteps=K, beta_schedule="vp",
                       loss_type=loss_type)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, A)), jnp.zeros((1,)),
                jnp.zeros((1, D)))
    m = bd.Diffusion(A, D, K, "vp", loss_type=loss_type, device="cpu")
    convert.load_params(m.parameters(), convert.baseline_diffusion_arrays(p))

    t = rng.randint(0, K, n)
    close(m(T(act), T(t.astype(np.float32)), T(obs)),
          jm.apply(p, jnp.asarray(act), jnp.asarray(t, jnp.float32),
                   jnp.asarray(obs)), 1e-5, "eps")

    key = jax.random.PRNGKey(7)
    kn, kt = jax.random.split(key)
    got = m.loss(T(obs), T(act), noise=T(jax.random.normal(kn, (n, A))),
                 t=T(jax.random.randint(kt, (n,), 0, K)))
    want = jm.apply(p, key, jnp.asarray(obs), jnp.asarray(act),
                    method=jbd.Diffusion.loss)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)

    k0, k1 = jax.random.split(key)
    steps = torch.stack([T(jax.random.normal(k, (n, A)))
                         for k in jax.random.split(k1, K)])
    got = m.act(T(obs), x_init=T(jax.random.normal(k0, (n, A))),
                noise=steps)
    want = jm.apply(p, jnp.asarray(obs), key, method=jbd.Diffusion.sample)
    close(got, want, 1e-5, "sample")
    assert float(got.abs().max()) <= 1.0


def _update_case(algo, rows=None, seed=0, obs_norm=False):
    """(JAX agent, filled JAX state, port agent, converted port state);
    `rows` cuts the replay's size (duplicates in the sample)."""
    over = {"algo.obs_norm": obs_norm}
    jagent = jax_agent(algo, **over)
    jts = fill_core(jagent.init(jax.random.PRNGKey(seed)),
                    np.random.RandomState(seed))
    if rows is not None:
        jts = jts._replace(replay=jts.replay._replace(
            size=jnp.asarray(rows, jnp.int32)))
    agent = port_agent(algo, **over)
    return jagent, jts, agent, convert.td3_state(
        agent, jax.tree.map(np.asarray, jts))


@pytest.mark.parametrize("obs_norm", [False, True])
@pytest.mark.parametrize("algo", ["dipo", "diffq"])
def test_update_once_matches_jax(algo, obs_norm):
    """One DIPO or DiffQ pass: the critic against the diffusion target
    actor's K reverse steps, the action gradient written back into the
    replay's target-action column, the distillation, RND and the soft
    targets. With obs_norm the intrinsic reward sees raw obs, and the
    rest (the action gradient too) normalised obs, as in JAX."""
    jagent, jts, agent, ts = _update_case(algo, obs_norm=obs_norm)
    key = jax.random.PRNGKey(21)
    jts2, jlogs = jax.jit(jagent._update_once)(jts, key)
    before = ts.replay.target_action.clone()
    ts, logs = agent.update_once(ts, jax_td3_draws(jts, key,
                                                   agent.action_dim, K))
    want = jax.tree.map(np.asarray, jts2)
    actor_fn = (convert.baseline_diffusion_arrays if algo == "diffq"
                else convert.actor_arrays)
    check_core(ts, want, actor_fn, convert.one_row_critic_arrays)
    check_rms(ts, want)
    close(ts.replay.target_action, want.replay.target_action, 1e-4,
          "target actions")
    for f in flat.FlatReplay._fields:
        if f != "target_action":
            equal(getattr(ts.replay, f), getattr(want.replay, f), f)
    moved = (ts.replay.target_action != before).any(-1)
    assert int(moved.sum()) > B // 2
    check_logs(logs, jlogs)


def test_duplicate_sample_rows_get_equal_actions(monkeypatch):
    """With 12 stored rows a batch of 48 samples most rows several times;
    the action gradient is per row and its clip and Adam scale every row
    alike, so every copy of a row ends bitwise equal and the scatter's
    winner (unfixed on CUDA) cannot change the table. The table matches
    JAX's at 1e-4."""
    jagent, jts, agent, ts = _update_case("dipo", rows=12, seed=3)
    key = jax.random.PRNGKey(5)
    draws = jax_td3_draws(jts, key, agent.action_dim, K)
    idx = draws.idx
    assert len(torch.unique(idx)) < len(idx) // 2
    seen = []
    real = flat.update_target_action

    def recording(buf, i, new):
        seen.append((i.clone(), new.clone()))
        return real(buf, i, new)

    monkeypatch.setattr(flat, "update_target_action", recording)
    ts, _ = agent.update_once(ts, draws)
    (i, new), = seen
    for row in torch.unique(i):
        copies = new[i == row]
        assert torch.equal(copies, copies[:1].expand_as(copies)), int(row)
    # a scatter in reverse order lands the same table
    table = ts.replay.target_action.clone()
    table.index_put_((i.flip(0),), new.flip(0))
    assert torch.equal(table, ts.replay.target_action)
    jts2, _ = jax.jit(jagent._update_once)(jts, key)
    close(ts.replay.target_action, jts2.replay.target_action, 1e-4)


def test_train_main_dipo(tmp_path):
    ts, fresh, names, recs = run_main("dipo", tmp_path)
    assert names == ["ckpt_72.pt", "ckpt_final.pt"]
    assert int(ts.global_step) == 80
    evals = [r for r in recs if "eval/return" in r]
    assert len(evals) == 2
    logs = [r for r in recs if "train/actor_loss" in r]
    assert logs and all(np.isfinite(r["train/actor_loss"]) for r in logs)
    assert_reloaded(ts, fresh)
    assert N(fresh.replay.target_action).shape == (400, 2)
