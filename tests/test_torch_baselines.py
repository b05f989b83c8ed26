"""The port's TD3 and SAC, and the baselines' shared pieces, against the JAX
package on the CPU.

The same numpy-made inputs, and JAX's own random draws rebuilt from its
keys, go through the JAX function and the port's. Exact: the schedules,
`noise_std`, the n-step window (`fold_window`, `push` at n = 1 and 3 with
dones inside the window) and the flat replay's `add` (wraparound, the
window's gate), sample by index and `update_target_action`. 1e-5: the MLP
policies (`TanhDiagGaussianMLPPolicy.sample_logprob` on JAX's normal draw)
and `DoubleQ`. One update pass of TD3 and of SAC from a converted JAX state
at stock widths (antmaze-v1, batch 48, 320 replay rows), with obs_norm off
and on (an rms far from 0 and 1): parameters and adam moments 1e-5, logs
rtol 1e-4 (tests/test_torch_update.py's bounds).
One `_env_step` of TD3 on pointmaze-v1: the replay rows, window and
pointers exact, given JAX's env outputs. `obs_norm` on all five agents, the
rms against JAX's `update_rms` at 1e-6. `train.main` for TD3 on the CPU
with a light and a full checkpoint; the full one reloads bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu import config as JC  # noqa: E402
from ddiffpg_tpu.agents import base as jbase  # noqa: E402
from ddiffpg_tpu.agents import make_agent as jax_make_agent  # noqa: E402
from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu.models import mlp as jmlp  # noqa: E402
from ddiffpg_tpu.ops import nstep as jnstep  # noqa: E402
from ddiffpg_tpu.ops import running_stats as jrs  # noqa: E402
from ddiffpg_tpu.ops import schedules as jsched  # noqa: E402
from ddiffpg_tpu.replay import flat as jflat  # noqa: E402
from ddiffpg_tpu_torch import config as C  # noqa: E402
from ddiffpg_tpu_torch import train  # noqa: E402
from ddiffpg_tpu_torch.agents import base  # noqa: E402
from ddiffpg_tpu_torch.agents import make_agent  # noqa: E402
from ddiffpg_tpu_torch.agents.td3 import EnvDraws, UpdateDraws  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.models import mlp  # noqa: E402
from ddiffpg_tpu_torch.ops import nstep, schedules  # noqa: E402
from ddiffpg_tpu_torch.ops import running_stats as rs  # noqa: E402
from ddiffpg_tpu_torch.replay import flat  # noqa: E402
from ddiffpg_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

E, B, ROWS, CAP = 4, 48, 300, 320
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
N = lambda x: x.detach().cpu().numpy()  # noqa: E731


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(N(got), np.asarray(want), atol=tol, rtol=0,
                               err_msg=msg)


def equal(got, want, msg=""):
    np.testing.assert_array_equal(N(got), np.asarray(want), err_msg=msg)


# ------------------------------------------------------- schedules, noise


def test_schedules_and_noise_std_exact():
    """Python steps and a float32 step tensor: bit for bit JAX's values in
    float32 (where JAX returns a Python float, the float32 it becomes in
    use); `tanh` within an ulp of the tanh."""
    steps = [0, 1, 7, 250, 9999, 10000, 123456]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    # XLA flushes float32 subnormals to zero and torch keeps them, so the
    # step tensor stays where 0.6 * 0.99**step is a normal number
    for s in steps + [np.array([0, 1, 7, 250, 2000, 5000], np.float32)]:
        js = jnp.asarray(s) if isinstance(s, np.ndarray) else s
        ts = torch.tensor(s) if isinstance(s, np.ndarray) else s
        for fn, args in ((schedules.linear, (0.6, 0.05, 10000)),
                         (schedules.exponential, (0.6, 0.99, 0.05)),
                         (schedules.exponential, (0.6, 0.99)),
                         (schedules.tanh, (0, 200000))):
            want = getattr(jsched, fn.__name__)(js, *args)
            if fn is schedules.tanh:
                # XLA's CPU tanh is a rational approximation, torch's
                # libm's: they part by an ulp of tanh (6e-8 below 1)
                np.testing.assert_allclose(N(fn(ts, *args)), f32(want),
                                           rtol=0, atol=6e-8)
            else:
                equal(fn(ts, *args), f32(want), f"{fn.__name__} at {s}")
    for decay in (None, "linear", "exp"):
        nz = C.NoiseConfig(type="fixed", decay=decay)
        jnz = JC.NoiseConfig(type="fixed", decay=decay)
        for it in (0, 3, 4096.0, 20000, torch.tensor(17.5)):
            jit = jnp.asarray(it.numpy()) if isinstance(it, torch.Tensor) \
                else it
            equal(torch.as_tensor(base.noise_std(nz, it)),
                  f32(jbase.noise_std(jnz, jit)), f"{decay} {it}")


# -------------------------------------------------------- the n-step window


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_push_and_fold_exact(n):
    """Seven pushes of an 6-env window with dones inside it (env 1 every
    other step, env 2 at step 1, env 4 at step 4): every folded output,
    `valid` and the window itself equal JAX's bit for bit."""
    rng = np.random.RandomState(n)
    En, D, A, gamma = 6, 5, 3, 0.99
    js = jnstep.NStepState.create(En, n, D, A)
    ts = nstep.NStepState.create(En, n, D, A, device="cpu")
    for i in range(7):
        obs, nobs = (rng.randn(En, D).astype(np.float32) for _ in range(2))
        act = rng.uniform(-1, 1, (En, A)).astype(np.float32)
        rew = rng.randn(En, 1).astype(np.float32)
        done = np.zeros((En, 1), bool)
        done[1] = i % 2 == 1
        done[2] = i == 1
        done[4] = i == 4
        js, jout = jnstep.push(js, jnp.asarray(obs), jnp.asarray(act),
                               jnp.asarray(rew), jnp.asarray(done),
                               jnp.asarray(nobs), gamma)
        ts, out = nstep.push(ts, T(obs), T(act), T(rew), T(done), T(nobs),
                             gamma)
        for got, want in zip(out, jout):
            equal(got, want, f"push {i}")
        for got, want in zip(ts, js):
            equal(got, want, f"window {i}")
    r, nobs_w, done_w = (rng.randn(En, n, 1).astype(np.float32),
                         rng.randn(En, n, D).astype(np.float32),
                         rng.rand(En, n, 1) < 0.3)
    want = jnstep.fold_window(jnp.asarray(r), jnp.asarray(done_w),
                              jnp.asarray(nobs_w), gamma)
    for got, w in zip(nstep.fold_window(T(r), T(done_w), T(nobs_w), gamma),
                      want):
        equal(got, w, "fold_window")


# ------------------------------------------------------------ flat replay


def _flat_pair(C_, D, A):
    return (jflat.FlatReplay.create(C_, D, A),
            flat.FlatReplay.create(C_, D, A, device="cpu"))


def test_flat_replay_add_sample_update_exact():
    """Adds of 8 rows into 20 (wrapping twice), one gated off by `valid`
    (rows written, ptr and size kept, as the JAX TD3's `_replace`), sample
    by JAX's indices and `update_target_action`: every table, ptr and size
    bit for bit."""
    rng = np.random.RandomState(0)
    D, A = 5, 3
    jb, tb = _flat_pair(20, D, A)
    for i in range(6):
        o, no = (rng.randn(8, D).astype(np.float32) for _ in range(2))
        a = rng.uniform(-1, 1, (8, A)).astype(np.float32)
        r = rng.randn(8).astype(np.float32)
        d = rng.rand(8) < 0.3
        valid = i != 2
        added = jflat.add(jb, *map(jnp.asarray, (o, a, r, no, d)))
        jb = added._replace(ptr=jnp.where(valid, added.ptr, jb.ptr),
                            size=jnp.where(valid, added.size, jb.size))
        flat.add(tb, T(o), T(a), T(r), T(no), T(d),
                 valid=torch.tensor(valid))
        for f in flat.FlatReplay._fields:
            equal(getattr(tb, f), getattr(jb, f), f"add {i}: {f}")
    (jbatch, jidx) = jflat.sample(jb, jax.random.PRNGKey(3), 12)
    batch, idx = flat.sample(tb, 12, idx=T(jidx))
    for got, want in zip(batch, jbatch):
        equal(got, want, "sample")
    new = rng.uniform(-1, 1, (12, A)).astype(np.float32)
    jb = jflat.update_target_action(jb, jidx, jnp.asarray(new))
    flat.update_target_action(tb, idx, T(new))
    equal(tb.target_action, jb.target_action, "update_target_action")
    drawn = flat.draw_indices(tb, 1000, torch.Generator().manual_seed(0))
    assert int(drawn.min()) >= 0 and int(drawn.max()) < int(tb.size)


# ---------------------------------------------------------------- models


def test_mlp_policies_and_double_q_match_jax():
    """`TanhMLPPolicy`, `TanhDiagGaussianMLPPolicy` (with `sample_logprob`
    on JAX's normal draw) and `DoubleQ` at stock widths, weights from the
    JAX package's init: 1e-5."""
    rng = np.random.RandomState(1)
    D, A, n = 29, 8, 64
    obs = rng.randn(n, D).astype(np.float32) * 2
    act = rng.uniform(-1, 1, (n, A)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    jpol = jmlp.TanhMLPPolicy(A)
    p = jpol.init(key, jnp.asarray(obs))
    pol = mlp.TanhMLPPolicy(D, A)
    convert.load_params(pol.parameters(), convert.mlp_policy_arrays(p))
    close(pol(T(obs)), jpol.apply(p, jnp.asarray(obs)), 1e-5, "TanhMLP")

    jg = jmlp.TanhDiagGaussianMLPPolicy(A)
    p = jg.init(key, jnp.asarray(obs))
    g = mlp.TanhDiagGaussianMLPPolicy(D, A)
    convert.load_params(g.parameters(), convert.mlp_policy_arrays(p))
    jmu, jls = jg.apply(p, jnp.asarray(obs))
    mu, ls = g(T(obs))
    close(mu, jmu, 1e-5, "mu")
    close(ls, jls, 1e-5, "log_std")
    k = jax.random.PRNGKey(5)
    ja, jlp = jmlp.TanhDiagGaussianMLPPolicy.sample_logprob(k, jmu, jls)
    a, lp = g.sample_logprob(mu, ls, noise=T(jax.random.normal(k, jmu.shape)))
    close(a, ja, 1e-5, "sample")
    # a sum over 8 actions of terms up to ~1e2 (|x| large where tanh
    # saturates): 1e-5 relative
    np.testing.assert_allclose(N(lp), np.asarray(jlp), rtol=1e-5, atol=1e-5)

    jq = jmlp.DoubleQ()
    p = jq.init(key, jnp.asarray(obs), jnp.asarray(act))
    q = mlp.DoubleQ(D, A)
    convert.load_params(q.parameters(), convert.double_q_arrays(p))
    for got, want in zip(q(T(obs), T(act)),
                         jq.apply(p, jnp.asarray(obs), jnp.asarray(act))):
        close(got, want, 1e-5, "DoubleQ")


def test_update_rms_matches_jax():
    """`update_rms` folds a batch by its central moments as JAX's does on
    one device, a channel with |mean| >> std included (the raw-moment
    form would cancel it to zero): 1e-6."""
    rng = np.random.RandomState(2)
    jr = jrs.RunningMeanStd.create((6,))
    tr = rs.RunningMeanStd.create((6,), device="cpu")
    for i in range(5):
        x = rng.randn(32, 6).astype(np.float32)
        x[:, 0] = 1e4 + x[:, 0] * 1e-2
        jr = jbase.update_rms(jr, jnp.asarray(x))
        tr = base.update_rms(tr, T(x))
        for got, want in zip(tr, jr):
            np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
    assert float(tr.var[0]) > 0


# ------------------------------------------------- update passes from JAX


def _cfg(mod, algo, env="antmaze-v1", **over):
    cfg = mod.Config(algo=mod.algo_preset(algo)).override(**{"env.name": env})
    return mod.preprocess(cfg, if_ddiffpg=False).override(**{
        "num_envs": E, "algo.batch_size": B, "algo.memory_size": CAP,
        "diffusion.update_times": 3, "diffusion.diffusion_iter": 3, **over})


def _moments(s, rng):
    """Adam states at a count of 3 with small random moments (from fresh
    moments Adam's first step is the gradient's sign, which float32 noise
    can flip on a near-zero gradient)."""
    if not hasattr(s, "mu"):
        return tuple(_moments(x, rng) for x in s) if isinstance(s, tuple) \
            else s
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return s._replace(
        mu=jax.tree.map(lambda x: f32(rng.randn(*x.shape) * 1e-3), s.mu),
        nu=jax.tree.map(lambda x: f32(rng.rand(*x.shape) * 1e-6), s.nu),
        count=jnp.full(s.count.shape, 3, jnp.int32))


def fill_core(core, rng):
    """A mid-training JAX TD3State core: 300 of 320 replay rows (sparse
    rewards, some dones, target actions apart from actions), the critic's
    target off its parameters, adam states at count 3 and, with obs_norm,
    an rms far from mean 0 and variance 1."""
    rep = core.replay
    D, A = rep.obs.shape[1], rep.action.shape[1]
    xy = lambda n: rng.uniform(-2, 10, (n, 2))  # noqa: E731
    obs = rng.randn(CAP, D).astype(np.float32) * 0.5
    nobs = rng.randn(CAP, D).astype(np.float32) * 0.5
    obs[:, :2], nobs[:, :2] = xy(CAP), xy(CAP)
    rep = rep._replace(
        obs=jnp.asarray(obs), next_obs=jnp.asarray(nobs),
        action=jnp.asarray(rng.uniform(-1, 1, (CAP, A)), jnp.float32),
        target_action=jnp.asarray(rng.uniform(-1, 1, (CAP, A)), jnp.float32),
        reward=jnp.asarray((rng.rand(CAP, 1) < 0.05) * 10.0, jnp.float32),
        done=jnp.asarray(rng.rand(CAP, 1) < 0.05),
        ptr=jnp.asarray(ROWS, jnp.int32), size=jnp.asarray(ROWS, jnp.int32))
    perturb = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: x * jnp.float32(1.03), tree)
    if core.obs_rms is not None:
        mean, var = rng.randn(D) * 0.3, rng.uniform(0.1, 0.5, D)
        mean[:2], var[:2] = rng.uniform(2, 6, 2), rng.uniform(8, 16, 2)
        core = core._replace(obs_rms=jrs.RunningMeanStd(
            mean=jnp.asarray(mean, jnp.float32),
            var=jnp.asarray(var, jnp.float32),
            count=jnp.asarray(3e4, jnp.float32)))
    return core._replace(
        replay=rep, critic_target=perturb(core.critic_params),
        actor_opt=_moments(core.actor_opt, rng),
        critic_opt=_moments(core.critic_opt, rng),
        intrinsic=core.intrinsic._replace(
            opt_state=_moments(core.intrinsic.opt_state, rng)))


def jax_agent(algo, env="antmaze-v1", **over):
    cfg = _cfg(JC, algo, env, **over)
    kw = {"random_init": True} if env.startswith("antmaze") else {}
    return jax_make_agent(cfg.algo.name, jax_make(env, num_envs=E, **kw), cfg)


def port_agent(algo, env="antmaze-v1", **over):
    kw = {"random_init": True} if env.startswith("antmaze") else {}
    e = make(env, num_envs=E, device="cpu", **kw)
    return make_agent(_cfg(C, algo, env, **over).algo.name, e,
                      _cfg(C, algo, env, **over), device="cpu")


def jax_td3_draws(jts, key, A, K=None):
    """The draws of the JAX TD3/DIPO/DiffQ `_update_once(ts, key)`,
    rebuilt from its keys (agents/td3.py:176-215, dipo.py:46-99); DIPO's
    `DiffusionPolicy.act`/`loss` and DiffQ's `Diffusion.sample`/`loss`
    split their keys alike."""
    k_samp, k_cri, _, k_loss = jax.random.split(key, 4)
    size = int(jts.replay.size)
    idx = jax.random.randint(k_samp, (B,), 0, max(size, 1))
    _, k_tgt = jax.random.split(k_cri)
    k1, k2 = jax.random.split(k_tgt)
    target = base.TargetDraws(None, None, T(jax.random.normal(k2, (B, A))))
    if K is None:
        return UpdateDraws(idx=T(idx), target=target)
    k_init, k_scan = jax.random.split(k1)
    steps = [T(jax.random.normal(k, (B, A)))
             for k in jax.random.split(k_scan, K)]
    target = target._replace(x_init=T(jax.random.normal(k_init, (B, A))),
                             step_noise=torch.stack(steps))
    kn, kt = jax.random.split(k_loss)
    return UpdateDraws(idx=T(idx), target=target,
                       loss_noise=T(jax.random.normal(kn, (B, A))),
                       loss_t=T(jax.random.randint(kt, (B,), 0, K)))


def check_core(core, want, actor_fn, critic_fn):
    """Parameters, targets and adam states (1e-5; counts exact) of a
    port core against the JAX core after one pass."""
    for mod, tree in ((core.actor, want.actor_params),
                      (core.actor_target, want.actor_target)):
        for got, w in zip(mod.parameters(), actor_fn(tree)):
            close(got, w, 1e-5, "actor")
    for mod, tree in ((core.critic, want.critic_params),
                      (core.critic_target, want.critic_target)):
        for got, w in zip(mod.params(), critic_fn(tree)):
            close(got, w, 1e-5, "critic")
    for got, w in zip(core.intrinsic.net.params(),
                      convert.rnd_arrays(want.intrinsic.params)):
        close(got, w, 1e-5, "RND")
    for got, w, fn in ((core.actor_opt, want.actor_opt, actor_fn),
                       (core.critic_opt, want.critic_opt, critic_fn),
                       (core.intrinsic.opt_state, want.intrinsic.opt_state,
                        convert.rnd_arrays)):
        w = convert.find_adam(w)
        for x, y in zip(got.mu + got.nu, fn(w.mu) + fn(w.nu)):
            close(x, y, 1e-5, "adam moments")
        equal(got.count, w.count, "adam count")
    equal(core.intrinsic.update_step, want.intrinsic.update_step)


def check_logs(logs, jlogs):
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def check_rms(ts, want):
    """The pass leaves obs_rms as it was, as JAX's does (exact)."""
    assert (ts.obs_rms is None) == (want.obs_rms is None)
    for got, w in zip(ts.obs_rms or (), want.obs_rms or ()):
        equal(got, w, "obs_rms")


@pytest.mark.parametrize("obs_norm", [False, True])
def test_td3_update_once_matches_jax(obs_norm):
    """With obs_norm the intrinsic reward sees raw obs, and the critic,
    RND and actor normalised obs, as in JAX."""
    over = {"algo.obs_norm": obs_norm}
    jagent = jax_agent("td3", **over)
    jts = fill_core(jagent.init(jax.random.PRNGKey(0)),
                    np.random.RandomState(0))
    agent = port_agent("td3", **over)
    ts = convert.td3_state(agent, jax.tree.map(np.asarray, jts))
    key = jax.random.PRNGKey(11)
    jts2, jlogs = jax.jit(jagent._update_once)(jts, key)
    ts, logs = agent.update_once(ts, jax_td3_draws(jts, key,
                                                   agent.action_dim))
    want = jax.tree.map(np.asarray, jts2)
    check_core(ts, want, convert.mlp_policy_arrays,
               convert.one_row_critic_arrays)
    check_rms(ts, want)
    for f in flat.FlatReplay._fields:
        equal(getattr(ts.replay, f), getattr(want.replay, f), f)
    check_logs(logs, jlogs)


@pytest.mark.parametrize("obs_norm", [False, True])
def test_sac_update_once_matches_jax(obs_norm):
    """SAC from a converted `SACState` with log_alpha at 0.3 and alpha's
    adam at count 3: TD3's fields as TD3's, log_alpha and its moments
    1e-5; with obs_norm as TD3's."""
    over = {"algo.obs_norm": obs_norm}
    jagent = jax_agent("sac", **over)
    jts = jagent.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    jts = jts._replace(core=fill_core(jts.core, rng),
                       log_alpha=jnp.float32(0.3),
                       alpha_opt=_moments(jts.alpha_opt, rng))
    agent = port_agent("sac", **over)
    ts = convert.sac_state(agent, jax.tree.map(np.asarray, jts))
    key = jax.random.PRNGKey(12)
    jts2, jlogs = jax.jit(jagent._update_once)(jts, key)
    k_samp, k_next, k_pi, _ = jax.random.split(key, 4)
    A = agent.action_dim
    draws = UpdateDraws(
        idx=T(jax.random.randint(k_samp, (B,), 0, ROWS)),
        next_noise=T(jax.random.normal(k_next, (B, A))),
        pi_noise=T(jax.random.normal(k_pi, (B, A))))
    ts, logs = agent.update_once(ts, draws)
    want = jax.tree.map(np.asarray, jts2)
    check_core(ts, want.core, convert.mlp_policy_arrays,
               convert.double_q_arrays)
    check_rms(ts, want.core)
    close(ts.log_alpha, want.log_alpha, 1e-5, "log_alpha")
    wa = convert.find_adam(want.alpha_opt)
    close(ts.alpha_opt.mu[0], wa.mu, 1e-5)
    close(ts.alpha_opt.nu[0], wa.nu, 1e-5)
    equal(ts.alpha_opt.count, wa.count)
    assert float(ts.log_alpha) != 0.3
    check_logs(logs, jlogs)


# ------------------------------------------------------------ an env step


@pytest.mark.parametrize("random,n", [(True, 1), (False, 3)])
def test_td3_env_step_rows_match_jax(random, n):
    """One TD3 `_env_step` on pointmaze-v1 from a converted JAX state:
    envs at t = 99 time out (the handle-timeout XOR), the window holds
    dones, the flat replay wraps (ptr 60 of 64), and at n = 3 the first
    pushes leave ptr and size where they were while writing rows. The
    port's env step stays within 1e-5 of JAX's; given JAX's outputs, the
    replay rows, window, pointers and stats are bit for bit JAX's (the
    action column 1e-5 off a policy action)."""
    over = {"algo.nstep": n, "algo.memory_size": 64}
    jagent = jax_agent("td3", "pointmaze-v1", **over)
    jts = jagent.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(n)
    es = jts.env_state
    jts = jts._replace(
        env_state=es._replace(t=jnp.asarray([99, 3, 99, 50], jnp.int32)),
        replay=jts.replay._replace(ptr=jnp.asarray(62, jnp.int32),
                                   size=jnp.asarray(62, jnp.int32)),
        nstep=jts.nstep._replace(
            done=jnp.asarray(rng.rand(*jts.nstep.done.shape) < 0.4),
            reward=jnp.asarray(rng.randn(*jts.nstep.reward.shape),
                               jnp.float32),
            count=jnp.asarray(1, jnp.int32)))
    agent = port_agent("td3", "pointmaze-v1", **over)
    ts = convert.td3_state(agent, jax.tree.map(np.asarray, jts))
    _, k_act, k_rand = jax.random.split(jts.key, 3)
    A = agent.action_dim
    if random:
        ja = jax.random.uniform(k_rand, (E, A), minval=-1.0, maxval=1.0)
        draws = EnvDraws(uniform=T(ja))
    else:
        _, k2 = jax.random.split(k_act)
        draws = EnvDraws(policy=base.TargetDraws(
            None, None, T(jax.random.normal(k2, (E, A)))))
    jts2 = jax.jit(jagent._env_step, static_argnums=1)(jts, random)
    # JAX's env outputs for the action JAX took (the same one when random):
    # the next obs from the jitted step itself (an eager step may round
    # another way), the rest discrete
    _, _, jrew, jdone, jinfo = jagent.env.step(
        jts.env_state, jts2.nstep.action[:, -1])
    jobs = jts2.obs
    real_step = agent.env.step

    def step(state, action):
        out = real_step(state, action)
        close(out[1], jobs, 1e-5, "env obs")
        equal(out[2], jrew)
        equal(out[3], jdone)
        return (out[0], T(jobs), T(jrew), T(jdone),
                {k: T(v) for k, v in jinfo.items()})

    agent.env.step = step
    ts = agent._env_step(ts, random, draws)
    want = jax.tree.map(np.asarray, jts2)
    assert bool(np.asarray(jinfo["time_outs"]).any())
    for f in flat.FlatReplay._fields:
        got, w = getattr(ts.replay, f), getattr(want.replay, f)
        if random or f not in ("action", "target_action"):
            equal(got, w, f)
        else:
            close(got, w, 1e-5, f)
    for f in nstep.NStepState._fields:
        got, w = getattr(ts.nstep, f), getattr(want.nstep, f)
        if random or f != "action":
            equal(got, w, f)
        else:
            close(got, w, 1e-5, f)
    equal(ts.global_step, want.global_step)
    equal(ts.stats.current_returns, want.stats.current_returns)
    equal(ts.stats.return_tracker.buf, want.stats.return_tracker.buf)
    assert (int(want.replay.ptr) != 62) == (n == 1)


# -------------------------------------------------------------- obs_norm


@pytest.mark.parametrize("algo", ["td3", "sac", "dipo", "diffq", "ddiffpg"])
def test_obs_norm_every_agent(algo):
    """With `algo.obs_norm` every agent folds the obs of each env step
    (warm-up included) into its rms before acting, as JAX's `update_rms`
    folds the same batches (1e-6), trains finitely, and its eval policy
    acts on the normalised obs (JAX's test_agents_obs_norm)."""
    over = {"algo.obs_norm": True, "algo.warm_up": 6, "algo.update_times": 1,
            "num_envs": 8, "env.resolution": 255, "intrinsic.L": 4,
            "algo.batch_size": 64, "diffusion.update_times": 3,
            "diffusion.diffusion_iter": 3,
            "algo.memory_size": 32 if algo == "ddiffpg" else 400}
    cfg = C.Config(algo=C.algo_preset(algo)).override(
        **{"env.name": "pointmaze-v1", **over})
    env = make("pointmaze-v1", num_envs=8, device="cpu")
    agent = make_agent(cfg.algo.name, env, cfg, device="cpu")
    ts = agent.init()
    seen, env_step = [], agent._env_step

    def recording_env_step(ts, *a, **k):
        seen.append(N(ts.obs))
        return env_step(ts, *a, **k)

    agent._env_step = recording_env_step
    ts = agent.warmup(ts)
    for _ in range(2):
        ts, logs = agent.train_iter(ts, 0)
    assert all(np.isfinite(float(v)) for v in logs.values())
    jr = jrs.RunningMeanStd.create((env.obs_dim,))
    for x in seen:
        jr = jbase.update_rms(jr, jnp.asarray(x))
    assert len(seen) == 6 + 2
    for got, want in zip(ts.obs_rms, jr):
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert float(ts.obs_rms.count) > 1.0
    assert float(ts.obs_rms.mean.abs().max()) > 0.0

    obs = torch.randn(4, env.obs_dim, generator=torch.Generator()
                      .manual_seed(0))
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    got = agent.eval_actor(ts, obs, generator=g())
    n_obs = rs.normalize(ts.obs_rms, obs)
    if algo == "ddiffpg":
        want = ts.actor.act(torch.cat([n_obs, torch.zeros(4, 5)], -1),
                            generator=g())
    else:
        want = ts.actor.act(n_obs, generator=g())
    assert torch.equal(got, want)


# ------------------------------------------------------------- the loop


def test_light_checkpoint_skips_nested_replay(tmp_path):
    """SAC's state is TD3's plus log_alpha and its optimizer: a light save
    leaves `replay` out and keeps log_alpha, and its load keeps the
    example state's fresh replay."""
    agent = port_agent("sac", "pointmaze-v1", **{"algo.memory_size": 64,
                                                  "algo.warm_up": 4})
    ts = agent.warmup(agent.init())
    nbytes = ckpt.save(tmp_path / "light.pt", ts, {},
                       skip=("replay",))
    blob = torch.load(tmp_path / "light.pt", weights_only=False)
    assert nbytes > 0 and blob["host_meta"]["light"]
    assert not any(k.startswith("replay.") for k in blob["tensors"])
    assert "log_alpha" in blob["tensors"]
    fresh, _ = ckpt.load(tmp_path / "light.pt", agent.init())
    assert int(fresh.replay.size) == 0
    assert torch.equal(fresh.obs, ts.obs)
    assert torch.equal(fresh.log_alpha, ts.log_alpha)


TINY = ["device=cpu", "env.name=pointmaze-v1", "num_envs=8",
        "eval_num_envs=4", "algo.warm_up=8", "algo.batch_size=64",
        "algo.update_times=1", "algo.memory_size=400", "intrinsic.L=2",
        "eval_freq=1", "ckpt_freq_mult=1", "log_freq=1"]


def run_main(algo, tmp_path):
    """`train.main` for `algo` on the CPU: warm-up, 2 iterations, an eval
    each, a light checkpoint at the second, the final full one; then the
    final checkpoint into a fresh state. Returns (final state, fresh
    state, the run's checkpoint names, its metrics records)."""
    ts = train.main([f"algo={algo}", *TINY, "max_step=80",
                     f"logdir={tmp_path}", "run_name=tiny"])
    run = tmp_path / "tiny"
    cfg = C.Config(algo=C.algo_preset(algo)).override_strings(TINY)
    cfg = C.preprocess(cfg, if_ddiffpg=False).override_strings(TINY)
    env, _ = train.make_envs(cfg, torch.device("cpu"))
    fresh, meta = ckpt.load(run / "ckpt_final.pt",
                            make_agent(cfg.algo.name, env, cfg,
                                       device="cpu").init())
    names = sorted(p.name for p in run.glob("ckpt_*.pt"))
    recs = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    return ts, fresh, names, recs


def assert_reloaded(ts, fresh):
    got, want = dict(ckpt.leaves(fresh)), dict(ckpt.leaves(ts))
    assert set(got) == set(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


def test_train_main_td3(tmp_path):
    ts, fresh, names, recs = run_main("td3", tmp_path)
    # warm-up 8 x 8 steps, then 8 an iteration: evals at 64 and 72, the
    # light checkpoint at the second, the final full one at 80
    assert names == ["ckpt_72.pt", "ckpt_final.pt"]
    assert int(ts.global_step) == 80 and int(ts.replay.size) == 80
    evals = [r for r in recs if "eval/return" in r]
    assert len(evals) == 2 and all(np.isfinite(r["eval/return"])
                                   for r in evals)
    light = torch.load(tmp_path / "tiny" / "ckpt_72.pt", weights_only=False)
    assert not any(k.startswith("replay.") for k in light["tensors"])
    assert "time/ckpt_light_bytes" in set().union(*recs)
    assert_reloaded(ts, fresh)
    assert dataclasses.is_dataclass(ts)
