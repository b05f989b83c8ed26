"""The rest of the port's model zoo against the JAX package on the CPU.

Each model is built in both packages, the JAX params are carried across by
`utils/convert.py:model_arrays`, and seeded numpy inputs go through both:
`DiagGaussianMLPPolicy` (its `sample` on JAX's normal draw),
`DistributionalEnsembleQ` (and `q_mean`), `MLPCritic`, `DynamicModel`
(and `disagreement_reward`, the unbiased variance), `MLPResNet` (flax's
LayerNorm epsilon), `EBMDiffusionPolicy` (the score against `jax.grad`,
`logprob`, and `entropy` with JAX's sampler draws), `Consistency`
(`sample` and `loss` with JAX's draws), and `ema_update`. Tolerances:
1e-5 absolute on float32 MLP outputs of order one (sums of a few hundred
products in another order); the EBM's score, log-probs and entropy, which
differentiate or exponentiate those outputs, 1e-4 relative; `ema_update`
1e-7 (one multiply-add per element). `get_model` resolves every name of
the JAX registry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu import models as jmodels  # noqa: E402
from ddiffpg_tpu.models import baseline_diffusion as jbd  # noqa: E402
from ddiffpg_tpu.models import diffusion as jdiff  # noqa: E402
from ddiffpg_tpu.models import mlp as jmlp  # noqa: E402
from ddiffpg_tpu.utils.ema import ema_update as jax_ema  # noqa: E402
from ddiffpg_tpu_torch import models  # noqa: E402
from ddiffpg_tpu_torch.models import baseline_diffusion as bd  # noqa: E402
from ddiffpg_tpu_torch.models import diffusion, mlp  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from ddiffpg_tpu_torch.utils.ema import ema_update  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

B, D, A = 8, 29, 8
KEY = jax.random.PRNGKey(0)
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
N = lambda x: x.detach().cpu().numpy()  # noqa: E731


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, D).astype(np.float32),
            rng.uniform(-1, 1, (B, A)).astype(np.float32))


def close(got, want, atol=0.0, rtol=0.0, msg=""):
    np.testing.assert_allclose(N(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def jinit(module, key, *args, **kw):
    """`module.init` jitted (eager flax init compiles op by op, ~5x
    slower here)."""
    return jax.jit(functools.partial(module.init, **kw))(key, *args)


def japply(module, params, *args, **kw):
    return jax.jit(functools.partial(module.apply, **kw))(params, *args)


def converted(name, jparams, module):
    convert.load_params(module.parameters(),
                        convert.model_arrays(name, jparams))
    return module


def test_get_model_resolves_every_jax_name():
    names = sorted(jmodels._REGISTRY)
    assert len(names) == 17
    for name in names:
        assert models.get_model(name).__name__ == name
    with pytest.raises(KeyError, match="unknown model"):
        models.get_model("NoSuchNet")


def test_diag_gaussian_policy():
    obs, _ = inputs(1)
    jnet = jmlp.DiagGaussianMLPPolicy(action_dim=A, init_log_std=-0.5)
    p = jinit(jnet, KEY, jnp.asarray(obs))
    # a logstd that differs per dimension
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.linspace(-0.3, 0.3, A)
        if path[-1].key == "logstd" else x, p)
    net = converted("DiagGaussianMLPPolicy", p,
                    mlp.DiagGaussianMLPPolicy(D, A, init_log_std=-0.5))
    jmean, jls = japply(jnet, p, jnp.asarray(obs))
    mean, ls = net(T(obs))
    close(mean, jmean, 1e-5)
    close(ls, jls, 0.0)
    k = jax.random.PRNGKey(3)
    want = jmlp.DiagGaussianMLPPolicy.sample(k, jmean, jls)
    draw = T(jax.random.normal(k, jmean.shape))
    close(mlp.DiagGaussianMLPPolicy.sample(mean, ls, noise=draw), want, 1e-5)


def test_ensemble_q_critic_and_dynamics():
    obs, act = inputs(2)
    o, a = jnp.asarray(obs), jnp.asarray(act)
    jq = jmlp.DistributionalEnsembleQ(v_min=-3.0, v_max=7.0, num_atoms=21,
                                      n_ensemble=3)
    p = jinit(jq, KEY, o, a)
    q = converted("DistributionalEnsembleQ", p, mlp.DistributionalEnsembleQ(
        D, A, v_min=-3.0, v_max=7.0, num_atoms=21, n_ensemble=3))
    got = q(T(obs), T(act))
    assert got.shape == (3, B, 21)
    close(got, japply(jq, p, o, a), 1e-6)
    close(q.q_mean(T(obs), T(act)), japply(
        jq, p, o, a, method=jmlp.DistributionalEnsembleQ.q_mean), 1e-5)

    jc = jmlp.MLPCritic()
    pc = jinit(jc, jax.random.PRNGKey(1), o)
    c = converted("MLPCritic", pc, mlp.MLPCritic(D))
    close(c(T(obs)), japply(jc, pc, o), 1e-5)

    jd = jmlp.DynamicModel(obs_dim=D, n_ensemble=4)
    pd = jinit(jd, jax.random.PRNGKey(2), o, a)
    dyn = converted("DynamicModel", pd, mlp.DynamicModel(D, A, n_ensemble=4))
    close(dyn(T(obs), T(act)), japply(jd, pd, o, a), 1e-5)
    r = dyn.disagreement_reward(T(obs), T(act))
    want = japply(jd, pd, o, a,
                  method=jmlp.DynamicModel.disagreement_reward)
    close(r, want, 1e-6, 1e-5)
    # the unbiased variance: a biased one would be 3/4 of it
    assert not np.allclose(N(r), np.asarray(want) * 0.75, rtol=1e-3)


def test_mlp_resnet():
    obs, _ = inputs(3)
    jn = jdiff.MLPResNet(out_dim=A, num_blocks=3, hidden_dim=64)
    p = jinit(jn, KEY, jnp.asarray(obs))
    # LayerNorm scales and biases away from their 1 / 0 init
    rng = np.random.RandomState(10)
    p = jax.tree.map(lambda x: x + 0.1 * rng.randn(*x.shape).astype(
        np.float32), p)
    net = converted("MLPResNet", p, diffusion.MLPResNet(D, A, 3, 64))
    close(net(T(obs)), japply(jn, p, jnp.asarray(obs)), 1e-5)


@pytest.fixture(scope="module")
def ebm():
    """The JAX EBM policy at K = 3, its params, the port's converted one,
    and cond, x, t inputs."""
    K = 3
    rng = np.random.RandomState(4)
    cond = rng.randn(B, D).astype(np.float32)
    x = rng.uniform(-1, 1, (B, A)).astype(np.float32)
    t = np.full((B,), 1.0, np.float32)
    jm = jdiff.EBMDiffusionPolicy(action_dim=A, diffusion_iter=K)
    p = jinit(jm, KEY, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
              method=jdiff.EBMDiffusionPolicy.neg_logp_unnorm)
    m = converted("EBMDiffusionPolicy", p, diffusion.EBMDiffusionPolicy(
        A, D, K, device="cpu"))
    return jm, p, m, cond, x, t


def test_ebm_score_is_the_energy_gradient(ebm):
    jm, p, m, cond, x, t = ebm
    want = japply(jm, p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = m(T(x), T(t), T(cond))
    close(got, want, 1e-5, 1e-4)
    # the graph is kept: a loss on the score trains the net
    grads = torch.autograd.grad(got.pow(2).sum(), list(m.net.parameters()))
    assert all(bool(g.abs().sum() > 0) for g in grads)


def test_ebm_logprob_and_entropy(ebm):
    jm, p, m, cond, x, t = ebm
    buf = np.random.RandomState(5).uniform(-1, 1, (6, A)).astype(np.float32)
    want = japply(jm, p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                  jnp.asarray(buf), method=jdiff.EBMDiffusionPolicy.logprob)
    got = m.logprob(T(x), T(t), T(cond), T(buf))
    close(got, want, 1e-4, 1e-4)

    n_act, K = 5, 3
    logz = np.linspace(-1, 1, B).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = japply(jm, p, key, jnp.asarray(cond), jnp.asarray(logz),
                  method=jdiff.EBMDiffusionPolicy.entropy, num_action=n_act)
    k_init, k_scan = jax.random.split(key)
    shape = (B * n_act, A)
    x_init = T(jax.random.normal(k_init, shape))
    steps = T(np.stack([np.asarray(jax.random.normal(k, shape))
                        for k in jax.random.split(k_scan, K)]))
    got = m.entropy(T(cond), T(logz), n_act, x_init=x_init, noise=steps)
    close(got, want, 1e-4, 1e-4)


def test_consistency_sample_and_loss():
    rng = np.random.RandomState(7)
    st = rng.randn(B, D).astype(np.float32)
    act = rng.uniform(-1, 1, (B, A)).astype(np.float32)
    jm = jbd.Consistency(action_dim=A)
    p = jinit(jm, KEY, jnp.asarray(st), KEY)
    m = converted("Consistency", p, bd.Consistency(A, D, device="cpu"))
    # the noise levels, built in float32 like the JAX table
    jts = japply(jm, p, method=lambda mod: mod.ts)
    assert m.ts.dtype == torch.float32
    close(m.ts, jts, 0.0, 1e-6)

    key = jax.random.PRNGKey(8)
    want = japply(jm, p, jnp.asarray(st), key)
    got = m.sample(T(st), noise=T(jax.random.normal(key, (B, A))))
    close(got, want, 1e-5)

    want = japply(jm, p, key, jnp.asarray(st), jnp.asarray(act),
                  method=jbd.Consistency.loss)
    kt, kn = jax.random.split(key)
    idx = T(jax.random.randint(kt, (B,), 1, 6)).long()
    z = T(jax.random.normal(kn, (B, A)))
    loss = m.loss(T(st), T(act), idx=idx, noise=z)
    close(loss, want, 0.0, 1e-4)
    loss.backward()
    assert all(q.grad is not None for q in m.parameters())


def test_ema_update_in_place():
    rng = np.random.RandomState(9)
    e = [rng.randn(5, 3).astype(np.float32), rng.randn(4).astype(np.float32)]
    n = [rng.randn(5, 3).astype(np.float32), rng.randn(4).astype(np.float32)]
    want = jax_ema([jnp.asarray(x) for x in e], [jnp.asarray(x) for x in n],
                   beta=0.9)
    got = [T(x) for x in e]
    assert ema_update(got, [T(x) for x in n], beta=0.9) is got
    for g, w in zip(got, want):
        close(g, w, 1e-7)
    # two modules: the parameters in `parameters()` order
    a, b = mlp.MLPCritic(3, (4,)), mlp.MLPCritic(3, (4,))
    before = [q.detach().clone() for q in a.parameters()]
    ema_update(a, b, beta=0.5)
    for q, q0, qb in zip(a.parameters(), before, b.parameters()):
        torch.testing.assert_close(q, 0.5 * q0 + 0.5 * qb, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="tensors"):
        ema_update([T(e[0])], [])
