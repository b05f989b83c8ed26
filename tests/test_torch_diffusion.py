"""The port's acting ops against the JAX package: DDPM tables and steps,
DiffusionNet with converted parameters, DiffusionPolicy.act with JAX's own
draws fed in, mode-embedding mixing and the exploration noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.models.diffusion import \
    DiffusionPolicy as JaxPolicy  # noqa: E402
from ddiffpg_tpu.ops import ddpm as jddpm  # noqa: E402
from ddiffpg_tpu.ops import embedding as jemb  # noqa: E402
from ddiffpg_tpu.ops import noise as jnoise  # noqa: E402
from ddiffpg_tpu_torch.models.diffusion import (DiffusionPolicy,  # noqa: E402
                                                lecun_normal_)
from ddiffpg_tpu_torch.ops import ddpm, embedding, noise  # noqa: E402
from ddiffpg_tpu_torch.utils.convert import load_diffusion  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

A, OBS, EMB, K = 8, 29, 5, 5


def _jax_policy(B=16, seed=0):
    actor = JaxPolicy(action_dim=A, diffusion_iter=K)
    params = actor.init(jax.random.PRNGKey(seed), jnp.zeros((1, A)),
                        jnp.zeros((1,)), jnp.zeros((1, OBS + EMB)))
    port = DiffusionPolicy(A, OBS + EMB, K, device="cpu")
    load_diffusion(port, jax.tree.map(np.asarray, params))
    return actor, params, port


def test_policy_defaults_to_card():
    """Built with no device, the policy and its DDPM tables belong on the
    card: where there is none they raise, and nothing is quietly built on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DiffusionPolicy(A, OBS + EMB, K)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ddpm.make_tables(K)


@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "linear", "vp"])
def test_ddpm_tables(schedule):
    """Same float64 schedule rounded once to float32: exact."""
    want = jddpm.make_tables(K, schedule)
    got = ddpm.make_tables(K, schedule, device="cpu")
    for f in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_ddpm_add_noise_and_step():
    """Forward noising and each reverse step t = K-1..0, float32: 1e-6."""
    rng = np.random.RandomState(0)
    x0, eps, nz, xt = (rng.randn(16, A).astype(np.float32) for _ in range(4))
    t = rng.randint(0, K, 16)
    jt, pt = jddpm.make_tables(K), ddpm.make_tables(K, device="cpu")
    np.testing.assert_allclose(
        ddpm.add_noise(pt, torch.tensor(x0), torch.tensor(nz),
                       torch.tensor(t)).numpy(),
        np.asarray(jddpm.add_noise(jt, x0, nz, jnp.asarray(t))), atol=1e-6)
    for step_t in range(K):
        want = jddpm.step(jt, jnp.asarray(eps), jnp.asarray(step_t),
                          jnp.asarray(xt), jnp.asarray(nz))
        got = ddpm.step(pt, torch.tensor(eps), step_t, torch.tensor(xt),
                        torch.tensor(nz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_diffusion_net_forward_converted():
    """eps prediction at stock widths with the JAX parameters converted:
    float32 matmuls summed in another order, 2e-5."""
    actor, params, port = _jax_policy()
    rng = np.random.RandomState(1)
    x = rng.randn(16, A).astype(np.float32)
    t = rng.randint(0, K, 16).astype(np.float32)
    cond = rng.randn(16, OBS + EMB).astype(np.float32)
    want = actor.apply(params, x, t, cond)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), torch.tensor(cond))
    assert [tuple(layer.weight.shape) for layer in port.net.dense] == [
        (1024, 256), (256, 1024), (1024, 298), (512, 1024), (256, 512),
        (8, 256)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_act_with_jax_draws():
    """K=5 reverse denoise, B=16, JAX's own normal draws fed in: 2e-5."""
    actor, params, port = _jax_policy()
    B = 16
    cond = np.random.RandomState(2).randn(B, OBS + EMB).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = actor.apply(params, key, jnp.asarray(cond),
                       method=JaxPolicy.act)
    k_init, k_scan = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(k_init, (B, A)))
    steps = np.stack([np.asarray(jax.random.normal(k, (B, A)))
                      for k in jax.random.split(k_scan, K)])
    got = port.act(torch.tensor(cond), x_init=torch.tensor(x_init),
                   noise=torch.tensor(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert float(got.abs().max()) <= 1.0 + 1e-6


def test_lecun_init_statistics():
    """flax Dense's law: truncated at 2 sigma, variance 1/fan_in."""
    w = torch.empty(1024, 512)
    lecun_normal_(w, torch.Generator().manual_seed(0))
    std = np.sqrt(1.0 / 512) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / np.sqrt(1.0 / 512) - 1.0) < 0.02


@pytest.mark.parametrize("num_modes,p", [(3, 0.5), (1, 0.7), (4, 1.0),
                                         (0, 0.5), (0, 0.0)])
def test_add_embedding(num_modes, p):
    """Both branches; the no-modes branch gets JAX's permutation mask.
    Pure selection, so exact."""
    N = 16
    rng = np.random.RandomState(3)
    obs = rng.randn(N, OBS).astype(np.float32)
    table = rng.randn(11, EMB).astype(np.float32)
    key = jax.random.PRNGKey(num_modes)
    want = jemb.add_embedding(key, jnp.asarray(obs), jnp.asarray(table[0]), p,
                              jnp.asarray(table[1:]), num_modes)
    s = int(np.floor(N * np.float32(p)))
    mask = np.asarray(jax.random.permutation(key, jnp.arange(N) < s))
    got = embedding.add_embedding(
        torch.tensor(obs), torch.tensor(table[0]), p, torch.tensor(table[1:]),
        torch.tensor(num_modes), zero_mask=torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        embedding.append_embedding(torch.tensor(obs),
                                   torch.tensor(table[0])).numpy(),
        np.asarray(jemb.append_embedding(jnp.asarray(obs),
                                         jnp.asarray(table[0]))))


def test_add_embedding_draws_its_mask():
    N, p = 64, 0.25
    g = torch.Generator().manual_seed(0)
    out = embedding.add_embedding(torch.zeros(N, 3), torch.ones(EMB), p,
                                  generator=g)
    zero_rows = (out[:, 3:] == 0).all(dim=1)
    assert int(zero_rows.sum()) == int(N * p)


def test_mixed_normal_noise():
    """std linspace across the env batch in float32, JAX's draw fed in:
    1e-6 (the two linspaces round differently in the last bit)."""
    x = np.random.RandomState(4).uniform(-1, 1, (64, A)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jnoise.add_mixed_normal_noise(key, jnp.asarray(x), 0.05, 0.6,
                                         out_bounds=(-1, 1))
    draw = np.asarray(jax.random.normal(key, x.shape))
    got = noise.add_mixed_normal_noise(torch.tensor(x), 0.05, 0.6,
                                       out_bounds=(-1, 1),
                                       noise=torch.tensor(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jnoise.add_normal_noise(key, jnp.asarray(x), 0.3,
                                   noise_bounds=(-0.5, 0.5))
    got = noise.add_normal_noise(torch.tensor(x), 0.3,
                                 noise_bounds=(-0.5, 0.5),
                                 noise=torch.tensor(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
