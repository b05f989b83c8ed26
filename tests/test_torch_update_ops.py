"""The port's update-pass ops against the JAX package: the optax chains,
the C51 projection and BCE, the positional encoding, running stats, the
episode trackers, the stacked critics and the action gradient, the DDPM
loss and NovelD/RND, on the same numpy-made inputs with JAX's draws fed
in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.agents import base as jbase  # noqa: E402
from ddiffpg_tpu.intrinsic import IntrinsicModule as JaxIntrinsic  # noqa: E402
from ddiffpg_tpu.models.diffusion import \
    DiffusionPolicy as JaxPolicy  # noqa: E402
from ddiffpg_tpu.models.mlp import \
    DistributionalDoubleQ as JaxCritic  # noqa: E402
from ddiffpg_tpu.ops import distributional as jdist  # noqa: E402
from ddiffpg_tpu.ops import posenc as jposenc  # noqa: E402
from ddiffpg_tpu.ops import running_stats as jrs  # noqa: E402
from ddiffpg_tpu_torch.agents import base  # noqa: E402
from ddiffpg_tpu_torch.intrinsic import IntrinsicModule  # noqa: E402
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy  # noqa: E402
from ddiffpg_tpu_torch.models.mlp import (DistributionalDoubleQ,  # noqa: E402
                                          q_min)
from ddiffpg_tpu_torch.ops import distributional, optim  # noqa: E402
from ddiffpg_tpu_torch.ops import running_stats as rs  # noqa: E402
from ddiffpg_tpu_torch.ops.posenc import posenc  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

OBS, A, ATOMS = 29, 8, 51
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


def _tree(rng, rows=()):
    shapes = {"w": (5, 3), "b": (3,), "v": (4,)}
    return {k: rng.randn(*rows, *s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("count", [0, 3])
@pytest.mark.parametrize("clip", [False, True])
def test_optimizer_chain_one_step(decay, count, clip):
    """One step of clip_by_global_norm(1) then adamw(lr) (or adam(lr,
    eps=1e-5)) on identical gradients, from zero moments at count 0 or
    from random moments at count 3, with the clip idle (norm < 1) and
    active. Parameters after one Adam step: 1e-6 abs on values ~1 (float32
    elementwise math in optax's order; pow and sqrt may differ by an ulp).
    The returned norm is the pre-clip one."""
    rng = np.random.RandomState(count * 2 + clip)
    params, grads = _tree(rng), _tree(rng)
    scale = 3.0 if clip else 0.05
    grads = {k: v * scale for k, v in grads.items()}
    tx = jbase.make_optimizer(1e-2, 1.0, weight_decay=decay)
    jstate = tx.init(jax.tree.map(jnp.asarray, params))
    if count:
        adam = jstate[1][0]._replace(
            count=jnp.asarray(count, jnp.int32),
            mu={k: jnp.asarray(rng.randn(*v.shape) * 0.1, jnp.float32)
                for k, v in params.items()},
            nu={k: jnp.asarray(rng.rand(*v.shape) * 0.1, jnp.float32)
                for k, v in params.items()})
        jstate = (jstate[0], (adam,) + tuple(jstate[1][1:]))
    jp, jstate2, jn = jbase.apply_update(tx, params, jstate, grads)

    keys = sorted(params)
    arr = lambda tree: [np.asarray(tree[k]) for k in keys]  # noqa: E731
    p = [T(x) for x in arr(params)]
    state = convert.adam_state(jstate, arr)
    spec = optim.make_optimizer(1e-2, 1.0, weight_decay=decay)
    n = optim.apply_update(p, [T(x) for x in arr(grads)], state, spec)
    assert (float(jn) >= 1.0) == clip
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    want = convert.find_adam(jstate2)
    for got, w in zip(p, arr(jp)):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-6)
    for got, w in zip(state.mu + state.nu, arr(want.mu) + arr(want.nu)):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-7, rtol=1e-6)
    assert int(state.count) == count + 1 == int(want.count)


def test_optimizer_rows_move_only_first_G():
    """Stacked [R] rows: each row's step (its own norm, clip and count)
    against jax.vmap of the chain; rows >= G keep parameters, moments and
    counts bit for bit. Rows get a mix of idle and active clips."""
    R, G = 5, 3
    rng = np.random.RandomState(7)
    params, grads = _tree(rng, (R,)), _tree(rng, (R,))
    grads = {k: v * np.array([0.01, 2.0, 0.02, 3.0, 1.0],
                             np.float32).reshape((R,) + (1,) * (v.ndim - 1))
             for k, v in grads.items()}
    tx = jbase.make_optimizer(5e-4, 1.0)
    jstate = jax.vmap(tx.init)(jax.tree.map(jnp.asarray, params))
    step = jax.vmap(lambda p, s, g: jbase.apply_update(tx, p, s, g))
    rows = lambda t: jax.tree.map(lambda x: x[:G], t)  # noqa: E731
    jp, jstate2, jn = step(rows(params), rows(jstate), rows(grads))

    keys = sorted(params)
    arr = lambda tree: [np.asarray(tree[k]) for k in keys]  # noqa: E731
    p = [T(x) for x in arr(params)]
    state = convert.adam_state(jstate, arr)
    before = [x.clone() for x in p + state.mu + state.nu]
    n = optim.apply_update(p, [T(x) for x in arr(grads)], state,
                           optim.make_optimizer(5e-4, 1.0), G=G)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-6)
    for got, w in zip(p, arr(jp)):
        np.testing.assert_allclose(got[:G].numpy(), w, atol=1e-6)
    for got, old in zip(p + state.mu + state.nu, before):
        assert torch.equal(got[G:], old[G:])
    assert state.count.tolist() == [1] * G + [0] * (R - G)


def _projection_inputs(rng, B=64):
    next_dist = rng.rand(B, ATOMS).astype(np.float32)
    next_dist /= next_dist.sum(-1, keepdims=True)
    reward = rng.uniform(-0.5, 6.0, (B, 1)).astype(np.float32)
    done = (rng.rand(B, 1) < 0.4).astype(np.float32)
    # exact atoms (b an integer: the tie-breaking), and targets clipped
    # at both ends of the support
    reward[:6, 0] = [0.0, 0.5, 5.0, 2.0, -3.0, 9.0]
    done[:6, 0] = 1.0
    return next_dist, reward, done


def test_projection_and_bce():
    """C51 projection with the l/u tie-breaking, on a support [0, 5] given
    as floats, and per group [G, 1, 1] tensors against jax.vmap (one
    support puts targets at v_max past the last bin); then BCE. float32
    weights summed in another order: 1e-6."""
    rng = np.random.RandomState(0)
    nd, r, d = _projection_inputs(rng)
    z = np.linspace(0.0, 5.0, ATOMS, dtype=np.float32)
    want = jdist.projection(nd, r, d, 0.99, 0.0, 5.0, ATOMS, jnp.asarray(z))
    got = distributional.projection(T(nd), T(r), T(d), 0.99, 0.0, 5.0,
                                    ATOMS, T(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(got[0, 0]) == pytest.approx(1.0, abs=1e-6)     # r=0: atom 0
    assert float(got[2, -1]) == pytest.approx(1.0, abs=1e-6)    # r=5: last

    # per-group supports; on [0, 12.754045] a target at v_max gives
    # b = 50.000004 in float32, one bin past the end, which JAX's gather
    # clamps
    vmin = np.array([0.0, -2.0, 0.0], np.float32)
    vmax = np.array([5.0, 3.0, 12.754045], np.float32)
    assert vmax[2] / (vmax[2] / np.float32(ATOMS - 1)) > ATOMS - 1
    zg = vmin[:, None] + (vmax - vmin)[:, None] * np.linspace(
        0, 1, ATOMS, dtype=np.float32)[None]
    nd2, r2, d2 = (np.stack([x, x[::-1], x]) for x in (nd, r, d))
    want = jax.vmap(lambda n_, r_, d_, lo, hi, zz: jdist.projection(
        n_, r_, d_, 0.99, lo, hi, ATOMS, zz))(nd2, r2, d2, vmin, vmax, zg)
    got = distributional.projection(
        T(nd2), T(r2), T(d2), 0.99, T(vmin)[:, None, None],
        T(vmax)[:, None, None], ATOMS, T(zg)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    pred = rng.rand(64, ATOMS).astype(np.float32)
    pred[0, :3] = [0.0, 1.0, 1e-9]                  # hits both clip ends
    np.testing.assert_allclose(
        float(distributional.binary_cross_entropy(T(pred), got[0])),
        float(jdist.binary_cross_entropy(pred, np.asarray(want)[0])),
        rtol=1e-6)


def test_posenc_running_stats_tracker():
    """posenc's interleaved layout: 2e-6 abs (sin/cos of 2^9 x in float32,
    the argument up to ~5e3). RunningMeanStd update:
    rtol 1e-6; normalize: 1e-6 abs. tracker_push_masked (a wrap, and more
    finishers than the window holds): exact."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-10, 10, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(posenc(T(x), 10).numpy(),
                               np.asarray(jposenc.posenc(x, 10)), atol=2e-6)

    jr, r = jrs.RunningMeanStd.create(()), rs.RunningMeanStd.create(
        (), device="cpu")
    for _ in range(3):
        v = rng.randn(33).astype(np.float32) * 3 + 1
        jr, r = jrs.update(jr, v), rs.update(r, T(v))
    for got, want in zip(r, jr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(rs.normalize(r, T(v)).numpy(),
                               np.asarray(jrs.normalize(jr, v)), atol=1e-6)

    jt, t = jbase.Tracker.create(5), base.Tracker.create(5, "cpu")
    for n in (3, 4, 8):
        vals = rng.randn(n).astype(np.float32)
        mask = rng.rand(n) < 0.8
        mask[0] = True
        jt = jbase.tracker_push_masked(jt, jnp.asarray(vals),
                                       jnp.asarray(mask))
        t = base.tracker_push_masked(t, T(vals), T(mask))
        np.testing.assert_array_equal(t.buf.numpy(), np.asarray(jt.buf))
        np.testing.assert_array_equal(t.ptr.numpy(), np.asarray(jt.ptr))
        assert t.ptr.dtype == torch.int32


def _critics(G_max=3, seed=0):
    """A JAX critic stacked over G_max rows (row i perturbed by i) and the
    port's stack with the same weights."""
    jc = JaxCritic()
    p0 = jc.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)),
                 jnp.zeros((1, A)))
    stack = jax.tree.map(lambda x: jnp.stack(
        [x * (1.0 + 0.1 * i) for i in range(G_max)]), p0)
    port = DistributionalDoubleQ(OBS, A, G_max, ATOMS)
    convert.load_params(port.params(), convert.critic_arrays(
        jax.tree.map(np.asarray, stack)))
    return jc, stack, port


def test_stacked_critic_and_action_gradient():
    """The stacked critics' forward on rows :G against jax.vmap of the
    flax critic (probabilities 1e-6), then the DIPO action gradient (5
    Adam steps, clip active) per group against jax.vmap of
    base.action_gradient: 1e-5 on actions in [-1, 1] (float32 matmuls
    in another order, through 5 steps). The critics collect no grad."""
    G, b = 2, 24
    jc, stack, port = _critics()
    rng = np.random.RandomState(1)
    obs = rng.randn(G, b, OBS).astype(np.float32)
    act = rng.uniform(-1, 1, (G, b, A)).astype(np.float32)
    z = np.linspace(0, 5, ATOMS, dtype=np.float32)
    rows = jax.tree.map(lambda x: x[:G], stack)
    jq = jax.vmap(lambda p, o, a: jc.apply(p, o, a))(rows, obs, act)
    q1, q2 = port(T(obs), T(act))
    np.testing.assert_allclose(q1.detach().numpy(), np.asarray(jq[0]),
                               atol=1e-6)
    np.testing.assert_allclose(q2.detach().numpy(), np.asarray(jq[1]),
                               atol=1e-6)

    def ag(p, o, a):
        qmin = lambda oo, aa: jnp.minimum(  # noqa: E731
            *(jnp.sum(q * z, -1) for q in jc.apply(p, oo, aa)))
        return jbase.action_gradient(qmin, o, a, n_steps=5, lr=0.03)

    want = jax.vmap(ag)(rows, obs, act)
    got = base.action_gradient(
        lambda a: q_min(port, T(z)[None, None], T(obs), a), T(act), 5, 0.03)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float((got - T(act)).abs().max()) > 1e-3
    assert all(p.grad is None for p in port.params())


def test_diffusion_loss_with_draws():
    """DiffusionPolicy.loss with the noise and t that JAX draws from its
    key: 1e-6 relative on the MSE (the 1024-wide trunk in float32)."""
    actor = JaxPolicy(action_dim=A, diffusion_iter=5)
    params = actor.init(jax.random.PRNGKey(0), jnp.zeros((1, A)),
                        jnp.zeros((1,)), jnp.zeros((1, OBS + 5)))
    port = convert.load_diffusion(DiffusionPolicy(A, OBS + 5, 5,
                                                  device="cpu"),
                                  jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(2)
    cond = rng.randn(32, OBS + 5).astype(np.float32)
    action = rng.uniform(-1, 1, (32, A)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = actor.apply(params, key, cond, action, method=JaxPolicy.loss)
    k_noise, k_t = jax.random.split(key)
    got = port.loss(T(cond), T(action),
                    noise=T(jax.random.normal(k_noise, (32, A))),
                    t=T(jax.random.randint(k_t, (32,), 0, 5)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


@pytest.mark.parametrize("kind,normalize", [("noveld", False),
                                            ("noveld", True),
                                            ("rnd", True)])
def test_intrinsic_reward_and_update(kind, normalize):
    """compute_reward (with the warm-up branch taken, for normalize) and
    two RND updates from converted parameters. Rewards 1e-6 abs (~1e-2
    scale); the RND nets after two adamw steps (lr 1e-4) 1e-5, the
    target's weight decay included: Adam turns a near-zero gradient into a
    step of up to lr whose sign float32 reordering can flip (2e-6 seen);
    losses and grad norms rtol 1e-5."""
    jm = JaxIntrinsic(OBS, kind=kind, normalize=normalize, warm_up=1)
    pm = IntrinsicModule(OBS, kind=kind, normalize=normalize, warm_up=1)
    js = jm.init(jax.random.PRNGKey(0))
    ps = pm.init("cpu")
    convert.load_params(ps.net.params(), convert.rnd_arrays(
        jax.tree.map(np.asarray, js.params)))
    rng = np.random.RandomState(4)
    for step in range(3):
        obs = rng.randn(40, OBS).astype(np.float32) * 2
        nxt = obs + rng.randn(40, OBS).astype(np.float32) * 0.3
        jr, js = jm.compute_reward(js, obs, nxt)
        pr, ps = pm.compute_reward(ps, T(obs), T(nxt))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-6,
                                   rtol=1e-5)
        for got, want in zip(ps.rms, js.rms):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        if step < 2:
            js, jl, jg = jm.update(js, np.concatenate([obs, nxt]))
            ps, pl, pg = pm.update(ps, T(np.concatenate([obs, nxt])))
            np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
            np.testing.assert_allclose(float(pg), float(jg), rtol=1e-5)
    for got, want in zip(ps.net.params(), convert.rnd_arrays(
            jax.tree.map(np.asarray, js.params))):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert int(ps.update_step) == int(js.update_step) == 2


def test_soft_update():
    """c * tau + t * (1 - tau), the same expression: exact."""
    rng = np.random.RandomState(5)
    t, c = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    want = jbase.soft_update({"x": t}, {"x": c}, 0.05)["x"]
    got = T(t)
    base.soft_update([got], [T(c)], 0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
