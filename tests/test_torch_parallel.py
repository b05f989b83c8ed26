"""The port's data parallelism (`ddiffpg_tpu_torch/parallel/`) at world 2
over gloo on the CPU, held to the JAX package's `parallel/dp.py` and to
one process on the whole batch.

One spawn of two ranks per module (a `file://` store in the test's
temporary directory, so pytest-xdist workers share no port) runs every
check that needs a process group and writes each rank's results; the
tests compare them. The ranks import nothing of JAX (this module imports
it inside its tests only).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tests.port_fixtures import (  # noqa: F401
    fresh_structure_cache, one_torch_thread)

WORLD = 2
B = 16                  # rows of the injected batch, B // WORLD a rank


def _cfg(nd, device="cpu"):
    """The JAX test's `_cfg` (tests/test_parallel.py) on the port."""
    from ddiffpg_tpu_torch import config as C
    cfg = C.Config(algo=C.algo_preset("ddiffpg"))
    return cfg.override(**{
        "num_envs": 2 * nd, "eval_num_envs": nd,
        "env.name": "pointmaze-v1", "env.resolution": 255,
        "algo.memory_size": 8 * nd, "algo.batch_size": 8 * nd,
        "algo.warm_up": 4, "algo.update_times": 1,
        "algo.tracker_len": 8, "diffusion.update_times": 2,
        "diffusion.diffusion_iter": 2, "intrinsic.L": 2,
        "device": device,
    })


def _batch(agent):
    """The injected batch: numpy-made from a seed, B rows."""
    rng = np.random.RandomState(5)
    D, A, E = agent.obs_dim, agent.action_dim, agent.embed_dim
    f = lambda *s: torch.as_tensor(  # noqa: E731
        rng.uniform(-1, 1, s).astype(np.float32))
    return {"obs": f(B, D), "action": f(B, A), "reward": f(B, 1),
            "next_obs": f(B, D), "next_action": f(B, A),
            "done": torch.as_tensor(rng.rand(B, 1) < 0.2),
            "cond": f(B, D + E), "target": f(B, A), "noise": f(B, A),
            "t": torch.as_tensor(rng.randint(0, 2, B)),
            "rms_x": f(B, D) * 3.0 + 2.0}


def _steps(agent, ts, rows):
    """A critic, an actor and an RND step of `agent` on the batch rows
    `rows` (groups G = 1), as the update pass takes them. Returns the
    gradients each `apply_update` stepped with, and the parameters after
    the three steps."""
    from ddiffpg_tpu_torch.agents import base
    from ddiffpg_tpu_torch.ops import optim

    b = {k: v[rows] for k, v in _batch(agent).items()}
    seen = []
    adam_step = optim.adam_step

    def spy(params, grads, state, spec):
        seen.append([g.detach().clone() for g in grads])
        return adam_step(params, grads, state, spec)

    optim.adam_step = spy
    try:
        a = agent.cfg.algo
        z = torch.linspace(a.v_min_explore, a.v_max_explore,
                           a.num_atoms)[None, None]
        vmin = torch.full((1, 1, 1), a.v_min_explore)
        vmax = torch.full((1, 1, 1), a.v_max_explore)
        g1 = lambda x: x[None]  # noqa: E731
        c_loss = base.distributional_critic_loss(
            ts.critics, ts.critic_targets, z, g1(b["obs"]), g1(b["action"]),
            g1(b["reward"]), g1(b["next_obs"]), g1(b["next_action"]),
            g1(b["done"]), a.gamma, vmin, vmax, a.num_atoms)
        params = ts.critics.params()
        optim.apply_update(params, torch.autograd.grad(c_loss.sum(), params),
                           ts.critic_opts, agent.critic_spec, G=1)
        a_loss = ts.actor.loss(b["cond"], b["target"], noise=b["noise"],
                               t=b["t"])
        aparams = list(ts.actor.parameters())
        optim.apply_update(aparams, torch.autograd.grad(a_loss, aparams),
                           ts.actor_opt, agent.actor_spec)
        agent.intrinsic.update(ts.intrinsic, b["obs"])
    finally:
        optim.adam_step = adam_step
    after = [p.detach().clone() for p in
             ts.critics.params() + list(ts.actor.parameters())
             + ts.intrinsic.net.params()]
    return [[g.numpy() for g in gs] for gs in seen], \
        [p.numpy() for p in after]


def _dp_run(seed):
    """A short DP run on pointmaze-v1 (the JAX test's config, 20-step
    episodes): warm-up, 12 iterations, a recluster, one iteration. Returns
    {path: array} of the final state and the logs."""
    from ddiffpg_tpu_torch.parallel import dp, make_mesh

    agent = dp.DPAgentDDiffPG(_cfg(WORLD), make_mesh(WORLD, device="cpu"),
                              env_kwargs={"max_episode_steps": 20},
                              device="cpu")
    ts = agent.warmup(agent.init(seed))
    for _ in range(12):
        ts, _ = agent.train_iter(ts)
    ts = agent.update_cluster(ts)
    ts, logs = agent.train_iter(ts)
    state = {".".join(map(str, p)): x.detach().numpy().copy()
             for p, x in dp.leaves(ts)}
    return {"state": state, "specs": dp.state_specs(ts),
            "logs": {k: float(v) for k, v in logs.items()},
            "num_groups": agent.num_groups,
            "masks": ts.replay.group_mask.numpy().copy()}


def _rank(rank, out_dir, store, threads):
    import torch.distributed as dist

    from ddiffpg_tpu_torch.agents import base, make_agent
    from ddiffpg_tpu_torch.envs import make
    from ddiffpg_tpu_torch.ops import running_stats as rs

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    group = dist.group.WORLD
    out = {}
    # update_rms on this rank's half of one batch
    agent = make_agent("DDiffPG", make("pointmaze-v1", num_envs=2,
                                       device="cpu"),
                       _cfg(1), device="cpu")
    rows = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
    x = _batch(agent)["rms_x"][rows]
    rms = rs.RunningMeanStd.create((x.shape[1],), device="cpu")
    with base.data_parallel(group):
        rms = base.update_rms(base.update_rms(rms, x), x * 0.5 - 1.0)
    out["rms"] = [t.numpy() for t in (rms.mean, rms.var)] + [
        float(rms.count)]
    # the gradient contract on this rank's half
    with base.data_parallel(group):
        out["grads"], out["params"] = _steps(agent, agent.init(), rows)
    # a DP run, twice
    out["runs"] = [_dp_run(3), _dp_run(3)]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("dp")
    # each rank on this process's intra-op threads: one, under
    # port_fixtures.one_torch_thread
    mp.spawn(_rank, args=(str(d), str(d / "store"), torch.get_num_threads()),
             nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _local_agent():
    from ddiffpg_tpu_torch.agents import make_agent
    from ddiffpg_tpu_torch.envs import make
    return make_agent("DDiffPG", make("pointmaze-v1", num_envs=2,
                                      device="cpu"), _cfg(1), device="cpu")


def test_gradients_are_the_whole_batch(ranks):
    """A critic, an actor and an RND step at world 2, each rank holding
    half of one batch: the gradients `apply_update` steps with are the
    whole batch's in one process within 1e-6 of their global norm (every
    loss is a mean over equal halves), the parameters after the steps
    within 1e-5 (Adam moves a near-zero gradient's entry by a whole step
    either way when float32 sums run in another order)."""
    agent = _local_agent()
    want_g, want_p = _steps(agent, agent.init(), slice(0, B))
    for r in ranks:
        assert len(r["grads"]) == len(want_g) == 3
        for got, want in zip(r["grads"], want_g):
            norm = np.sqrt(sum(float((w * w).sum()) for w in want))
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            assert err <= 1e-6 * norm, (err, norm)
        for got, want in zip(r["params"], want_p):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_update_rms_matches_jax(ranks):
    """`update_rms` at world 2 equals JAX's `update_rms` under shard_map
    on a 2-device mesh, fed the same halves (two folds)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ddiffpg_tpu.agents import base as jbase
    from ddiffpg_tpu.ops import running_stats as jrs
    from ddiffpg_tpu.parallel.mesh import make_mesh

    x = _batch(_local_agent())["rms_x"].numpy()
    mesh = make_mesh(WORLD)

    def fold(x):
        with jbase.data_parallel("data"):
            rms = jrs.RunningMeanStd.create((x.shape[1],))
            rms = jbase.update_rms(jbase.update_rms(rms, x), x * 0.5 - 1.0)
        return rms.mean, rms.var, rms.count

    fn = jax.jit(jax.shard_map(fold, mesh=mesh, in_specs=P("data"),
                               out_specs=P(), check_vma=False))
    mean, var, count = (np.asarray(v) for v in fn(jnp.asarray(x)))
    for r in ranks:
        np.testing.assert_allclose(r["rms"][0], mean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["rms"][1], var, rtol=1e-5, atol=1e-6)
        assert r["rms"][2] == float(count)
    np.testing.assert_array_equal(ranks[0]["rms"][0], ranks[1]["rms"][0])
    np.testing.assert_array_equal(ranks[0]["rms"][1], ranks[1]["rms"][1])


def test_run_replicated_and_repeatable(ranks):
    """A short DP run with a recluster leaves every replicated leaf
    (parameters, optimizer states, embeddings, the intrinsic state)
    bitwise alike on both ranks, the group masks' global layout alike, and
    two runs bitwise equal on each rank."""
    for r in ranks:
        one, two = r["runs"]
        assert one["state"].keys() == two["state"].keys()
        for k in one["state"]:
            np.testing.assert_array_equal(one["state"][k], two["state"][k],
                                          err_msg=k)
        assert all(np.isfinite(v) for v in one["logs"].values()), one["logs"]
    a, b = ranks[0]["runs"][0], ranks[1]["runs"][0]
    rep = [k for k, s in a["specs"].items() if s == ()]
    assert len(rep) > 20 and any(k.startswith("actor.") for k in rep)
    for k in rep:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    assert a["num_groups"] == b["num_groups"] >= 1
    assert a["logs"] == b["logs"]
    # each rank keeps its own slots: the two shares differ
    assert not np.array_equal(a["state"]["obs"], b["state"]["obs"])


@pytest.fixture(scope="module")
def jax_locals():
    """Two ranks' local JAX states of the JAX test's config at world 1
    (a local agent, no mesh), as `DPAgentDDiffPG.init` makes them from
    the split key; the init jitted (bitwise the eager one, 4x faster)."""
    import jax

    from ddiffpg_tpu.agents.ddiffpg import AgentDDiffPG as JAgent
    from ddiffpg_tpu.envs import make as jmake

    jagent = JAgent(jmake("pointmaze-v1", num_envs=2), _jax_cfg(1))
    init = jax.jit(jagent.init)
    return [init(k) for k in jax.random.split(jax.random.PRNGKey(4), WORLD)]


def test_state_specs_match_jax(jax_locals):
    """The port's `state_specs` gives every field the JAX package's
    layout (`ddiffpg_tpu/parallel/dp.py:state_specs`) on the fields both
    states have."""
    import jax

    from ddiffpg_tpu.parallel.dp import state_specs as jspecs
    from ddiffpg_tpu_torch.parallel.dp import state_specs

    jts = jax_locals[0]
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs(jts), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        names = [getattr(p, "name", None) for p in path]
        want.setdefault(tuple(n for n in names[:2] if n), set()).add(
            tuple(spec))
    got = {}
    for k, spec in state_specs(_local_agent().init()).items():
        names = k.split(".")
        key = tuple(names[:2]) if names[0] in ("replay", "env_state",
                                               "stats", "obs_rms",
                                               "intrinsic") else (names[0],)
        got.setdefault(key, set()).add(spec)
    shared = [k for k in got if k in want]
    assert len(shared) >= 20, shared
    for k in shared:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got[("replay", "group_mask")] == {(None, "data")}
    assert got[("replay", "obs")] == {("data",)}
    assert got[("embeddings",)] == {()}


def _jax_cfg(nd):
    from ddiffpg_tpu import config as JC
    cfg = JC.Config(algo=JC.algo_preset("ddiffpg"))
    return cfg.override(**{
        "num_envs": 2 * nd, "eval_num_envs": nd,
        "env.name": "pointmaze-v1", "env.resolution": 255,
        "algo.memory_size": 8 * nd, "algo.batch_size": 8 * nd,
        "algo.warm_up": 4, "algo.update_times": 1,
        "algo.tracker_len": 8, "diffusion.update_times": 2,
        "diffusion.diffusion_iter": 2, "intrinsic.L": 2,
    })


def test_convert_split_gives_the_jax_locals(jax_locals):
    """`utils/convert.py:split_dp` cuts a JAX DP global state, made as
    `DPAgentDDiffPG.init` combines its ranks' local states (built here
    without a mesh), back into each rank's local state; rank 1's converts
    into the port's state."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ddiffpg_tpu.parallel.dp import state_specs as jspecs
    from ddiffpg_tpu_torch.utils import convert

    locals_ = jax_locals
    specs = jspecs(locals_[0], "data")

    def combine(spec, *leaves):
        if spec == P():
            return leaves[0]
        return jnp.concatenate(leaves, axis=list(spec).index("data"))

    glob = jax.tree.map(np.asarray, jax.tree.map(combine, specs, *locals_))
    for r in range(WORLD):
        got = convert.split_dp(glob, r, WORLD)
        want_r = jax.tree.map(np.asarray, locals_[r])
        want_0 = jax.tree.map(np.asarray, locals_[0])
        for (path, g), w_r, w_0, s in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree.leaves(want_r), jax.tree.leaves(want_0),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
            np.testing.assert_array_equal(g, w_0 if s == P() else w_r,
                                          err_msg=str(path))
    port = _local_agent()
    ts = convert.ddiffpg_state(port, convert.split_dp(glob, 1, WORLD))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(locals_[1].obs))
    np.testing.assert_array_equal(ts.replay.group_mask.numpy(),
                                  np.asarray(locals_[1].replay.group_mask))
