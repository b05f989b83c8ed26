"""The port's last public helpers against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Exact: the maze navigation helpers (`free_cells`, `xy_to_rowcol`,
`bfs_next_cell`, `waypoint_policy`) over every maze, `posenc_dim`, the
config from `load_yaml`, the agent registry's names, and the host float64
DTW of `csrc/cluster.cpp`, bit for bit the JAX package's
`runtime/cluster.cpp` (the same loop, built with the Makefile's flags into
a temporary directory). Within 1e-6: `unnormalize` and the quaternion
helpers; within 1e-5: `dtw_pair`. The samplers `FixedNormalActionNoise`
and `generate_embedding` draw from torch generators where JAX takes keys,
so they are held to their distribution: shape, dtype, truncation, and mean
and std at n = 1e5 within 1% of the std. The port's float32 DTW is held to
the host float64 one within float32 rounding. `AgentDDiffPG` warns on
`algo.obs_norm` with the JAX agent's text, and only then.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddiffpg_tpu_torch  # noqa: E402
from ddiffpg_tpu import agents as jagents  # noqa: E402
from ddiffpg_tpu import config as jconfig  # noqa: E402
from ddiffpg_tpu.agents.ddiffpg import AgentDDiffPG as JAgentDDiffPG  # noqa
from ddiffpg_tpu.envs import base as jenv_base  # noqa: E402
from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu.modes import _native as jnative  # noqa: E402
from ddiffpg_tpu.ops import dtw as jdtw  # noqa: E402
from ddiffpg_tpu.ops import embedding as jembedding  # noqa: E402
from ddiffpg_tpu.ops import noise as jnoise  # noqa: E402
from ddiffpg_tpu.ops import posenc as jposenc  # noqa: E402
from ddiffpg_tpu.ops import running_stats as jrs  # noqa: E402
from ddiffpg_tpu.physics import maze as jmaze  # noqa: E402
from ddiffpg_tpu.physics import quat as jquat  # noqa: E402
from ddiffpg_tpu_torch import agents, config  # noqa: E402
from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG  # noqa: E402
from ddiffpg_tpu_torch.envs import base as env_base  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.modes import _native  # noqa: E402
from ddiffpg_tpu_torch.ops import dtw, embedding, noise, posenc  # noqa: E402
from ddiffpg_tpu_torch.ops import running_stats as rs  # noqa: E402
from ddiffpg_tpu_torch.physics import maze, quat  # noqa: E402
from ddiffpg_tpu_torch.physics.engine_cl import Engine  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

N = lambda x: x.detach().cpu().numpy()  # noqa: E731


# ------------------------------------------------------------ maze helpers


def _maze_points(name, n, seed):
    """n seeded xy points over the maze's extent (walls included) and n
    points inside free cells."""
    rng = np.random.RandomState(seed)
    m = maze.MAZES[name]
    ri, rj = maze.find_reset(m)
    lo = np.array([-rj * 4.0 - 2.0, -ri * 4.0 - 2.0])
    hi = lo + 4.0 * np.array([len(m[0]), len(m)])
    anywhere = rng.uniform(lo, hi, (n, 2))
    cells = maze.free_cells(m)
    picks = [cells[k] for k in rng.randint(0, len(cells), n)]
    inside = np.array([(c * 4.0 - rj * 4.0, r * 4.0 - ri * 4.0)
                       for r, c in picks]) + rng.uniform(-1.9, 1.9, (n, 2))
    return anywhere, inside


@pytest.mark.parametrize("name", sorted(maze.MAZES))
def test_maze_navigation_matches_jax(name):
    """free_cells, xy_to_rowcol on seeded points, bfs_next_cell on a seeded
    sample of free-cell pairs (equal and adjacent pairs included), all
    exactly the JAX package's."""
    m = maze.MAZES[name]
    assert m == jmaze.MAZES[name]
    cells = maze.free_cells(m)
    assert cells == jmaze.free_cells(m)
    anywhere, inside = _maze_points(name, 64, 0)
    for xy in np.concatenate([anywhere, inside]).tolist():
        assert maze.xy_to_rowcol(xy, m) == jmaze.xy_to_rowcol(xy, m)
        assert maze.xy_to_rowcol(xy, m, 2.0) == jmaze.xy_to_rowcol(xy, m,
                                                                   2.0)
    rng = np.random.RandomState(1)
    pairs = [(cells[i], cells[j]) for i, j in
             rng.randint(0, len(cells), (64, 2))] + [(cells[0], cells[0])]
    for cur, tgt in pairs:
        got = maze.bfs_next_cell(m, cur, tgt)
        assert got == jmaze.bfs_next_cell(m, cur, tgt)
        assert got in cells
        assert got == tuple(tgt) or abs(got[0] - cur[0]) + abs(
            got[1] - cur[1]) == 1


@pytest.mark.parametrize("name", sorted(maze.MAZES))
def test_waypoint_policy_matches_jax(name):
    """Every goal of the maze: the next waypoint from seeded points inside
    free cells, exactly the JAX helper's."""
    m = maze.MAZES[name]
    _, inside = _maze_points(name, 48, 2)
    for gxy, _ in maze.GOALS[name]:
        got, want = maze.waypoint_policy(m, gxy), jmaze.waypoint_policy(m,
                                                                       gxy)
        for xy in inside.tolist():
            assert got(xy) == want(xy)
        assert got(gxy) == tuple(gxy)


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("dims,L,include", [(2, 10, True), (2, 10, False),
                                            (3, 4, True), (1, 0, True)])
def test_posenc_dim_matches_jax(dims, L, include):
    """tests/test_ops.py's case (2, 10 -> 42) and its neighbours, with the
    width `posenc` gives."""
    got = posenc.posenc_dim(dims, L, include)
    assert got == jposenc.posenc_dim(dims, L, include)
    assert posenc.posenc(torch.zeros(1, dims), L, include).shape[-1] == got


def test_unnormalize_matches_jax():
    rng = np.random.RandomState(3)
    mean, var = rng.randn(7).astype(np.float32), rng.rand(7).astype(
        np.float32) * 4.0 + 0.01
    x = rng.randn(32, 7).astype(np.float32)
    got_rms = rs.RunningMeanStd(torch.tensor(mean), torch.tensor(var),
                                torch.tensor(5.0))
    want_rms = jrs.RunningMeanStd(jnp.asarray(mean), jnp.asarray(var),
                                  jnp.asarray(5.0))
    got = rs.unnormalize(got_rms, torch.tensor(x))
    np.testing.assert_allclose(N(got), np.asarray(jrs.unnormalize(
        want_rms, jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(N(rs.normalize(got_rms, got)), x, rtol=0,
                               atol=1e-6)


def test_quat_helpers_match_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(64, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.randn(64, 3).astype(np.float32)
    w = (rng.randn(64, 3) * 3.0).astype(np.float32)
    w[:4] = 0.0                                      # the zero-rate branch
    tq, tv, tw = (torch.tensor(a) for a in (q, v, w))
    ident = quat.identity(device="cpu")
    assert ident.dtype == torch.float32
    np.testing.assert_array_equal(N(ident), np.asarray(jquat.identity()))
    assert quat.identity("cpu", torch.float64).dtype == torch.float64
    np.testing.assert_array_equal(N(quat.conj(tq)), np.asarray(
        jquat.conj(jnp.asarray(q))))
    for got, want in (
            (quat.inv_rotate(tq, tv), jquat.inv_rotate(jnp.asarray(q),
                                                       jnp.asarray(v))),
            (quat.integrate(tq, tw, 0.01), jquat.integrate(
                jnp.asarray(q), jnp.asarray(w), 0.01))):
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(N(quat.rotate(tq, quat.inv_rotate(tq, tv))),
                               v, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(N(quat.integrate(tq[:4], tw[:4], 0.01)),
                                  q[:4] / np.linalg.norm(q[:4], axis=-1,
                                                         keepdims=True))


def _held_to(s, mean, std, shape):
    assert s.shape == shape and s.dtype == torch.float32
    x = N(s).ravel().astype(np.float64)
    assert abs(x.mean() - mean) < 0.01 * std
    assert abs(x.std() - std) < 0.01 * std


def test_fixed_normal_action_noise_distribution():
    """The port's and JAX's samplers, each from its own generator: shape,
    dtype, truncation, and N(mean, std) at n = 1e5."""
    n = 100_000
    sampler = noise.FixedNormalActionNoise(0.3, 0.5, bounds=(-0.2, 0.6))
    jsampler = jnoise.FixedNormalActionNoise(0.3, 0.5, bounds=(-0.2, 0.6))
    g = torch.Generator().manual_seed(5)
    _held_to(sampler(g, (n,)), 0.3, 0.5, (n,))
    want = jsampler(jax.random.PRNGKey(5), (n,))
    _held_to(torch.tensor(np.asarray(want)), 0.3, 0.5, (n,))
    cut = N(sampler(g, (n, 2), truncated=True))
    assert cut.shape == (n, 2) and cut.min() == -0.2 and cut.max() == 0.6
    jcut = np.asarray(jsampler(jax.random.PRNGKey(6), (n, 2),
                               truncated=True))
    assert jcut.min() == np.float32(-0.2) and jcut.max() == np.float32(0.6)
    # clipped shares of N(0.3, 0.5) below -0.2 and above 0.6: 15.9%, 27.4%
    for c in (cut, jcut):
        assert abs((c == np.float32(-0.2)).mean() - 0.1587) < 0.01
        assert abs((c == np.float32(0.6)).mean() - 0.2743) < 0.01
    free = jnoise.FixedNormalActionNoise(0.0, 1.0)
    assert np.asarray(free(jax.random.PRNGKey(0), (3,), True)).shape == (3,)
    assert noise.FixedNormalActionNoise(0.0, 1.0)(g, (3,), True).shape == (3,)


def test_generate_embedding_distribution():
    n = 100_000
    g = torch.Generator().manual_seed(7)
    e = embedding.generate_embedding(n, generator=g)
    _held_to(e, 0.0, 1.0, (n,))
    _held_to(torch.tensor(np.asarray(jembedding.generate_embedding(
        jax.random.PRNGKey(7), n))), 0.0, 1.0, (n,))
    assert embedding.generate_embedding(5, generator=g,
                                        device="cpu").shape == (5,)
    assert not torch.equal(embedding.generate_embedding(5, generator=g),
                           embedding.generate_embedding(5, generator=g))


@pytest.mark.parametrize("D", [2, 3])
def test_dtw_pair_matches_jax(D):
    """Pairs of seeded tracks of L = 24 at lengths (1, 1), (1, L), (L, L)
    and random ones."""
    L = 24
    rng = np.random.RandomState(10 + D)
    lens = [(1, 1), (1, L), (L, L)] + [tuple(rng.randint(1, L + 1, 2))
                                       for _ in range(5)]
    for la, lb in lens:
        a = np.cumsum(rng.randn(L, D), 0).astype(np.float32)
        b = np.cumsum(rng.randn(L, D), 0).astype(np.float32)
        got = dtw.dtw_pair(torch.tensor(a), torch.tensor(b), la, lb)
        assert got.shape == () and got.dtype == torch.float32
        want = jdtw.dtw_pair(jnp.asarray(a), jnp.asarray(b), la, lb)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got), jdtw.dtw_numpy(a[:la],
                                                              b[:lb]),
                                   rtol=1e-5)


# ---------------------------------------------------------------- config


def test_load_yaml_matches_jax(tmp_path):
    """An algo preset plus nested overrides (a top-level key, two levels of
    sections, an int given as a float, a null)."""
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "num_envs: 64\n"
        "seed: 3\n"
        "run_name: null\n"
        "algo:\n"
        "  name: SAC\n"
        "  batch_size: 128.0\n"
        "  noise:\n"
        "    std_max: 0.4\n"
        "    decay: exp\n"
        "  exp:\n"
        "    type: fixed\n"
        "env:\n"
        "  name: antmaze-v2\n"
        "  resolution: 357\n"
        "intrinsic:\n"
        "  L: 4\n")
    got = config.load_yaml(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig.load_yaml(str(path)))
    assert got.algo.name == "SAC" and got.algo.memory_size == 1_000_000
    assert isinstance(got.algo.batch_size, int)
    empty = tmp_path / "empty.yaml"
    empty.write_text("")
    assert config.load_yaml(str(empty)) == config.Config()


def test_config_imports_yaml_only_to_load(tmp_path):
    """Importing the port's config (as chip_smoke.py does on a machine
    without PyYAML) leaves `yaml` unloaded; `load_yaml` loads it."""
    (tmp_path / "c.yaml").write_text("seed: 5\n")
    code = ("import sys\n"
            "from ddiffpg_tpu_torch import config\n"
            "assert 'yaml' not in sys.modules\n"
            f"assert config.load_yaml({str(tmp_path / 'c.yaml')!r}).seed == 5\n"
            "assert 'yaml' in sys.modules\n")
    env = dict(os.environ,
               PYTHONPATH=str(ddiffpg_tpu_torch.LIB_PATH.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------------------- host DTW


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's `_native`, loading `runtime/cluster.cpp` built with
    the Makefile's flags into a temporary directory (the package looks for
    the library beside its module; the module's `__file__` is pointed
    there for the fixture's life)."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        pytest.skip("no C++ compiler to build runtime/cluster.cpp")
    out = tmp_path_factory.mktemp("jax_native")
    src = ddiffpg_tpu_torch.LIB_PATH.parent / "runtime" / "cluster.cpp"
    subprocess.run([gxx, "-O3", "-Wall", "-shared", "-fPIC", str(src), "-o",
                    str(out / "libcluster.so")], check=True)
    saved = jnative.__file__, jnative._LIB
    jnative.__file__, jnative._LIB = str(out / "_native.py"), None
    yield jnative
    jnative.__file__, jnative._LIB = saved


def _dtw_pairs(seed, P, L, D):
    rng = np.random.RandomState(seed)
    a = np.cumsum(rng.randn(P, L, D), 1).astype(np.float32)
    b = np.cumsum(rng.randn(P, L, D), 1).astype(np.float32)
    la = rng.randint(1, L + 1, P).astype(np.int32)
    lb = rng.randint(1, L + 1, P).astype(np.int32)
    la[:3], lb[:3] = (1, 1, L), (1, L, L)
    b[3], lb[3] = a[3], la[3]                     # a track against itself
    return a, b, la, lb


@pytest.mark.parametrize("D", [2, 3])
def test_host_dtw_batch_matches_jax(jax_native, D):
    """Bit for bit the JAX package's C loop, the float64 `dtw_numpy` DP
    within 1e-12, and the port's float32 wavefront within float32
    rounding: (la + lb + Dx + 2) 2^-24 relative (a terminal cell sums at
    most la + lb - 1 cell costs)."""
    a, b, la, lb = _dtw_pairs(20 + D, 40, 48, D)
    got = _native.dtw_batch(a, b, la, lb)
    assert got.dtype == np.float64 and got.shape == (40,)
    np.testing.assert_array_equal(got, jax_native.dtw_batch(a, b, la, lb))
    d0 = a[0, 0].astype(np.float64) - b[0, 0]
    assert got[0] == np.sqrt((d0 * d0).sum()) and got[3] == 0.0
    for p in range(0, 40, 7):
        np.testing.assert_allclose(got[p], jdtw.dtw_numpy(
            a[p, :la[p]].astype(np.float64),
            b[p, :lb[p]].astype(np.float64)), rtol=1e-12)
    f32 = N(dtw.dtw_batch(*(torch.tensor(x) for x in (a, b, la, lb))))
    bound = (la.astype(np.float64) + lb + D + 2) * 2.0 ** -24
    assert (np.abs(f32 - got) <= bound * got).all()


def test_host_dtw_builds_from_the_port():
    """The port's library is its own build of csrc/cluster.cpp, with
    `dtw_batch` beside `linkage_average`."""
    path = _native.build()
    assert path.parent.name == "torch_ext" and "cluster_" in path.name
    assert _native.SOURCE == ddiffpg_tpu_torch.LIB_PATH / "csrc" / \
        "cluster.cpp"
    assert _native.dtw_batch(np.zeros((0, 4, 2)), np.zeros((0, 4, 2)),
                             np.zeros(0), np.zeros(0)).shape == (0,)
    a = np.zeros((2, 4, 2))
    for la, lb, b in (([1, 5], [1, 1], a), ([1, 1], [-1, 1], a),
                      ([1], [1], a), ([1, 1], [1, 1], a[:, :3])):
        with pytest.raises(ValueError):
            _native.dtw_batch(a, b, np.array(la), np.array(lb))


# ------------------------------------------------- package-level names


def test_package_names_match_jax():
    assert ddiffpg_tpu_torch.LIB_PATH.is_dir()
    assert (ddiffpg_tpu_torch.LIB_PATH / "__init__.py").is_file()
    assert ddiffpg_tpu_torch.LIB_PATH.name == "ddiffpg_tpu_torch"
    assert env_base.Transition._fields == jenv_base.Transition._fields
    assert sorted(agents.AGENTS) == sorted(jagents.AGENTS)
    assert agents.AGENTS["DDiffPG"] is AgentDDiffPG
    with pytest.raises(AttributeError):
        agents.NO_SUCH_NAME  # noqa: B018


def _ddiffpg_cfg(obs_norm):
    return config.Config().override(**{
        "env.name": "pointmaze-v1", "algo.obs_norm": obs_norm,
        "num_envs": 4, "algo.memory_size": 16, "intrinsic.L": 2,
        "diffusion.diffusion_iter": 2})


@pytest.mark.parametrize("name", ["AgentDDiffPG", "DDiffPG"])
def test_make_agent_resolves_ddiffpg(name):
    env = make("pointmaze-v1", num_envs=4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        agent = agents.make_agent(name, env, _ddiffpg_cfg(False),
                                  device="cpu")
    assert type(agent) is AgentDDiffPG
    with pytest.raises(ValueError, match="unknown agent"):
        agents.make_agent("AgentPPO", env, _ddiffpg_cfg(False), device="cpu")


def test_ddiffpg_warns_on_obs_norm():
    """JAX's AgentDDiffPG warns at construction with `algo.obs_norm` (its
    acting normalises the obs, its updates train on the raw ones); the
    port's gives the same warning, of the same category."""
    env = make("pointmaze-v1", num_envs=4, device="cpu")
    with pytest.warns(UserWarning, match="obs_norm") as seen:
        AgentDDiffPG(env, _ddiffpg_cfg(True), device="cpu")
    jcfg =jconfig.Config().override(**{
        "env.name": "pointmaze-v1", "algo.obs_norm": True, "num_envs": 4,
        "algo.memory_size": 16, "intrinsic.L": 2,
        "diffusion.diffusion_iter": 2})
    with pytest.warns(UserWarning, match="obs_norm") as want:
        JAgentDDiffPG(jax_make("pointmaze-v1", num_envs=4), jcfg)
    text = lambda ws: [(w.category, str(w.message))  # noqa: E731
                       for w in ws if "obs_norm" in str(w.message)]
    assert text(seen) == text(want) and len(text(seen)) == 1


# ------------------------------------- chip_smoke.py's checks, on the CPU


def test_substep_walk_rehearsed_on_the_cpu(capsys):
    """Phase 16's walk with both sides on the CPU: every substep equal,
    the walk's end the control step; with bounds no error meets it raises
    on the first substep after logging every stage of `stage_errors`."""
    import chip_smoke
    env = make("PandaDrawerMultiJoints-v3", num_envs=4, device="cpu",
               use_pallas=False)
    inner = env.env
    one = dataclasses.replace(inner.model, n_substeps=1)
    card, cpu = Engine(one, "cpu"), Engine(one, "cpu")
    state, _ = env.reset()
    ctrl = inner._ctrl_from_action(state.qpos, torch.full((4, 7), 0.3))
    args = (state.qpos, state.qvel, ctrl)
    curve, end, _ = chip_smoke.substep_walk(card, cpu, args, 3, (1e-9, 1e-9),
                                            "walk")
    assert [c["substep"] for c in curve] == [1, 2, 3]
    assert all(c["one"] == [0.0, 0.0] == c["accumulated"] for c in curve)
    three = Engine(dataclasses.replace(inner.model, n_substeps=3), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(end, three.step(*args)))
    with pytest.raises(RuntimeError, match="substep 1 of the walk"):
        chip_smoke.substep_walk(card, cpu, args, 3, (-1.0, -1.0), "walk")
    out = capsys.readouterr().out
    for stage in ("fk", "spatial_inertia", "contact_forces", "crba",
                  "bias_forces", "chol_solve", "substep"):
        assert f"stage {stage} max|card - CPU| 0 " in out


def test_helpers_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 18 on the CPU at 64 DTW pairs and 256 quaternions: the float32
    DTW within its bound of the host float64 one, every waypoint goal
    reached, quat equal."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DTW_PAIRS", 64)
    monkeypatch.setattr(chip_smoke, "NUM_ENVS", 256)
    rec = chip_smoke.helpers_phase("cpu", "cpu")
    assert rec["dtw_host"]["pairs"] == 72 and \
        rec["dtw_host"]["pairs_over"] == 0
    assert rec["pointmaze-v1"]["success_per_goal"] == [1.0]
    assert rec["pointmaze-v2"]["success_per_goal"] == [1.0, 1.0]
    assert rec["quat"] == {"integrate": 0.0, "inv_rotate": 0.0}
