"""How a run is read, in the port, against the JAX package on the CPU: the
maze plots, the weights bundle and the checkpoint tools.

- The four plots of `utils/plotting.py` give RGB arrays bitwise equal to
  the JAX package's on the same numpy inputs (antmaze-v1 and v2 maps,
  seeded tracks and clusters, a linkage from the port's
  `linkage_average`, a density grid); `Logger.log_image` writes them.
- `save_model` / `load_model` round-trip bit for bit, and the bundle of a
  state carried across from JAX params by `utils/convert.py` holds the
  leaves of the JAX package's `save_model` (exactly: both are copies).
- The tools: `common.q_of` (probe_qfield's and eval_modes' per-group Q)
  against the JAX tools' `q_of` on the same obs and actions from
  converted critics, on a dense config whose explore support differs
  from the modes' (1e-5: float32 critics of stock widths, summed in
  another order); eval_ckpt's termination classes and per-goal counts
  against the JAX tool's formulas on a hand-made trace with one end of
  each cause; probe_energy's deterministic patterns equal to JAX's over
  300 steps; run_status's line and archive_run's archive equal to the
  JAX copies' on tests/test_archive_run.py's run directory.
- Every tool's `main` end to end on the CPU from tiny checkpoints written
  by `ckpt.save` (4 envs, 4 eval envs, antmaze episodes cut to 2 steps:
  an ant step costs ~0.5 s on the CPU), and each raises without a card
  unless given device=cpu.
"""

import functools
import gzip
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.models.diffusion import DiffusionPolicy as JPolicy  # noqa
from ddiffpg_tpu.models.mlp import DistributionalDoubleQ as JQ  # noqa: E402
from ddiffpg_tpu.ops.running_stats import RunningMeanStd as JRms  # noqa
from ddiffpg_tpu.utils import checkpoint as jckpt  # noqa: E402
from ddiffpg_tpu.utils import plotting as jplot  # noqa: E402
from ddiffpg_tpu_torch import config as C  # noqa: E402
from ddiffpg_tpu_torch import train  # noqa: E402
from ddiffpg_tpu_torch.agents import make_agent  # noqa: E402
from ddiffpg_tpu_torch.modes.linkage import linkage_average  # noqa: E402
from ddiffpg_tpu_torch.ops.running_stats import RunningMeanStd  # noqa
from ddiffpg_tpu_torch.physics import maze  # noqa: E402
from ddiffpg_tpu_torch.replay import episodic as ep  # noqa: E402
from ddiffpg_tpu_torch.tools import (archive_run, common, eval_ckpt,  # noqa
                                     eval_goals, eval_modes, probe_energy,
                                     probe_qfield, run_status, trace_goals,
                                     trace_launch)
from ddiffpg_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from ddiffpg_tpu_torch.utils import convert, plotting  # noqa: E402
from ddiffpg_tpu_torch.utils.logger import Logger  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools import archive_run as jarchive  # noqa: E402
from tools import run_status as jstatus  # noqa: E402

T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
N = lambda x: x.detach().cpu().numpy()  # noqa: E731
G = 3
TINY = ["num_envs=4", "algo.memory_size=8", "diffusion.diffusion_iter=2",
        "algo.warm_up=100"]


# ------------------------------------------------------------------ plots

@pytest.mark.parametrize("name", ["antmaze-v1", "antmaze-v2"])
def test_plots_bitwise_equal_to_jax(name):
    rng = np.random.RandomState(0)
    mm = maze.MAZES[name]
    xy = rng.uniform(-10, 10, (30, 4, 2)).astype(np.float32)
    tracks = [rng.randn(int(rng.randint(5, 30)), 2).cumsum(0)
              for _ in range(7)]
    clusters = [[0, 2, 5], [1, 3], [4, 6]]
    D = np.array([[np.abs(a.mean(0) - b.mean(0)).sum() for b in tracks]
                  for a in tracks])
    Z = linkage_average(D)
    grid = rng.randint(-1, 150, (51, 51)).astype(np.int32)
    for got, want in (
            (plotting.plot_traj(mm, xy), jplot.plot_traj(mm, xy)),
            (plotting.plot_cluster(mm, tracks, clusters),
             jplot.plot_cluster(mm, tracks, clusters)),
            (plotting.plot_hierarchy(Z), jplot.plot_hierarchy(Z)),
            (plotting.plot_heatmap(grid), jplot.plot_heatmap(grid))):
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
        assert got.std() > 0
        np.testing.assert_array_equal(got, want)


def test_log_image_writes_a_png(tmp_path):
    import matplotlib.image as mpimg

    img = np.random.RandomState(1).randint(0, 256, (12, 9, 3), np.uint8)
    logger = Logger(str(tmp_path), "run")
    logger.log_image("eval/map", img, 640)
    logger.close()
    back = mpimg.imread(tmp_path / "run" / "eval_map_640.png")
    np.testing.assert_array_equal(np.round(back[..., :3] * 255), img)


# ----------------------------------------------------- converted JAX state

def _cfg(env, *extra):
    over = [f"env.name={env}", "device=cpu", *TINY, *extra]
    cfg = C.Config(algo=C.algo_preset("ddiffpg")).override_strings(over)
    return C.preprocess(cfg).override_strings(over)


def _port_agent(env, *extra):
    cfg = _cfg(env, *extra)
    e = train.make_envs(cfg, torch.device("cpu"))[0]
    return make_agent("DDiffPG", e, cfg, device="cpu")


@pytest.fixture(scope="module")
def converted():
    """A port DDiffPG state on dense pointmaze-v1 (explore support [0, 5],
    modes [-2500, 0]) with a warmed-up replay whose groups 1 and 2 share
    group 0's transitions, and the JAX actor, stacked critics (each row
    different), embeddings, obs stats and coverage carried into it by
    `utils/convert.py`."""
    agent = _port_agent("pointmaze-v1", "env.reward_type=dense")
    a = agent.cfg.algo
    assert (a.v_min, a.v_max) != (a.v_min_explore, a.v_max_explore)
    ts = agent.warmup(agent.init())
    ts.replay.group_mask[1:G] = ts.replay.group_mask[0]
    D, A, E = agent.obs_dim, agent.action_dim, agent.embed_dim
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jactor = jax.jit(JPolicy(action_dim=A, diffusion_iter=2).init)(
        k1, jnp.zeros((1, A)), jnp.zeros((1,)), jnp.zeros((1, D + E)))
    jq = jax.jit(JQ(num_atoms=a.num_atoms).init)(
        k2, jnp.zeros((1, D)), jnp.zeros((1, A)))
    rng = np.random.RandomState(2)
    jcritics = jax.tree.map(lambda x: np.stack(
        [np.asarray(x) + 0.05 * g * rng.randn(*x.shape).astype(np.float32)
         for g in range(agent.G_max)]), jq)
    convert.load_params(ts.actor.parameters(), convert.actor_arrays(jactor))
    convert.load_params(ts.critics.params(), convert.critic_arrays(jcritics))
    emb = rng.randn(agent.G_max, E).astype(np.float32)
    ts.embeddings = T(emb)
    jrms = JRms(mean=rng.randn(D).astype(np.float32),
                var=rng.rand(D).astype(np.float32) + 0.5,
                count=np.float32(123.0))
    ts.obs_rms = RunningMeanStd(*(T(x) for x in jrms))
    return agent, ts, {"actor": jactor, "critics": jcritics,
                       "embeddings": emb, "rms": jrms,
                       "coverage": N(ts.density_grid)}


def jax_q_of(agent, critics, g, obs, act):
    """The JAX tools' q_of (tools/probe_qfield.py:69-78,
    tools/eval_modes.py:113-123) on numpy stacked critics."""
    a = agent.cfg.algo
    vmin = a.v_min_explore if g == 0 else a.v_min
    vmax = a.v_max_explore if g == 0 else a.v_max
    z = jnp.linspace(vmin, vmax, a.num_atoms)
    cp = jax.tree.map(lambda x: x[g], critics)
    q1, q2 = _jq_apply(a.num_atoms)(cp, jnp.asarray(obs), jnp.asarray(act))
    return np.asarray(jnp.minimum((q1 * z).sum(-1), (q2 * z).sum(-1)))


@functools.lru_cache
def _jq_apply(num_atoms):
    """The critic's apply, jitted once (eager flax compiles op by op)."""
    return jax.jit(JQ(num_atoms=num_atoms).apply)


def test_q_of_matches_jax_on_each_groups_support(converted):
    agent, ts, j = converted
    rng = np.random.RandomState(3)
    obs = rng.randn(64, agent.obs_dim).astype(np.float32)
    act = rng.uniform(-1, 1, (64, agent.action_dim)).astype(np.float32)
    got = [N(common.q_of(agent, ts, g, T(obs), T(act))) for g in range(G)]
    for g in range(G):
        np.testing.assert_allclose(
            got[g], jax_q_of(agent, j["critics"], g, obs, act), rtol=0,
            atol=1e-5 * max(1.0, np.abs(got[g]).max()), err_msg=f"g={g}")
    # group 0 on [0, 5], the modes on [-2500, 0]
    assert got[0].min() >= 0.0 and got[1].max() <= 0.0


def test_eval_modes_and_probe_qfield_q_match_jax(converted):
    """eval_modes' behaviour and target-action Q on its replayed batch and
    probe_qfield's random-action Q at a point, recomputed with JAX's q_of
    on the same batch and actions."""
    agent, ts, j = converted
    for g in range(G):
        r = eval_modes.group_q(agent, ts, g, torch.Generator().manual_seed(g))
        gb = ep.sample_group(ts.replay, g, eval_modes.BATCH, mix_temp=False,
                             generator=torch.Generator().manual_seed(g))
        assert r["real"] == eval_modes.BATCH
        for key, act in (("behavior", gb.action),
                         ("target_act", gb.target_action)):
            want = jax_q_of(agent, j["critics"], g, N(gb.obs), N(act)).mean()
            np.testing.assert_allclose(r[key], want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} g={g}")
    obs0 = ts.obs[0]
    px, py = 2.0, -1.5
    qs = probe_qfield.point_q(agent, ts, obs0, px, py, G)
    gen = torch.Generator().manual_seed(hash((px, py)) % 2**31)
    zero = torch.zeros(agent.embed_dim)
    obs = obs0.clone()
    obs[0], obs[1] = px, py
    ob = obs[None].repeat(probe_qfield.N_ACTIONS, 1)
    common.actor_with(agent, ts, zero, gen)(ob)     # the actor's draws
    a_rnd = torch.rand((probe_qfield.N_ACTIONS, agent.action_dim),
                       generator=gen) * 2.0 - 1.0
    for g in range(G):
        want = jax_q_of(agent, j["critics"], g, N(ob), N(a_rnd))
        np.testing.assert_allclose(qs[g][:2], [want.mean(), want.std()],
                                   rtol=1e-4, atol=1e-5, err_msg=f"g={g}")


def test_bundle_round_trips_and_holds_the_jax_leaves(converted, tmp_path):
    agent, ts, j = converted
    rows = ckpt.critic_rows(ts.critics, G)
    nbytes = ckpt.save_model(tmp_path / "model.pt", ts.actor, rows,
                             rms=ts.obs_rms, embeddings=ts.embeddings,
                             coverage=ts.density_grid)
    assert nbytes == (tmp_path / "model.pt").stat().st_size
    assert not list(tmp_path.glob("*.tmp"))
    got = ckpt.load_model(tmp_path / "model.pt")
    assert set(got) == {"actor", "critics", "rms", "embeddings", "coverage"}
    # bit for bit what was saved
    for k, v in ts.actor.state_dict().items():
        assert torch.equal(got["actor"][k], v), k
    assert len(got["critics"]) == G
    for g, row in enumerate(rows):
        for k, v in row.items():
            assert torch.equal(got["critics"][g][k], v), (g, k)
    for k in RunningMeanStd._fields:
        assert torch.equal(got["rms"][k], getattr(ts.obs_rms, k)), k
    assert torch.equal(got["embeddings"], ts.embeddings)
    assert torch.equal(got["coverage"], ts.density_grid)

    # the JAX bundle of the same weights
    jckpt.save_model(tmp_path / "model.pkl", j["actor"],
                     [jax.tree.map(lambda x: x[g], j["critics"])
                      for g in range(G)], rms=j["rms"],
                     embeddings=j["embeddings"], coverage=j["coverage"])
    want = jckpt.load_model(tmp_path / "model.pkl")
    for a, w in zip(got["actor"].values(),
                    convert.actor_arrays(want["actor"])):
        np.testing.assert_array_equal(N(a), w)
    for g in range(G):
        arrays = convert.one_row_critic_arrays(want["critics"][g])
        for a, w in zip(got["critics"][g].values(), arrays):
            np.testing.assert_array_equal(N(a), w[0])
    for k in RunningMeanStd._fields:
        np.testing.assert_array_equal(N(got["rms"][k]),
                                      getattr(want["rms"], k))
    np.testing.assert_array_equal(N(got["embeddings"]), want["embeddings"])
    np.testing.assert_array_equal(N(got["coverage"]), want["coverage"])
    ckpt.save_model(tmp_path / "bare.pt", ts.actor, rows[:1])
    bare = ckpt.load_model(tmp_path / "bare.pt")
    assert bare["rms"] is None and bare["coverage"] is None


# ------------------------------------------------- tools against JAX's math

def test_eval_ckpt_terminations_match_jax_formulas():
    """One episode end of each cause (goal 2, timeout, z_high, z_low,
    escape, other), an end both high and out of the world (counted under
    both, as JAX does), and steps that end nothing."""
    Tn, E = 3, 4
    tr = {"done": np.zeros((Tn, E), bool), "succ": np.zeros((Tn, E), bool),
          "goal_id": np.zeros((Tn, E), np.int32),
          "tout": np.zeros((Tn, E), bool),
          "z": np.full((Tn, E), 0.5, np.float32),
          "xy": np.zeros((Tn, E, 2), np.float32)}
    ends = [(0, 0, "goal"), (0, 1, "timeout"), (1, 0, "z_high"),
            (1, 2, "z_low"), (2, 1, "escape"), (2, 2, "other"),
            (2, 3, "both")]
    for t, e, cause in ends:
        tr["done"][t, e] = True
        if cause == "goal":
            tr["succ"][t, e], tr["goal_id"][t, e] = True, 2
        elif cause == "timeout":
            tr["tout"][t, e] = True
        elif cause == "z_high":
            tr["z"][t, e] = 2.5
        elif cause == "z_low":
            tr["z"][t, e] = -0.7
        elif cause == "escape":
            tr["xy"][t, e] = (-61.0, 3.0)
        elif cause == "both":
            tr["z"][t, e], tr["xy"][t, e] = 3.0, (0.0, 75.0)
    got = eval_ckpt.terminations(tr, 2)
    # the JAX tool's formulas (tools/eval_ckpt.py:91-99, 104-108)
    done = tr["done"]
    n_ep = int(done.sum())
    goal = int((done & tr["succ"]).sum())
    tout = int((done & tr["tout"]).sum())
    esc = int((done & ~tr["succ"] & ~tr["tout"]
               & (np.abs(tr["xy"]) > 60.0).any(-1)).sum())
    z_hi = int((done & ~tr["succ"] & ~tr["tout"] & (tr["z"] > 2.0)).sum())
    z_lo = int((done & ~tr["succ"] & ~tr["tout"] & (tr["z"] < -0.5)).sum())
    gids = tr["goal_id"][done & tr["succ"]]
    assert got == {"episodes": n_ep, "goal": goal, "timeout": tout,
                   "z_high": z_hi, "z_low": z_lo, "escape": esc,
                   "other": n_ep - goal - tout - esc - z_hi - z_lo,
                   "per_goal": {g: int((gids == g).sum()) for g in (1, 2)}}
    assert got == {"episodes": 7, "goal": 1, "timeout": 1, "z_high": 2,
                   "z_low": 1, "escape": 2, "other": 0,
                   "per_goal": {1: 0, 2: 1}}


def test_probe_energy_patterns_match_jax():
    E, steps = 8, 300

    def jax_pattern(name, t):      # tools/probe_energy.py:41-56
        if name == "const+":
            return jnp.ones((E, 8))
        if name == "const-":
            return -jnp.ones((E, 8))
        if name == "alternate":
            base = jnp.tile(jnp.array([1.0, -1.0]), 4)
            return jnp.sign(jnp.sin(0.5 * t + jnp.arange(E)[:, None])) * base
        hz = float(name[4:])
        return jnp.sign(jnp.sin(2 * jnp.pi * hz * 0.1 * t)) \
            * jnp.ones((E, 8))

    ts = jnp.arange(steps, dtype=jnp.float32)
    tt = torch.arange(steps, dtype=torch.float32)
    for name in probe_energy.PATTERNS[:-1]:
        want = np.asarray(jax.vmap(lambda t: jax_pattern(name, t))(ts))
        got = np.stack([N(probe_energy.pattern(name, t, E)) for t in tt])
        np.testing.assert_array_equal(got, want, err_msg=name)
    r = probe_energy.pattern("random", tt[0], E,
                             torch.Generator().manual_seed(0))
    assert r.shape == (E, 8) and float(r.abs().max()) <= 1.0


def test_run_status_and_archive_match_the_jax_copies(tmp_path, capsys,
                                                     monkeypatch):
    """tests/test_archive_run.py's run directory, read by both copies."""
    run = tmp_path / "runs" / "demo_run"
    run.mkdir(parents=True)
    rows = [{"step": 100, "wall": 3.0, "train/return": 1.5,
             "train/num_groups": 2, "train/env_steps_per_sec": 1234.5},
            {"step": 200, "eval/success_rate": 0.5,
             "eval/success_goal1": 1.0, "eval/success_goal2": 0.0}]
    (run / "metrics.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\nnot json\n")
    (run / "config.json").write_text('{"seed": 11}')
    for name in ["eval_map_100.png", "eval_map_200.png", "cluster_100.png"]:
        (run / name).write_bytes(b"png")

    jstatus.status(run)
    want = capsys.readouterr().out
    run_status.status(run)
    assert capsys.readouterr().out == want
    assert want.startswith("demo_run step=100") and "succ=0.50" in want

    assert archive_run.REPO == Path(__file__).resolve().parent.parent
    outs = {}
    for name, mod in (("jax", jarchive), ("port", archive_run)):
        monkeypatch.setattr(mod, "REPO", tmp_path / name)
        outs[name] = mod.archive(run)
    assert outs["port"] == tmp_path / "port" / "runs_archive" / "demo_run"
    files = {k: sorted(p.name for p in v.iterdir()) for k, v in outs.items()}
    assert files["port"] == files["jax"] == [
        "cluster_100.png", "config.json", "eval_map_200.png",
        "final_metrics.json", "metrics.jsonl.gz"]
    for f in files["port"]:
        read = (lambda p: gzip.open(p).read()) if f.endswith(".gz") \
            else (lambda p: p.read_bytes())
        assert read(outs["port"] / f) == read(outs["jax"] / f), f


# ------------------------------------------------- the tools' main, on CPU

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A light antmaze-v1 checkpoint (no replay) and a full pointmaze-v2
    one with a warmed-up replay, both of a fresh tiny agent with groups 1
    and 2 sharing group 0's transitions and num_groups 3 in the meta."""
    d = tmp_path_factory.mktemp("ckpts")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", 2)
        for env, extra, skip in (("antmaze-v1", (), ("replay",)),
                                 ("pointmaze-v2", ("env.resolution=357",),
                                  ())):
            agent = _port_agent(env, *extra)
            ts = agent.init()
            if not skip:
                ts = agent.warmup(ts)
            ts.replay.group_mask[1:G] = ts.replay.group_mask[0]
            path = d / f"{env}.pt"
            ckpt.save(path, ts, {"num_groups": G}, skip=skip)
            out[env] = (str(path), [f"env={env}", "eval_envs=4",
                                    "device=cpu", *TINY, *extra])
        yield out


def test_eval_ckpt_main(ckpts, capsys):
    path, args = ckpts["antmaze-v1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", 2)
        out = eval_ckpt.main([path, *args])
    assert out["episodes"] == 4 and out["timeout"] == 4
    assert sum(out[k] for k in ("goal", "timeout", "z_high", "z_low",
                                "escape", "other")) == out["episodes"]
    text = capsys.readouterr().out
    assert "episodes=4  goal=0  timeout=4" in text
    assert "launch trace" in text and "'light': True" in text


def test_eval_goals_and_eval_modes_main(ckpts, capsys):
    path, args = ckpts["pointmaze-v2"]
    summary = eval_goals.main([path, *args, "seeds=2"])
    assert summary["eval/episodes"] > 0
    assert {"eval/success_goal1", "eval/success_goal2"} <= set(summary)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["seed"] for x in lines[1:3]] == [100, 101]
    out = eval_modes.main([path, *args])
    assert list(out["success"]) == ["zero", "explore", "mode1", "mode2",
                                    "zero+nz", "explore+nz"]
    assert len(out["groups"]) == G
    assert all(r["real"] == eval_modes.BATCH for r in out["groups"])
    assert "per-group Q_g comparison on 512" in capsys.readouterr().out


def test_trace_goals_and_probe_qfield_main(ckpts, capsys):
    path, args = ckpts["pointmaze-v2"]
    out = trace_goals.main([path, *args])
    assert list(out) == ["zero", "explore", "mode1", "mode2"]
    assert all(len(r["min_dist"]) == 2 and set(r["per_goal"]) == {1, 2}
               for r in out.values())
    path, args = ckpts["antmaze-v1"]
    args = [a for a in args if not a.startswith("eval_envs=")]
    rows = probe_qfield.main([path, *args, "line=-8.8,0:-8.8,8:3"])
    assert list(rows) == ["-8.8,0.0", "-8.8,4.0", "-8.8,8.0"]
    assert all(len(qs) == G for qs in rows.values())
    assert "g2: Q=" in capsys.readouterr().out


def test_probe_energy_main(capsys):
    out = probe_energy.main(["steps=1", "envs=2", "device=cpu"])
    assert list(out) == list(probe_energy.PATTERNS)
    assert all(np.isfinite(r["z_max"]) for r in out.values())
    assert capsys.readouterr().out.count(" z_max=") == 7


def test_eval_modes_refuses_a_light_checkpoint(ckpts):
    path, args = ckpts["antmaze-v1"]
    with pytest.raises(SystemExit, match="light checkpoint"):
        eval_modes.main([path, *args])


def test_trace_launch_main(ckpts, capsys, tmp_path):
    """trace_launch on the CPU prints the JAX tool's lines (the env, its
    jump, the steps around it, one line a substep with the four contact
    diagnostics, the end) and `save=` writes [T, E, ...] arrays."""
    path, args = ckpts["antmaze-v1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", 3)
        out = trace_launch.main([path, *args, f"save={tmp_path / 'tr.npz'}"])
    text = capsys.readouterr().out
    assert f"saved trajectory -> {tmp_path / 'tr.npz'}" in text
    assert f"env {out['env']}: max |vxy|" in text and "first jump >5.0" in text
    assert "substep forensics at t=" in text and "  end  z=" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("  s=")]
    assert len(lines) == 10 == len(out["substeps"])
    assert all(k in lines[0] for k in ("pen_floor_max=", "pen_wall_max=",
                                       "Fz_sum=", "Fxy_max="))
    tr = np.load(tmp_path / "tr.npz")
    assert tr["qpos"].shape == (3, 4, 15) and tr["qvel"].shape == (3, 4, 14)
    assert tr["act"].shape == (3, 4, 8) and tr["done"].shape == (3, 4)
    assert tr["done"][-1].all()


def test_trace_launch_diagnostics_match_jax_engine():
    """trace_launch's diagnostics (the port's engine_cl on the AABB walls)
    at ants against antmaze-v1's walls equal the JAX tool's, computed as it
    computes them on the per-env engine (fk, subspaces, velocities,
    `_sphere_points`, `_point_box_distance`, `contact_forces`), within
    1e-4 relative to max(1, |value|)."""
    from ddiffpg_tpu.envs.antmaze import AntMazeEnv as JaxAntMaze
    from ddiffpg_tpu.physics import engine as jengine
    from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv

    # no stale structure of a freed model of this module (port_fixtures.py)
    jengine._STRUCT_CACHE.clear()
    jm = JaxAntMaze("antmaze-v1").model

    @jax.jit
    def jdiag(qpos, qvel):
        body_pos, body_quat = jengine.fk(jm, qpos)
        S = jengine.dof_subspaces(jm, body_pos, body_quat)
        V = jengine.body_velocities(
            jm, S, jengine.qvel_to_u(jm, qvel, body_pos))
        gpos, gquat = jengine._geom_world(jm, body_pos, body_quat)
        pts, rads, _ = jengine._sphere_points(jm, gpos, gquat)
        d_b, _ = jengine._point_box_distance(
            pts[:, None, :], jnp.asarray(jm.static_box_min)[None],
            jnp.asarray(jm.static_box_max)[None])
        F = jengine.contact_forces(jm, body_pos, body_quat, V)
        return (jnp.maximum(-(pts[:, 2] - rads), 0.0).max(),
                jnp.maximum(-(d_b - rads[:, None]), 0.0).max(),
                F[:, 5].sum(), jnp.abs(F[:, 3:5]).max())

    eng = trace_launch.box_engine(AntMazeEnv(device="cpu").model, "cpu")
    rng = np.random.RandomState(7)
    walls = 0
    for _ in range(6):
        qpos = np.asarray(jm.init_qpos, np.float32).copy()
        qpos[:3] = (rng.uniform(-1.9, -1.5), rng.uniform(-1, 1),
                    rng.uniform(0.3, 0.7))
        qpos[7:] += rng.uniform(-0.3, 0.3, 8).astype(np.float32)
        qvel = rng.uniform(-2, 2, 14).astype(np.float32)
        got = trace_launch.diagnostics(eng, torch.tensor(qpos),
                                       torch.tensor(qvel))
        want = dict(zip(("pen_floor_max", "pen_wall_max", "Fz_sum",
                         "Fxy_max"), (float(v) for v in jdiag(qpos, qvel))))
        assert list(got) == list(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), \
                (k, got[k], want[k])
        walls += want["pen_wall_max"] > 0.01
    assert walls >= 3


def test_tools_eval_env_steps_engine_cl():
    """The tools' eval env takes the JAX tools' physics: engine_cl
    (`use_pallas=False`) for the ant and Panda, pointmaze's own step."""
    from ddiffpg_tpu_torch.physics.engine_cl import Engine

    for name, engine in (("antmaze-v1", True), ("PandaReachJoints-v3", True),
                         ("pointmaze-v1", False)):
        cfg = C.Config(algo=C.algo_preset("ddiffpg")).override_strings(
            [f"env.name={name}", "device=cpu"])
        env = common.eval_env(cfg, 2, 0, random_init=True)
        assert isinstance(getattr(env.env, "engine", None), Engine) == engine
        state, obs = env.reset()
        _, obs, _, _, _ = env.step(state, torch.zeros(2, env.action_dim))
        assert bool(torch.isfinite(obs).all())


@pytest.mark.parametrize("tool", [eval_ckpt, eval_goals, eval_modes,
                                  trace_goals, probe_qfield, probe_energy,
                                  trace_launch])
def test_tools_need_a_card_unless_told_cpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=auto runs there")
    args = [] if tool is probe_energy else [str(tmp_path / "none.pt"),
                                            "env=antmaze-v1"]
    with pytest.raises(RuntimeError, match="device=auto needs a CUDA card"):
        tool.main(args)
    with pytest.raises(SystemExit, match="unknown key"):
        tool.main(args + ["nonsense=1"])
