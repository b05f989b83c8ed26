"""The port's training loop on the CPU: eval rollouts, checkpoints, signals,
resume, and the device choice of the entry point.

`eval_rollout` against the JAX package's, with one deterministic actor on
both sides (tanh of a fixed linear map of the obs), the same reset state
(JAX's draw fed in) and two goals placed beside envs 0 and 1, so the
success, per-goal and auto-reset paths run: metrics within 1e-5 (the
episode sums of float32 rewards and lengths; the physics agree to
tests/test_torch_antmaze.py's 2e-5, far from any goal's 0.5 m edge).

`train.main` at a tiny config (antmaze-v1 with 8-step episodes, 8 envs,
4 eval envs, eval every 2 iterations): warm-up, the initial recluster,
two evals, a recluster, a light checkpoint, then SIGUSR1 and SIGTERM sent
to the own process from inside the loop: two full checkpoints, a clean
stop and the final checkpoint. The train env's goal sits at (1.5, 1.5)
and envs 0 and 1 always start beside it, so every step stores two
successes beside the other envs' failures: the initial recluster finds
modes, and the eval at iteration 0 (on the eval_freq * 5 cadence) draws
all five maze plots. The resumed run is made without matplotlib: it says
once that it skips the plots, and draws none.
"""

import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.agents.evaluation import eval_rollout as jax_eval  # noqa
from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu_torch import train  # noqa: E402
from ddiffpg_tpu_torch.agents import ddiffpg  # noqa: E402
from ddiffpg_tpu_torch.agents.evaluation import eval_rollout  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.physics import maze  # noqa: E402
from ddiffpg_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

EPISODE = 8
GOAL = (1.5, 1.5)
NEAR_GOAL = ((1.7, 1.5), (1.5, 1.2))     # envs 0 and 1, within 0.5 m
TINY = ["device=cpu", "num_envs=8", "eval_num_envs=4", "algo.warm_up=8",
        "algo.batch_size=64", "algo.update_times=1", "algo.memory_size=32",
        "diffusion.update_times=2", "diffusion.diffusion_iter=2",
        "intrinsic.L=2", "eval_freq=2", "ckpt_freq_mult=1", "log_freq=1"]


def test_eval_rollout_matches_jax():
    E, T = 4, 8
    W = np.random.RandomState(0).randn(29, 8).astype(np.float32) * 0.3
    jenv = jax_make("antmaze-v1", num_envs=E, random_init=True)
    env = make("antmaze-v1", num_envs=E, random_init=True, device="cpu")
    key = jax.random.PRNGKey(4)
    k_reset, _ = jax.random.split(key)
    xy = np.asarray(jenv.reset(k_reset)[0].qpos[:, :2])
    goals = xy[:2] + np.array([[0.2, 0.0], [0.0, -0.3]], np.float32)
    corner = np.array([1.9, -1.9], np.float32)
    assert np.linalg.norm(goals - corner, axis=1).min() > 1.5
    for inner, conv in ((jenv.env, jnp.asarray), (env.env, torch.tensor)):
        inner.max_episode_steps = T
        inner.goal_xy = conv(goals)
        inner.goal_reward = conv(np.array([10.0, 20.0], np.float32))
        inner.num_goals = 2
    # auto-resets go to one fixed corner on both sides (the two packages'
    # random draws differ): JAX traces the eval's reset first, then the
    # auto-reset inside its step; the port's auto-resets draw with xy=None
    j_init, calls = jenv.env._init_state, []

    def j_fixed(k):
        calls.append(k)
        s = j_init(k)
        return s if len(calls) == 1 else s._replace(
            qpos=s.qpos.at[:2].set(jnp.asarray(corner)))

    p_init = env.env._init_state
    jenv.env._init_state = j_fixed
    env.env._init_state = lambda B, xy=None: p_init(
        B, torch.tensor(corner).expand(B, 2).clone() if xy is None else xy)
    jm, jxy = jax_eval(jenv, lambda w, k, obs: jnp.tanh(obs @ w), key,
                       jnp.asarray(W))
    m, got_xy = eval_rollout(env, lambda obs: torch.tanh(obs @ torch.tensor(
        W)), reset_xy=torch.tensor(xy))
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], float(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert m["eval/success_goal1"] > 0 and m["eval/success_goal2"] > 0
    assert got_xy.shape == (T, E, 2)
    np.testing.assert_allclose(got_xy[0].numpy(), xy, rtol=0, atol=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny run on the CPU, SIGUSR1 sent during the third train
    iteration and SIGTERM during the fourth. Returns (final state, run
    directory, its metrics records)."""
    logdir = tmp_path_factory.mktemp("runs")
    calls = []
    orig = ddiffpg.AgentDDiffPG.train_iter

    def train_iter(self, ts, steps=None):
        out = orig(self, ts, steps)
        calls.append(steps)
        if len(calls) in (3, 4):
            os.kill(os.getpid(), signal.SIGUSR1 if len(calls) == 3
                    else signal.SIGTERM)
        return out

    make_envs = train.make_envs

    def make_envs_near_goal(cfg, device):
        env, eval_env = make_envs(cfg, device)
        inner = env.env
        inner.goal_xy = torch.tensor([GOAL])
        init = inner._init_state

        def near_goal(B, xy=None):
            state = init(B, xy)
            state.qpos[:2, :2] = torch.tensor(NEAR_GOAL)
            return state
        inner._init_state = near_goal
        return env, eval_env

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", EPISODE)
        mp.setattr(ddiffpg.AgentDDiffPG, "train_iter", train_iter)
        mp.setattr(train, "make_envs", make_envs_near_goal)
        before = signal.getsignal(signal.SIGTERM)
        ts = train.main(TINY + ["max_step=100000", f"logdir={logdir}",
                                "run_name=tiny"])
        assert signal.getsignal(signal.SIGTERM) is before
    run_dir = logdir / "tiny"
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    return ts, run_dir, recs


def _fresh_state(cfg_args=TINY):
    from ddiffpg_tpu_torch import config as C
    from ddiffpg_tpu_torch.agents import make_agent

    cfg = C.preprocess(C.Config().override_strings(cfg_args)) \
        .override_strings(cfg_args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", EPISODE)
        env, _ = train.make_envs(cfg, torch.device("cpu"))
        return make_agent("DDiffPG", env, cfg, device="cpu").init()


def test_loop_runs_warmup_recluster_eval_and_checkpoints(run):
    ts, run_dir, recs = run
    names = sorted(p.name for p in run_dir.glob("ckpt_*.pt"))
    # warm-up 8 x 8 steps, then 8 a train iteration: the light checkpoint
    # at iteration 2, SIGUSR1's full one at the top of iteration 3 and
    # SIGTERM's at the top of iteration 4, and the final one
    assert names == ["ckpt_80.pt", "ckpt_88_full.pt", "ckpt_96_full.pt",
                     "ckpt_final.pt"]
    assert int(ts.global_step) == 96
    keys = set().union(*recs)
    for k in ("time/warmup_s", "time/recluster_s", "time/recluster_dtw_s",
              "time/eval_s", "time/ckpt_light_s", "time/ckpt_light_bytes",
              "time/ckpt_full_bytes", "time/ckpt_final_bytes",
              "time/train_iter_s", "eval/return", "eval/success_rate",
              "replay/num_modes", "train/critic_loss"):
        assert k in keys, k
    assert sum("eval/return" in r for r in recs) == 2
    assert sum("time/recluster_s" in r for r in recs) == 2
    light = [r for r in recs if "time/ckpt_light_bytes" in r][0]
    final = [r for r in recs if "time/ckpt_final_bytes" in r][0]
    assert light["time/ckpt_light_bytes"] < final["time/ckpt_final_bytes"]


def test_full_checkpoint_restores_every_tensor(run):
    ts, run_dir, _ = run
    blob = torch.load(run_dir / "ckpt_final.pt", weights_only=False)
    fresh, meta = ckpt.load(run_dir / "ckpt_final.pt", _fresh_state())
    got = dict(ckpt.leaves(fresh))
    want = dict(ckpt.leaves(ts))
    assert set(got) == set(want) and "replay.obs" in got
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    want_meta = blob["host_meta"]
    gens, want_gens = meta.pop("generators"), want_meta.pop("generators")
    assert meta == want_meta
    assert meta["num_groups"] > 1 and not meta.get("light")
    assert set(gens) == set(want_gens) == {"agent", "env", "eval_env",
                                           "eval"}
    for k in gens:
        assert torch.equal(gens[k], want_gens[k]), k


def test_light_checkpoint_leaves_replay_fresh(run):
    _, run_dir, _ = run
    blob = torch.load(run_dir / "ckpt_80.pt", weights_only=False)
    assert blob["host_meta"]["light"] and blob["skip"] == ["replay"]
    fresh = _fresh_state()
    replay0 = {k: v.clone() for k, v in ckpt.leaves(fresh.replay, "replay")}
    loaded, _ = ckpt.load(run_dir / "ckpt_80.pt", fresh)
    for k, v in ckpt.leaves(loaded):
        if k.startswith("replay."):
            assert torch.equal(v, replay0[k]), k
        else:
            assert torch.equal(v, blob["tensors"][k]), k


def test_resume_from_full_checkpoint(run, tmp_path, capsys):
    """A full resume skips the warm-up and continues from the saved step
    and generators; three more iterations with two evals, then the final
    checkpoint. Made where matplotlib cannot be imported: the run ends
    normally, says once that it skips the plots, and draws none."""
    _, run_dir, _ = run
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", EPISODE)
        mp.setitem(sys.modules, "matplotlib", None)
        ts = train.main(TINY + [f"resume={run_dir / 'ckpt_final.pt'}",
                                "max_step=120", f"logdir={tmp_path}",
                                "run_name=resumed"])
    assert int(ts.global_step) == 120
    recs = (tmp_path / "resumed" / "metrics.jsonl").read_text()
    assert "time/warmup_s" not in recs
    assert recs.count("eval/return") == 2
    out = capsys.readouterr().out
    assert out.count("maze plots skipped: matplotlib cannot be imported") \
        == 1
    assert "plotting failed" not in out
    assert not list((tmp_path / "resumed").glob("*.png"))


def test_loop_draws_the_five_plot_families(run):
    """The eval at iteration 0 draws the eval map and, on the
    eval_freq * 5 cadence, the initial recluster's clusters, dendrogram,
    failures by mode and the exploration heatmap; the eval at iteration 2
    only its map. Each is an RGB PNG."""
    import matplotlib.image as mpimg

    _, run_dir, _ = run
    names = sorted(p.name for p in run_dir.glob("*.png"))
    assert names == ["cluster_64.png", "eval_map_64.png", "eval_map_80.png",
                     "exploration_map_64.png", "hierarchy_64.png",
                     "unsuccess_cluster_64.png"], names
    for name in names:
        img = mpimg.imread(run_dir / name)
        assert img.ndim == 3 and img.shape[2] in (3, 4) and img.std() > 0


@pytest.mark.parametrize("device,err", [("auto", RuntimeError),
                                        ("tpu", ValueError)])
def test_entry_point_device_choice(device, err, tmp_path):
    """device=auto is the card and raises without one; only auto and cpu
    are accepted."""
    if device == "auto" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=auto trains there")
    with pytest.raises(err, match="device"):
        train.main([f"device={device}", f"logdir={tmp_path}"])
    assert not list(tmp_path.iterdir())


def test_run_modes_reads_the_final_checkpoint(run, capsys):
    """`tools/run_modes.py` rebuilds the run's agent from its command
    line, loads the full checkpoint and reports its live modes (those the
    last recluster found among the successes beside the goal)."""
    from ddiffpg_tpu_torch.tools import run_modes

    _, run_dir, _ = run
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(maze.EPISODE_LEN, "antmaze-v1", EPISODE)
        run_modes.main([str(run_dir / "ckpt_final.pt")] + TINY)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meta = torch.load(run_dir / "ckpt_final.pt",
                      weights_only=False)["host_meta"]
    assert out["env"] == "antmaze-v1"
    assert out["num_groups"] == meta["num_groups"] > 1
    assert [m["group"] for m in out["modes"]] == list(
        range(1, out["num_groups"]))


def test_run_modes_splits_routes_by_y():
    """Per live group: its successes, their goal ids, the mean position
    over the steps each trajectory lived, the share with mean y > 0."""
    from types import SimpleNamespace

    from ddiffpg_tpu_torch.tools.run_modes import mode_routes

    S, L = 5, 4
    obs = torch.zeros((S, L + 1, 3))
    obs[0, :3, 1], obs[1, :2, 1] = 4.0, 2.0          # up, lived 3 and 2
    obs[1, 2:, 1] = -100.0                           # past its length
    obs[2, :, 1], obs[3, :, 1] = -4.0, -4.0          # down
    obs[:, :, 0] = -8.0
    rep = SimpleNamespace(
        obs=obs, length=torch.tensor([2, 1, 4, 4, 4]),
        traj_id=torch.tensor([0, 1, 2, 3, -1]),
        success=torch.tensor([1, 1, 2, 0, 1], dtype=torch.int32),
        group_mask=torch.tensor([[1, 1, 1, 1, 1], [1, 1, 0, 0, 1],
                                 [0, 0, 1, 1, 0]], dtype=torch.bool))
    got = mode_routes(SimpleNamespace(replay=rep), 3, 2)
    assert got == [
        {"group": 1, "successes": 2, "goal_ids": [1],
         "mean_position": [-8.0, 3.0], "share_y_positive": 1.0},
        {"group": 2, "successes": 1, "goal_ids": [2],
         "mean_position": [-8.0, -4.0], "share_y_positive": 0.0}]
