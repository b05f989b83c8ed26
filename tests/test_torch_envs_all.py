"""Every env name of the JAX package's registry in the port: the registry,
Panda's `ee` control (Jacobian, DLS IK, control targets and one env step
against the JAX package, on the kernel's plain version and on `engine_cl`
with `use_pallas=False`; `tests/test_panda.py`'s ee tests re-run on the
port), `PointMazeEnv` against the vmapped JAX env, the eval's goal count,
the density grid of the largest maze, the recluster's track subsampling and
the hoisted kinematics against the per-call path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.envs import make as jax_make  # noqa: E402
from ddiffpg_tpu.envs.base import EnvState as JaxState  # noqa: E402
from ddiffpg_tpu.envs.panda import PandaTaskEnv as JaxPanda  # noqa: E402
from ddiffpg_tpu.modes.cluster import \
    ClusterManager as JaxClusterManager  # noqa: E402
from ddiffpg_tpu.physics import engine as jengine  # noqa: E402
from ddiffpg_tpu.physics import panda as JP  # noqa: E402
from ddiffpg_tpu.utils import density as jdensity  # noqa: E402
from ddiffpg_tpu_torch.agents.evaluation import eval_rollout  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.envs.base import EnvState  # noqa: E402
from ddiffpg_tpu_torch.envs.panda import PandaTaskEnv  # noqa: E402
from ddiffpg_tpu_torch.modes.cluster import ClusterManager  # noqa: E402
from ddiffpg_tpu_torch.physics import engine  # noqa: E402
from ddiffpg_tpu_torch.physics import maze  # noqa: E402
from ddiffpg_tpu_torch.physics import panda as P  # noqa: E402
from ddiffpg_tpu_torch.physics import quat as Q  # noqa: E402
from ddiffpg_tpu_torch.physics.types import (FIXED, FREE,  # noqa: E402
                                             HINGE, SLIDE)
from ddiffpg_tpu_torch.utils import density  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

MAZES = ["antmaze-v1", "antmaze-v2", "antmaze-v2-hard", "antmaze-v3",
         "antmaze-v4", "antmaze-v5"]
PANDA_NAMES = [f"Panda{task}{j}{d}{r}-v3"
               for task in ("Reach", "PegInsertion", "DrawerMulti", "Cabinet")
               for j in ("", "Joints") for d in ("", "Dense")
               for r in ("", "Random")]
ALL_NAMES = (MAZES + [n.replace("antmaze", "pointmaze") for n in MAZES]
             + PANDA_NAMES)
B = 8


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("name", ALL_NAMES)
def test_registry_makes_every_jax_name(name):
    """`make` builds every name the JAX registry accepts, with JAX's
    spaces, episode length, goal count and reward type, and resets to
    finite observations."""
    jenv = jax_make(name, num_envs=2)
    env = make(name, num_envs=2, device="cpu")
    assert (env.obs_dim, env.action_dim, env.max_episode_length) == \
        (jenv.obs_dim, jenv.action_dim, jenv.max_episode_length)
    for attr in ("num_goals", "reward_type", "random_init",
                 "control_type", "random_init_pos"):
        assert getattr(env.env, attr, None) == getattr(jenv.env, attr, None)
    jgoals = getattr(jenv.env, "goal_xy", None)
    if jgoals is not None:
        np.testing.assert_array_equal(env.env.goal_xy.numpy(),
                                      np.asarray(jgoals, np.float32))
        np.testing.assert_array_equal(env.env.goal_reward.numpy(),
                                      np.asarray(jenv.env.goal_reward))
    state, obs = env.reset()
    assert obs.shape == (2, env.obs_dim) and bool(torch.isfinite(obs).all())


def test_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown env"):
        make("halfcheetah-v3", device="cpu")
    with pytest.raises(ValueError, match="control_type"):
        PandaTaskEnv("Reach", control_type="joint", device="cpu")


# ------------------------------------------------------ Panda ee control

def _arm_states(env, seed):
    """B arm poses as tests/test_torch_panda_env.py draws them, the init
    pose plus U(-0.1, 0.1) on the arm joints, zero velocities, and actions
    U(-1.2, 1.2) (some clipped); env 2 is at the last step of its
    episode. DrawerMulti's env 0 has drawer 0 at 0.031,
    next to the goal, and env 1 drawer 2 at 0.02, inside it."""
    m, meta = env.model, env.meta
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (B, 7))
    if env.task == "DrawerMulti":
        qpos[0, meta["task_qposadr"][0]] = 0.031
        qpos[1, meta["task_qposadr"][2]] = 0.02
    act = rng.uniform(-1.2, 1.2, (B, env.action_dim)).astype(np.float32)
    t = rng.randint(0, 90, B).astype(np.int32)
    t[2] = 99
    return qpos, act, t


@functools.cache
def _jax_ee(task, reward_type, random_init):
    """The JAX env and one jitted program of its ee control for a batch:
    the control targets, one `step_batched` and the arm noise of its
    resets, and for DrawerMulti also the ee Jacobian and position at qpos
    and the ee control's own IK target (clip(p_ee + 0.05 a), z >= 0;
    Reach's arm is the same). One compile (20-30 s on a CPU) serves every
    test of the task."""
    jenv = JaxPanda(task, reward_type=reward_type, control_type="ee",
                    random_init_pos=random_init, use_pallas=False)
    m, meta = jenv.model, jenv.meta

    def one(q, a):
        bp, bq = jengine.fk(m, q)
        J, p = JP.ee_jacobian(m, meta, bp, bq)
        target = (p + jnp.clip(a, -1.0, 1.0)[:3] * 0.05).at[2].max(0.0)
        return J, p, target

    def program(state, act):
        k = jax.vmap(jax.random.split)(state.key)[:, 0]
        k_noise = jax.vmap(jax.random.split)(k)[:, 0]
        noise = jax.vmap(lambda kk: jax.random.uniform(
            kk, (7,), minval=-0.1, maxval=0.1))(k_noise)
        parts = (noise, jax.vmap(jenv._ctrl_from_action)(state.qpos, act))
        if task == "DrawerMulti":
            parts += jax.vmap(one)(state.qpos, act)
        return parts, jenv.step_batched(state, act)

    return jenv, jax.jit(program)


def _ee_case(task, reward_type="sparse", random_init=False, seed=0):
    jenv, program = _jax_ee(task, reward_type, random_init)
    env = PandaTaskEnv(task, reward_type=reward_type, control_type="ee",
                       random_init_pos=random_init, device="cpu")
    qpos, act, t = _arm_states(env, seed)
    jstate = JaxState(jnp.asarray(qpos), jnp.zeros((B, env.model.nv)),
                      jnp.asarray(t),
                      jax.random.split(jax.random.PRNGKey(seed), B))
    parts, jstep = program(jstate, jnp.asarray(act))
    parts = [np.asarray(x) for x in parts]
    return env, qpos, act, t, parts, jstep


def test_ee_jacobian_and_ik_match_jax():
    """`Arm.ee_jacobian` at B random arm poses against JAX's `ee_jacobian`
    (float32 cross products of rotated axes, 2e-6), and `Arm.dls_ik` to
    the ee control's targets against JAX's `dls_ik` (three damped steps,
    the 3x3 system by adjugate over the determinant, 1e-5). JAX's IK is
    read from its control targets: at these poses no joint limit clamps
    them, so they are `dls_ik`'s output itself."""
    env, qpos, act, t, (_, ctrl, J, p, target), _ = _ee_case("DrawerMulti")
    ik = ctrl[:, :7]
    assert ((ik > np.asarray(P.JOINT_LIMIT_LO))
            & (ik < np.asarray(P.JOINT_LIMIT_HI))).all()
    bp, bq = env.arm.kin.fk(torch.tensor(qpos))
    tJ, tp = env.arm.ee_jacobian(bp, bq)
    np.testing.assert_allclose(tJ.numpy(), J, atol=2e-6, rtol=0)
    np.testing.assert_allclose(tp.numpy(), p, atol=2e-6, rtol=0)
    got = env.arm.dls_ik(torch.tensor(qpos), torch.tensor(target))
    np.testing.assert_allclose(got.numpy(), ik, atol=1e-5, rtol=0)
    # the module functions of a scene met once give the same
    np.testing.assert_array_equal(
        P.ee_jacobian(env.model, env.meta, bp, bq)[0].numpy(), tJ.numpy())
    np.testing.assert_array_equal(
        P.dls_ik(env.model, env.meta, torch.tensor(qpos),
                 torch.tensor(target)).numpy(), got.numpy())


@pytest.mark.parametrize("task,reward_type,random_init", [
    ("Reach", "dense", True), ("DrawerMulti", "sparse", False)])
def test_ee_ctrl_matches_jax(task, reward_type, random_init):
    """The ee control's servo targets (IK, joint-limit clamp, fingers or
    the blocked gripper) from actions, some outside [-1, 1], against
    JAX's `_ctrl_from_action`: 1e-5."""
    env, qpos, act, t, (_, ctrl, *_), _ = _ee_case(task, reward_type,
                                                   random_init)
    assert env.action_dim == (3 if task == "Reach" else 4)
    got = env._ctrl_from_action(torch.tensor(qpos), torch.tensor(act))
    np.testing.assert_allclose(got.numpy(), ctrl, atol=1e-5, rtol=0)


@pytest.mark.parametrize("task,reward_type,random_init", [
    ("Reach", "dense", True), ("DrawerMulti", "sparse", False)])
def test_ee_env_step_matches_jax(task, reward_type, random_init):
    """One ee control step at B=8 against the JAX CPU path (engine_cl),
    from the same state, JAX's reset draws fed in; bounds of
    tests/test_torch_panda_env.py: ee position, task joints and dense
    reward 1e-4, qpos 1e-3, velocities 5e-2; reward, done, success id and
    time-outs exact. DrawerMulti's env 1 starts inside the goal.
    The servo targets are JAX's, held to the port's own at 1e-5 by
    test_ee_ctrl_matches_jax: within the step the stiff servos amplify
    them (moving Reach's targets by 1e-6 moves its ee by up to 4e-5 after
    one control step; the port's own targets, 1e-6 from JAX's, move it by
    2e-4), so the step is held to JAX from JAX's targets."""
    env, qpos, act, t, parts, jstep = _ee_case(task, reward_type,
                                               random_init)
    noise = torch.tensor(parts[0]) if random_init else None
    ctrl = torch.tensor(parts[1])
    np.testing.assert_allclose(
        env._ctrl_from_action(torch.tensor(qpos), torch.tensor(act)).numpy(),
        parts[1], atol=1e-5, rtol=0)
    env._ctrl_from_action = lambda q, a: ctrl
    state = EnvState(torch.tensor(qpos), torch.zeros(B, env.model.nv),
                     torch.tensor(t))
    new, obs, rew, done, info = env.step_batched(state, torch.tensor(act),
                                                 reset_xy=noise)
    jnew, jobs, jrew, jdone, jinfo = jstep
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(info["success"].numpy(),
                                  np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(info["time_outs"].numpy(),
                                  np.asarray(jinfo["time_outs"]))
    if reward_type == "dense":
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-4,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    jobs = np.asarray(jobs)
    np.testing.assert_allclose(obs[:, :3].numpy(), jobs[:, :3], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(obs[:, 3:6].numpy(), jobs[:, 3:6], atol=5e-2,
                               rtol=0)
    np.testing.assert_allclose(obs[:, 6:].numpy(), jobs[:, 6:], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_allclose(new.qpos.numpy(), np.asarray(jnew.qpos),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(new.qvel.numpy(), np.asarray(jnew.qvel),
                               atol=5e-2, rtol=0)
    assert bool(done[2])                            # truncated at 100 steps
    if task == "DrawerMulti":
        assert done[:2].tolist() == [False, True]
        assert int(info["success"][1]) == 3 and float(rew[1]) == 10.0


def test_drawer_ee_engine_cl_step_matches_jax():
    """PandaDrawerMulti-v3 (`ee` control) with use_pallas=False from the
    same arm states, with JAX's servo targets and reset draws fed in
    (tests/test_torch_envs_all.py's case: env 1 inside the goal, env 2 at
    its last step), against JAX's step: ee position and task joints 1e-4,
    qpos 1e-3, velocities 5e-2 (the stiff servos amplify ulps over 20
    substeps), reward, done, success and time-outs exact."""
    jenv, program = _jax_ee("DrawerMulti", "sparse", False)
    env = make("PandaDrawerMulti-v3", num_envs=B, device="cpu",
               use_pallas=False)
    assert env.env.engine is not None and env.env.kernel is None
    inner = env.env
    qpos, act, t = _arm_states(inner, 0)
    jstate = JaxState(jnp.asarray(qpos), jnp.zeros((B, inner.model.nv)),
                      jnp.asarray(t), jax.random.split(jax.random.PRNGKey(0),
                                                       B))
    parts, (jnew, jobs, jrew, jdone, jinfo) = program(jstate,
                                                      jnp.asarray(act))
    ctrl = torch.tensor(np.asarray(parts[1]))
    np.testing.assert_allclose(
        inner._ctrl_from_action(torch.tensor(qpos), torch.tensor(act)),
        ctrl, atol=1e-5, rtol=0)
    inner._ctrl_from_action = lambda q, a: ctrl
    new, obs, rew, done, info = env.step(
        EnvState(torch.tensor(qpos), torch.zeros(B, inner.model.nv),
                 torch.tensor(t)), torch.tensor(act))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(info["success"].numpy(),
                                  np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(info["time_outs"].numpy(),
                                  np.asarray(jinfo["time_outs"]))
    jobs = np.asarray(jobs)
    np.testing.assert_allclose(obs[:, :3].numpy(), jobs[:, :3], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(obs[:, 3:6].numpy(), jobs[:, 3:6], atol=5e-2,
                               rtol=0)
    np.testing.assert_allclose(obs[:, 6:].numpy(), jobs[:, 6:], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(new.qpos.numpy(), np.asarray(jnew.qpos),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(new.qvel.numpy(), np.asarray(jnew.qvel),
                               atol=5e-2, rtol=0)
    assert done[:3].tolist() == [False, True, True]


# test_panda.py's ee tests, on the port with the same inputs

def _reach():
    model, meta = P.build_panda_scene("Reach")
    return model, meta, torch.tensor(np.asarray(model.init_qpos))[None]


def test_jacobian_matches_finite_difference():
    model, meta, qpos = _reach()
    bp, bq = engine.fk(model, qpos)
    J, p0 = P.ee_jacobian(model, meta, bp, bq)
    adr = meta["arm_qposadr"]
    eps = 1e-4
    for k in range(7):
        qp = qpos.clone()
        qp[0, int(adr[k])] += eps
        bp2, bq2 = engine.fk(model, qp)
        p1 = P.ee_position(meta, bp2, bq2)
        fd = (p1 - p0) / eps
        np.testing.assert_allclose(J[0, :, k].numpy(), fd[0].numpy(),
                                   atol=2e-3)


def test_ik_converges():
    model, meta, qpos = _reach()
    bp, bq = engine.fk(model, qpos)
    p0 = P.ee_position(meta, bp, bq)
    target = p0 + torch.tensor([0.04, 0.02, 0.03])
    q_arm = P.dls_ik(model, meta, qpos, target, iters=5)
    q_new = qpos.clone()
    q_new[:, meta["arm_qposadr"]] = q_arm
    bp2, bq2 = engine.fk(model, q_new)
    p1 = P.ee_position(meta, bp2, bq2)
    assert float(torch.linalg.vector_norm(p1 - target)) < 0.01


def test_ee_control_mode():
    env = make("PandaReach-v3", num_envs=1, device="cpu")
    assert env.action_dim == 3
    st, obs0 = env.reset()
    a = torch.tensor([[1.0, 0.0, 0.0]])  # push +x
    for _ in range(10):
        st, obs, r, d, info = env.step(st, a)
    assert float(obs[0, 0] - obs0[0, 0]) > 0.03


# ------------------------------------------------------------- pointmaze

@functools.cache
def _jax_pointmaze(name, reward_type):
    """The vmapped JAX env, and jitted: its reset from keys, and one step
    returning also the xy its auto-resets draw."""
    jenv = jax_make(name, num_envs=16, reward_type=reward_type).env

    def step(state, action):
        rpos = jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k)[0], (2,), minval=-1.0, maxval=1.0))(
                state.key)
        return jax.vmap(jenv.step)(state, action), rpos

    return jenv, jax.jit(jax.vmap(jenv.reset)), jax.jit(step)


@pytest.mark.parametrize("name,reward_type", [
    ("pointmaze-v1", "sparse"), ("pointmaze-v2", "dense"),
    ("pointmaze-v2-hard", "sparse")])
def test_pointmaze_matches_jax(name, reward_type):
    """20 steps of 16 envs from JAX's reset draws against the vmapped JAX
    env, JAX's auto-reset draws fed in, the port stepped from its own
    state. Actions push each env along a fixed direction (most hit the
    start cell's walls within a few steps; the two passes of push-out
    and the normal-velocity removal run); envs 0.. start next to each
    goal. XLA contracts a * b + c into one FMA on the CPU (pos + vel dt,
    the norms), the port rounds the product, so the two part by about an
    ulp a step: positions 1e-6 + 1e-6 relative (an ulp is 9.5e-7 at 8 m),
    velocities (|v| <= 4, the wall normals from those norms) 1e-5, the
    dense reward 1e-6; sparse rewards, done, goal ids and time-outs
    exact."""
    jenv, jreset, jstep = _jax_pointmaze(name, reward_type)
    env = make(name, num_envs=16, reward_type=reward_type, device="cpu")
    n = 16
    jstate, _ = jreset(jax.random.split(jax.random.PRNGKey(3), n))
    goals = np.asarray(jenv.goal_xy, np.float32)
    qpos = np.asarray(jstate.qpos).copy()
    qpos[: len(goals)] = goals + np.float32(0.7)
    jstate = jstate._replace(qpos=jnp.asarray(qpos))
    state = EnvState(torch.tensor(qpos), torch.zeros(n, 2),
                     torch.zeros(n, dtype=torch.int32))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    act = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32) * 1.3
    act[: len(goals)] = -0.9
    hits = goals_hit = 0
    for k in range(20):
        (jstate, jobs, jrew, jdone, jinfo), rpos = jstep(jstate,
                                                         jnp.asarray(act))
        state, obs, rew, done, info = env.step(
            state, torch.tensor(act), reset_xy=torch.tensor(np.asarray(rpos)))
        jobs = np.asarray(jobs)
        np.testing.assert_allclose(obs[:, :2].numpy(), jobs[:, :2],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(obs[:, 2:].numpy(), jobs[:, 2:],
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(info["success"].numpy(),
                                      np.asarray(jinfo["success"]))
        np.testing.assert_array_equal(info["time_outs"].numpy(),
                                      np.asarray(jinfo["time_outs"]))
        if reward_type == "dense":
            np.testing.assert_allclose(rew.numpy(), np.asarray(jrew),
                                       atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_allclose(state.qpos.numpy(),
                                   np.asarray(jstate.qpos), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(state.qvel.numpy(),
                                   np.asarray(jstate.qvel), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        hits += int((obs[:, :2].abs() > 1.55).any(dim=1).sum())
        goals_hit += int((info["success"] > 0).sum())
    assert hits > 0 and goals_hit >= len(goals)


def test_pointmaze_walls_hold_and_goals_pay():
    """A disc driven into a wall stops 0.4 from it with no velocity into
    it; each goal pays its reward with its id, ends the episode and
    resets."""
    env = make("pointmaze-v2", num_envs=1, device="cpu")
    state, _ = env.reset(xy=torch.tensor([[1.5, 0.0]]))
    for _ in range(10):
        state, obs, rew, done, info = env.step(state,
                                               torch.tensor([[0.0, 1.0]]))
    # the reset cell's corridor runs along x between walls at y = +-2
    assert float(obs[0, 1]) == pytest.approx(1.6, abs=1e-5)
    assert float(obs[0, 3]) == 0.0 and not bool(done[0])
    env = make("pointmaze-v2", num_envs=2, device="cpu")
    state, _ = env.reset(xy=torch.tensor([[-8.0, 7.8], [7.8, 0.0]]))
    state, obs, rew, done, info = env.step(state, torch.zeros(2, 2))
    assert rew.tolist() == [20.0, 10.0] and bool(done.all())
    assert info["success"].tolist() == [1, 2]
    assert not bool(info["time_outs"].any())
    assert state.t.tolist() == [0, 0]
    assert float(state.qpos.abs().max()) <= 1.0


# ------------------------------------------------------- eval goal count

def test_eval_counts_goals_without_num_goals():
    """pointmaze-v2 has two goals in `goal_xy` and no `num_goals`: the eval
    logs each goal's rate, as the JAX eval's default
    (`len(getattr(inner, "goal_xy", [0]))`) does."""
    env = make("pointmaze-v2", num_envs=4, device="cpu")
    assert not hasattr(env.env, "num_goals")
    metrics, xy = eval_rollout(env, lambda obs: torch.zeros(4, 2),
                               reset_xy=torch.tensor(
                                   [[-8.0, 7.8], [7.8, 0.0], [0.0, 0.0],
                                    [0.5, 0.5]]))
    goal_keys = sorted(k for k in metrics if k.startswith(
        "eval/success_goal"))
    assert goal_keys == ["eval/success_goal1", "eval/success_goal2"]
    assert xy.shape == (100, 4, 2)
    assert metrics["eval/success_goal1"] > 0
    assert metrics["eval/success_goal2"] > 0


# -------------------------------------------------------- density, tracks

def test_density_grid_on_antmaze_v3():
    """`create_grid` and `update` on v3's 459 grid (9 cells of 51) against
    the JAX package's, with positions in free cells, in walls and off the
    maze."""
    grid, reset, free = density.create_grid(maze.MAZE_v3, 459)
    jgrid, jreset, jfree = jdensity.create_grid(maze.MAZE_v3, 459)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(reset, jreset)
    assert free == jfree
    rng = np.random.RandomState(0)
    g, jg = torch.tensor(grid), jnp.asarray(jgrid)
    for _ in range(3):
        xy = rng.uniform(-20, 20, (256, 2)).astype(np.float32)
        g = density.update(g, torch.tensor(xy), 4.0, reset, 9)
        jg = jdensity.update(jg, jnp.asarray(xy), 4.0, jreset, 9)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert float(density.coverage(g, free)) == pytest.approx(
        float(jdensity.coverage(jg, jfree)))


@pytest.mark.parametrize("name", ALL_NAMES[:12])
def test_stock_density_grid_as_jax(name):
    """The agent's density grid at the stock config of every maze name:
    built where the JAX package builds it, refused where it refuses it
    (antmaze-v2-hard, v5 and pointmaze but v1 have no preset, and their
    7 or 9 rows do not divide the stock resolution 255)."""
    from ddiffpg_tpu import config as jax_config
    from ddiffpg_tpu_torch import config

    maze_map = maze.MAZES[name.replace("pointmaze", "antmaze")]
    res = config.preprocess(config.Config().override(
        **{"env.name": name})).env.resolution
    assert res == jax_config.preprocess(jax_config.Config().override(
        **{"env.name": name})).env.resolution
    try:
        jdensity.create_grid(maze_map, res)
    except AssertionError:
        with pytest.raises(ValueError, match="not a multiple"):
            density.create_grid(maze_map, res)
    else:
        np.testing.assert_array_equal(density.create_grid(maze_map, res)[0],
                                      jdensity.create_grid(maze_map, res)[0])


@pytest.mark.parametrize("downsampling", [False, True])
def test_tracks_subsample_long_episodes(downsampling):
    """700-step tracks (antmaze-v3/v4) are cut to `dtw_max_len` points as
    the JAX ClusterManager cuts them, and with `use_downsampling` to the
    given length; shorter tracks stay whole."""
    rng = np.random.RandomState(0)
    tracks = rng.randn(4, 701, 3).astype(np.float32)
    lengths = np.array([700, 512, 513, 300])
    kw = dict(capacity=4, dtw_max_len=512, use_downsampling=downsampling,
              traj_dim=3)
    ours = ClusterManager(device="cpu", **kw)
    theirs = JaxClusterManager(**kw)
    target = 100 if downsampling else None
    a = ours._tracks(range(4), tracks, lengths, target)
    b = theirs._tracks(range(4), tracks, lengths, target)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    want = [100] * 4 if downsampling else [512, 512, 512, 300]
    assert [len(x) for x in a] == want


# --------------------------------------------------- the kinematics hoist

def _fk_per_call(m, qpos):
    """`physics/engine.py:fk` as it was before `Kinematics`: the structure
    and every index and constant tensor rebuilt at each call."""
    levels, _ = engine._structure(m)

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=qpos.device)

    B = qpos.shape[0]
    pos = qpos.new_zeros((B, m.nb, 3))
    quat = qpos.new_zeros((B, m.nb, 4))
    quat[..., 0] = 1.0
    ident = const([1.0, 0.0, 0.0, 0.0])
    for jt, ids in levels:
        qa = torch.as_tensor(m.jnt_qposadr[ids], device=qpos.device)
        if jt == FREE:
            vals = qpos[:, qa[:, None] + torch.arange(7, device=qpos.device)]
            pos[:, ids] = vals[..., :3]
            quat[:, ids] = vals[..., 3:7]
            continue
        par = np.maximum(m.parent[ids], 0)
        is_root = torch.as_tensor(m.parent[ids] < 0,
                                  device=qpos.device)[:, None]
        pp = torch.where(is_root, 0.0, pos[:, par])
        pq = torch.where(is_root, ident, quat[:, par])
        p0 = pp + Q.rotate(pq, const(m.body_pos[ids]))
        q0 = Q.mul(pq, const(m.body_quat[ids]))
        if jt == HINGE:
            qj = Q.from_axis_angle(const(m.jnt_axis[ids]), qpos[:, qa])
            qn = Q.mul(q0, qj)
            anchor = const(m.jnt_pos[ids])
            pn = p0 + Q.rotate(q0, anchor) - Q.rotate(qn, anchor)
        elif jt == SLIDE:
            qn = q0
            pn = p0 + Q.rotate(q0, const(m.jnt_axis[ids])) \
                * qpos[:, qa][..., None]
        else:
            assert jt == FIXED
            qn, pn = q0, p0
        pos[:, ids] = pn
        quat[:, ids] = qn
    return pos, quat


def _velocities_per_call(m, qpos, qvel, body_pos, body_quat):
    """The ee state's subspaces and body velocities as they were computed
    before `Kinematics`."""
    def const(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    base = np.zeros((m.nv, 6), np.float32)
    for i in range(m.nb):
        if m.jnt_type[i] == FREE:
            d = int(m.jnt_dofadr[i])
            base[d: d + 3, 3:] = np.eye(3)
            base[d + 3: d + 6, :3] = np.eye(3)
    S = const(base).expand(qpos.shape[0], -1, -1).clone()
    hinge = np.where(m.jnt_type == HINGE)[0]
    if len(hinge):
        bq = body_quat[:, hinge]
        w = Q.rotate(bq, const(m.jnt_axis[hinge]))
        a = body_pos[:, hinge] + Q.rotate(bq, const(m.jnt_pos[hinge]))
        S[:, m.jnt_dofadr[hinge]] = torch.cat(
            [w, torch.linalg.cross(a, w)], dim=-1)
    slide = np.where(m.jnt_type == SLIDE)[0]
    if len(slide):
        w = Q.rotate(body_quat[:, slide], const(m.jnt_axis[slide]))
        S[:, m.jnt_dofadr[slide]] = torch.cat([torch.zeros_like(w), w],
                                              dim=-1)
    u = qvel.clone()
    for i in range(m.nb):
        if m.jnt_type[i] == FREE:
            d = int(m.jnt_dofadr[i])
            vp, w = qvel[:, d: d + 3], qvel[:, d + 3: d + 6]
            u[:, d: d + 3] = vp - torch.linalg.cross(w, body_pos[:, i])
    _, SUB = engine._structure(m)
    vJ = S.new_zeros((S.shape[0], m.nb, 6)).index_add_(
        1, torch.as_tensor(m.dof_body), S * u[..., None])
    return S, torch.einsum("ji,bjk->bik", const(SUB), vJ)


@pytest.mark.parametrize("scene", ["ant", "DrawerMulti", "PegInsertion"])
def test_kinematics_hoist_is_bitwise(scene):
    """`Kinematics`, built once, gives bit for bit what the per-call path
    gave: FK, the motion subspaces and the body velocities of 16 random
    states (the ant's free joint, Panda's hinges, slides and fixed
    bodies)."""
    rng = np.random.RandomState(1)
    if scene == "ant":
        m = make("antmaze-v1", device="cpu").env.model
        qpos = np.tile(np.asarray(m.init_qpos)[None], (16, 1))
        qpos[:, :3] += rng.uniform(-1, 1, (16, 3))
        qpos[:, 3:7] = rng.randn(16, 4)
        qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
        qpos[:, 7:] += rng.uniform(-0.5, 0.5, (16, m.nq - 7))
    else:
        m, _ = P.build_panda_scene(scene)
        qpos = np.tile(np.asarray(m.init_qpos)[None], (16, 1))
        qpos += rng.uniform(-0.3, 0.3, qpos.shape)
    qpos = torch.tensor(qpos, dtype=torch.float32)
    qvel = torch.tensor(rng.uniform(-1, 1, (16, m.nv)), dtype=torch.float32)
    kin = engine.Kinematics(m, "cpu")
    pos, quat = kin.fk(qpos)
    want_pos, want_quat = _fk_per_call(m, qpos)
    assert torch.equal(pos, want_pos) and torch.equal(quat, want_quat)
    S = kin.dof_subspaces(pos, quat)
    V = kin.body_velocities(S, kin.qvel_to_u(qvel, pos))
    want_S, want_V = _velocities_per_call(m, qpos, qvel, pos, quat)
    assert torch.equal(S, want_S) and torch.equal(V, want_V)
    # the module functions build a Kinematics a call
    assert torch.equal(engine.fk(m, qpos)[0], pos)
    assert torch.equal(engine.body_velocities(
        m, engine.dof_subspaces(m, pos, quat),
        engine.qvel_to_u(m, qvel, pos)), V)
