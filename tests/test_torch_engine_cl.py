"""The port's batched engine (`ddiffpg_tpu_torch/physics/engine_cl.py`)
against the JAX package's `ddiffpg_tpu/physics/engine_cl.py` on the same
numpy-made states, and against the analytic checks of
`tests/test_physics.py` at their own thresholds.

Maxima seen after 5 substeps on the CPU (qpos / qvel): ant beside the
walls 1.2e-7 / 1.3e-6 (SDF) and 6.0e-8 / 2.4e-6 (AABB), DrawerMulti
1.2e-7 / 3.6e-6, Reach 9.3e-10 / 9.5e-7.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddiffpg_tpu.physics import engine_cl as J
from ddiffpg_tpu.physics import maze as JM
from ddiffpg_tpu.physics.ant import build_ant as jbuild_ant
from ddiffpg_tpu.physics.builder import BodySpec as JBody
from ddiffpg_tpu.physics.builder import GeomSpec as JGeom
from ddiffpg_tpu.physics.builder import JointSpec as JJoint
from ddiffpg_tpu.physics.builder import build as jbuild
from ddiffpg_tpu.physics.panda import build_panda_scene as jpanda
from ddiffpg_tpu_torch.physics import engine_cl as T
from ddiffpg_tpu_torch.physics import maze as TM
from ddiffpg_tpu_torch.physics import types as TT
from ddiffpg_tpu_torch.physics.ant import build_ant
from ddiffpg_tpu_torch.physics.builder import (BodySpec, GeomSpec, JointSpec,
                                               build)
from ddiffpg_tpu_torch.physics.panda import build_panda_scene
from tests.port_fixtures import (  # noqa: F401
    fresh_structure_cache, one_torch_thread)

N = lambda x: x.detach().cpu().numpy()  # noqa: E731


# ------------------------------------------------------------------ models

@functools.cache
def _models(name):
    """(JAX model, port model, extra) of a test scene, 5 substeps; built
    once and kept for the module, so that no JAX model gets a freed one's
    `id` (the JAX engine caches structures by it: tests/port_fixtures.py)."""
    if name.startswith("ant"):
        walls = (dict(**JM.compile_sdf(JM.MAZE_v1)), TM.compile_sdf(
            TM.MAZE_v1)) if name == "ant_sdf" else (
            dict(static_boxes=JM.compile_boxes(JM.MAZE_v1)),
            dict(static_boxes=TM.compile_boxes(TM.MAZE_v1)))
        return (jbuild_ant(dt=0.01, n_substeps=5, **walls[0]),
                build_ant(dt=0.01, n_substeps=5, **walls[1]), None)
    if name == "boxes":
        return _box_pair(jbuild, JBody, JGeom, JJoint), \
            _box_pair(build, BodySpec, GeomSpec, JointSpec), None
    task = {"drawer": "DrawerMulti", "reach": "Reach"}[name]
    jm, meta = jpanda(task, n_substeps=5)
    return jm, build_panda_scene(task, n_substeps=5)[0], meta


def _box_pair(build_fn, Body, Geom, Joint):
    """Two free bodies in the air: A carries a sphere and a box around
    x = 0.25 that overlaps A's own sphere (the self-mask's case), B a
    sphere that sits 5 cm inside A's box."""
    a = Body("a", "", joint=Joint(TT.FREE), geoms=[
        Geom(TT.SPHERE, (0.1,)), Geom(TT.BOX, (0.2, 0.2, 0.2),
                                      pos=(0.25, 0.0, 0.0))])
    b = Body("b", "", joint=Joint(TT.FREE), geoms=[Geom(TT.SPHERE, (0.1,))])
    init = np.zeros(14, np.float32)
    init[[2, 3, 7, 9, 10]] = (1.0, 1.0, 0.5, 1.0, 1.0)
    return build_fn([a, b], [], init_qpos=init, dt=0.01, n_substeps=5)


def _ant_states(m, B, seed, kind):
    """The JAX test's ant states; `wall`: torsos beside MAZE_v1's inner
    wall face at x = -2; `slam`: torsos 3-7 cm over the floor, falling at
    1-4 m/s (every body in contact)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, m.nv)).astype(np.float32)
    if kind == "wall":
        qpos[:, 0] = rng.uniform(-1.9, -1.5, B)
        qvel[:, 0] = rng.uniform(-3, -1, B)
    elif kind == "slam":
        qpos[:, 2] = rng.uniform(0.03, 0.07, B)
        qvel[:, 2] = rng.uniform(-4, -1, B)
    ctrl = rng.uniform(-1, 1, (B, m.nu)).astype(np.float32)
    return qpos, qvel, ctrl


def _panda_states(m, meta, B, seed):
    """tests/test_engine_cl.py's Panda states: servo targets near
    neutral."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qvel = rng.uniform(-0.2, 0.2, (B, m.nv)).astype(np.float32)
    ctrl = np.tile(np.concatenate([meta["neutral"], [0.015, 0.015]])[None],
                   (B, 1)).astype(np.float32)
    ctrl[:, :7] += rng.uniform(-0.05, 0.05, (B, 7))
    return qpos, qvel, ctrl


def _box_states(m, B, seed):
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qvel = rng.uniform(-0.5, 0.5, (B, m.nv)).astype(np.float32)
    qpos[:, 7] += rng.uniform(-0.02, 0.02, B)
    return qpos, qvel, np.zeros((B, 0), np.float32)


# ------------------------------------------------------------------ steps

STEP_TOL = {"ant_sdf": (2e-5, 2e-4), "ant_boxes": (2e-5, 2e-4),
            "drawer": (5e-5, 5e-3), "reach": (5e-5, 5e-3)}


@pytest.mark.parametrize("name", list(STEP_TOL))
def test_step_matches_jax(name):
    """One control step (5 substeps) on 6 envs: ant qpos 2e-5 and qvel
    2e-4 (tests/test_engine_cl.py's), Panda qpos 5e-5 and qvel 5e-3. The
    SDF case starts beside a wall and asserts SDF contacts."""
    jm, tm, meta = _models(name)
    if name.startswith("ant"):
        args = _ant_states(tm, 6, 0, "wall")
    else:
        args = _panda_states(tm, meta, 6, 1)
    want = jax.jit(lambda a, b, c: J.step(jm, a, b, c))(
        *[jnp.asarray(a) for a in args])
    eng = T.Engine(tm, "cpu")
    qp, qv, ct = (torch.as_tensor(a) for a in args)
    got = eng.step(qp, qv, ct)
    tol = STEP_TOL[name]
    for g, w, t in zip(got, want, tol):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=t, rtol=0)
    if name.startswith("ant"):
        bp, bq = eng.fk(qp)
        S = eng.kin.dof_subspaces(bp, bq)
        V = eng.body_velocities(S, eng.kin.qvel_to_u(qv, bp))
        diag = {}
        eng.contact_forces(bp, bq, V, diag=diag)
        assert float(diag["pen_wall"].max()) > 0.01, name
    # the module-level step is the engine's
    for a, b in zip(T.step(tm, qp, qv, ct), got):
        assert torch.equal(a, b)


# --------------------------------------------------------------- contacts

def _contact_inputs(eng, qpos, qvel):
    """The robot-centred inputs of `contact_forces` at (qpos, qvel)."""
    bp, bq = eng.fk(qpos)
    p0 = bp.mean(1)
    S = eng.kin.dof_subspaces(bp - p0[:, None], bq)
    V = eng.body_velocities(S, eng.kin.qvel_to_u(qvel, bp - p0[:, None]))
    return bp, bq, V, p0


BRANCHES = {
    # branch: (scene, states, the diagnostic that shows it ran)
    "plane": ("ant_boxes", "random", lambda d: d["pen_floor"].max() > 0),
    "sdf_walls": ("ant_sdf", "wall", lambda d: d["pen_wall"].max() > 0.01),
    "aabb_walls": ("ant_boxes", "wall",
                   lambda d: d["pen_wall"].max() > 0.01),
    "dynamic_boxes": ("boxes", "boxes",
                      lambda d: d["pen_box"][:, 0, 1].min() > 0.03),
    "body_budget": ("ant_boxes", "slam", lambda d: d["s_body"].min() < 0.5),
    "thrust_budget": ("ant_sdf", "slam", lambda d: d["s_up"].max() < 0.95),
}


@functools.cache
def _jax_contacts(scene):
    """JAX's `contact_forces` of a scene, jitted once per module."""
    jm = _models(scene)[0]
    return jax.jit(lambda a, b, c, d: J.contact_forces(jm, a, b, c, d))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_contact_branch_matches_jax(branch):
    """`contact_forces` on states where each branch acts, against JAX's
    on the same robot-centred inputs, within 1e-4 of the largest force:
    the plane; the SDF walls; the AABB walls; the dynamic OBB boxes, whose
    own body's probes are masked (A's sphere lies inside A's box and gets
    no force from it, B's does); the per-body impulse budget and the
    global vertical-thrust budget (both binding on slamming ants)."""
    scene, kind, acted = BRANCHES[branch]
    _, tm, _ = _models(scene)
    eng = T.Engine(tm, "cpu")
    if kind == "boxes":
        args = _box_states(tm, 4, 2)
    else:
        args = _ant_states(tm, 8, 3, kind)
    qp, qv = torch.as_tensor(args[0]), torch.as_tensor(args[1])
    bp, bq, V, p0 = _contact_inputs(eng, qp, qv)
    diag = {}
    got = eng.contact_forces(bp, bq, V, p0, diag=diag)
    assert bool(acted(diag)), branch
    if kind == "boxes":
        # A's own sphere (probe 0) penetrates its box, masked to 0
        assert float(diag["pen_box"][:, 0, 0].abs().max()) == 0.0
    want = _jax_contacts(scene)(
        jnp.asarray(np.transpose(N(bp), (1, 2, 0))),
        jnp.asarray(np.transpose(N(bq), (1, 2, 0))),
        jnp.asarray(np.transpose(N(V), (1, 2, 0))), jnp.asarray(N(p0).T))
    want = np.transpose(np.asarray(want), (2, 0, 1))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(N(got), want, atol=1e-4 * scale, rtol=0)


def test_chol_solve_clamps_and_solves():
    """The column Cholesky solves SPD systems as JAX's
    `_chol_solve_envs_last` and `jnp.linalg.solve` do, and clamps a
    non-positive pivot at 1e-9 as JAX's does."""
    rng = np.random.RandomState(0)
    A = rng.randn(5, 14, 14).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 14 * np.eye(14, dtype=np.float32)
    b = rng.randn(5, 14).astype(np.float32)
    x = T.chol_solve(torch.as_tensor(M), torch.as_tensor(b))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", M, N(x)), b,
                               atol=2e-4)
    want = jax.jit(jax.vmap(lambda m, v: jnp.linalg.solve(m, v)))(M, b)
    np.testing.assert_allclose(N(x), np.asarray(want), atol=1e-5)
    from ddiffpg_tpu.physics.engine import _chol_solve_envs_last
    cl = jax.jit(_chol_solve_envs_last)
    want = np.asarray(cl(np.moveaxis(M, 0, -1), b.T)).T
    np.testing.assert_allclose(N(x), want, atol=1e-5)
    # a singular matrix: the pivot is clamped (no raise); JAX's and the
    # port's solves are non-finite alike
    bad = np.zeros((1, 3, 3), np.float32)
    out = T.chol_solve(torch.as_tensor(bad), torch.ones(1, 3))
    want = np.asarray(cl(np.moveaxis(bad, 0, -1), np.ones((3, 1),
                                                         np.float32))).T
    np.testing.assert_array_equal(np.isfinite(N(out)), np.isfinite(want))


# ------------------------------------------------ analytic checks (port)

def _free_sphere(z0=5.0, **kw):
    body = BodySpec("ball", "", joint=JointSpec(TT.FREE),
                    geoms=[GeomSpec(TT.SPHERE, (0.1,), density=1000.0)])
    init = np.zeros(7, np.float32)
    init[2] = z0
    init[3] = 1.0
    return build([body], [], init_qpos=init, **kw)


def _pendulum():
    body = BodySpec(
        "rod", "", pos=(0, 0, 2.0), joint=JointSpec(TT.HINGE, axis=(0, 1, 0)),
        geoms=[GeomSpec(TT.SPHERE, (0.05,), pos=(1.0, 0.0, 0.0),
                        density=1000.0)])
    return build([body], [("rod", 1.0)], dt=0.001, n_substeps=10)


SPHERE_M = 1000.0 * 4 / 3 * np.pi * 0.05 ** 3
I_HINGE = SPHERE_M * 1.0 ** 2 + 2 / 5 * SPHERE_M * 0.05 ** 2


def _run(m, qpos, qvel, n, ctrl=None, each=None):
    """n control steps of one env on the port's engine_cl."""
    eng = T.Engine(m, "cpu")
    qp = torch.as_tensor(np.asarray(qpos, np.float32))[None]
    qv = torch.as_tensor(np.asarray(qvel, np.float32))[None]
    for t in range(n):
        c = ctrl(t) if ctrl is not None else torch.zeros(1, m.nu)
        qp, qv = eng.step(qp, qv, c)
        if each is not None:
            each(t, qp[0], qv[0])
    return qp[0], qv[0]


def _ballistic():
    m = _free_sphere(z0=5.0, dt=0.01, n_substeps=10)
    qv0 = np.zeros(6)
    qv0[0] = 1.0
    qp, qv = _run(m, m.init_qpos, qv0, 5)
    t = 0.5
    np.testing.assert_allclose(float(qp[2]), 5.0 - 0.5 * 9.81 * t ** 2,
                               atol=0.03)
    np.testing.assert_allclose(float(qp[0]), 1.0 * t, atol=1e-3)
    np.testing.assert_allclose(float(qv[2]), -9.81 * t, atol=0.02)


def _spin():
    m = _free_sphere(z0=50.0, dt=0.01, n_substeps=10)
    qv0 = np.zeros(6)
    qv0[5] = 3.0
    _, qv = _run(m, m.init_qpos, qv0, 10)
    np.testing.assert_allclose(N(qv[3:6]), [0, 0, 3.0], atol=1e-4)


def _energy(q, qd):
    return 0.5 * I_HINGE * qd ** 2 + SPHERE_M * 9.81 * (2.0 - np.sin(q))


def _pendulum_energy():
    m = _pendulum()
    qp, qv = _run(m, [0.8], [0.0], 100)
    e0, e1 = _energy(0.8, 0.0), _energy(float(qp[0]), float(qv[0]))
    assert abs(e1 - e0) / e0 < 0.02


def _pendulum_frequency():
    m = _pendulum()
    omega = np.sqrt(SPHERE_M * 9.81 * 1.0 / I_HINGE)
    angles = []
    _run(m, [np.pi / 2 + 0.05], [0.0], 400,
         each=lambda t, qp, qv: angles.append(float(qp[0]) - np.pi / 2))
    crossings = np.where(np.diff(np.sign(angles)) != 0)[0]
    half_period = np.diff(crossings).mean() * 0.01
    np.testing.assert_allclose(np.pi / half_period, omega, rtol=0.05)


def _gravity_torque():
    m = _pendulum()
    eng = T.Engine(m, "cpu")
    qp, qv = torch.zeros(1, 1), torch.zeros(1, 1)
    bp, bq = eng.fk(qp)
    S = eng.kin.dof_subspaces(bp, bq)
    u = eng.kin.qvel_to_u(qv, bp)
    V = eng.body_velocities(S, u)
    I6 = eng.spatial_inertia(bp, bq)
    tau = eng.bias_forces(I6, S, V, u, torch.zeros(1, m.nb, 6))
    np.testing.assert_allclose(float(tau[0, 0]), -SPHERE_M * 9.81 * 1.0,
                               rtol=1e-3)


def _sphere_rests():
    m = _free_sphere(z0=0.3, dt=0.005, n_substeps=40)
    qp, qv = _run(m, m.init_qpos, np.zeros(6), 10)
    assert 0.02 < float(qp[2]) < 0.12
    assert abs(float(qv[2])) < 0.05
    np.testing.assert_allclose(N(qp[:2]), 0.0, atol=1e-4)


def _wall_blocks():
    boxes = np.array([((1.0, -5, 0.0), (2.0, 5, 3.0))], np.float32)
    m = dataclasses.replace(_free_sphere(z0=0.1, dt=0.005, n_substeps=40),
                            static_box_min=boxes[:, 0],
                            static_box_max=boxes[:, 1], nsb=1)
    qv0 = np.zeros(6)
    qv0[0] = 4.0
    qp, _ = _run(m, m.init_qpos, qv0, 10)
    assert float(qp[0]) < 1.0


def _ant_mass():
    m = build_ant()
    assert m.nq == 15 and m.nv == 14 and m.nb == 9 and m.nu == 8
    assert 0.3 < m.mass[0] < 0.6
    assert 0.8 < m.mass.sum() < 1.2


def _ant_settles():
    m = build_ant(dt=0.005, n_substeps=20)
    qp, qv = _run(m, m.init_qpos, m.init_qvel, 20)
    assert bool(torch.isfinite(qp).all()) and bool(torch.isfinite(qv).all())
    assert 0.2 <= float(qp[2]) <= 1.0
    assert float(torch.linalg.vector_norm(qv)) < 1.0


def _ant_moves():
    m = build_ant(dt=0.005, n_substeps=20)
    g = torch.Generator().manual_seed(0)
    qp, _ = _run(m, m.init_qpos, m.init_qvel, 30,
                 ctrl=lambda t: torch.rand((1, 8), generator=g) * 2 - 1)
    assert bool(torch.isfinite(qp).all())
    assert float(torch.linalg.vector_norm(qp[:2])) > 0.05


def _crba_spd():
    m = build_ant()
    eng = T.Engine(m, "cpu")
    rng = np.random.RandomState(1)
    qpos = np.asarray(m.init_qpos, np.float32).copy()
    qpos[7:] += rng.uniform(-0.3, 0.3, 8).astype(np.float32)
    bp, bq = eng.fk(torch.as_tensor(qpos)[None])
    M = N(eng.crba(eng.spatial_inertia(bp, bq),
                   eng.kin.dof_subspaces(bp, bq)))[0]
    np.testing.assert_allclose(M, M.T, atol=1e-5)
    assert np.linalg.eigvalsh(M).min() > 0


def _far_spin_bounded():
    m = _free_sphere(z0=0.5, dt=0.01, n_substeps=10)
    qpos = np.asarray(m.init_qpos).copy()
    qpos[:2] = (10.0, -8.0)
    qvel = np.zeros(6)
    qvel[3:6] = m.max_qvel
    qp, qv = _run(m, qpos, qvel, 1)
    assert float(qv.abs().max()) <= m.max_qvel + 1e-4
    assert float((qp[:3] - torch.as_tensor(qpos[:3])).abs().max()) <= \
        m.max_qvel * m.dt * m.n_substeps + 1e-4


def _impact(z0, vz, dt, n_sub):
    m = _free_sphere(z0=0.5, dt=dt, n_substeps=n_sub)
    qpos = np.asarray(m.init_qpos).copy()
    qpos[2] = z0
    qvel = np.zeros(6)
    qvel[2] = vz
    up = []
    qp, _ = _run(m, qpos, qvel, 100,
                 each=lambda t, qp, qv: up.append(float(qv[2])))
    assert max(up) <= m.contact_maxrebound + 0.05
    return qp


def _impact_dissipative():
    _impact(0.2, -8.0, 0.002, 5)


def _deep_impact():
    qp = _impact(0.02, -20.0, 0.01, 10)
    assert 0.05 <= float(qp[2]) <= 0.12


# tests/test_physics.py::TestFarFromOriginStability's captured launch state
QP = [-5.481694221496582, -2.5992870330810547, 0.500092625617981,
      0.9525787830352783, -0.08117830008268356, 0.044235583394765854,
      -0.2899087071418762, 0.5235987901687622, 0.5235987901687622,
      0.5235987901687622, -1.2217304706573486, 0.5235987901687622,
      -0.8046130537986755, 0.37590765953063965, 1.1036275625228882]
QV = [-0.8750934600830078, -1.3466997146606445, 0.24976640939712524,
      -0.24573275446891785, -0.21751752495765686, -2.2186524868011475,
      0.0, 0.0, 0.0, 0.0, 0.0, 2.4140796661376953, 3.993561029434204,
      1.186004877090454]


def _launch_actions():
    from tests.test_physics import TestFarFromOriginStability
    return TestFarFromOriginStability.ACT


def _launch_replay_bounded():
    m = build_ant(static_boxes=TM.compile_boxes(TM.MAZES["antmaze-v1"]),
                  dt=0.01, n_substeps=10)
    act = _launch_actions()
    peak = []
    qp, _ = _run(m, QP, QV, len(act),
                 ctrl=lambda t: torch.tensor([act[t]]),
                 each=lambda t, qp, qv: peak.append(
                     float(torch.linalg.vector_norm(qv[:2]))))
    assert max(peak) < 5.0, max(peak)
    assert float(qp[2]) < 1.0


def _momentum_far_from_origin():
    m = build_ant(static_boxes=TM.compile_boxes(TM.MAZES["antmaze-v1"]),
                  dt=0.01, n_substeps=10)
    eng = T.Engine(m, "cpu")
    mass = torch.as_tensor(np.asarray(m.mass, np.float32))

    def momentum(qp, qv):
        bp, bq = eng.fk(qp)
        p = bp - bp.mean(1)[:, None]
        S = eng.kin.dof_subspaces(p, bq)
        V = eng.body_velocities(S, eng.kin.qvel_to_u(qv, p))
        c = p + (eng.to_matrix(bq) * eng.com[:, None]).sum(-1)
        v_com = V[..., 3:] + torch.linalg.cross(V[..., :3], c)
        return (mass[:, None] * v_com[0]).sum(0)

    qp, qv = torch.tensor([QP]), torch.tensor([QV])
    worst = 0.0
    for a in _launch_actions():
        c = torch.tensor([a])
        for _ in range(m.n_substeps):
            before = momentum(qp, qv)
            qp, qv = eng.substep(qp, qv, c)
            worst = max(worst, float(torch.linalg.vector_norm(
                momentum(qp, qv) - before)))
    assert worst < 1.0, worst


def _thrashing_stays_inside():
    m = build_ant(static_boxes=TM.compile_boxes(TM.MAZES["antmaze-v2"]),
                  dt=0.01, n_substeps=10)
    qpos = np.asarray(m.init_qpos).copy()
    qpos[:2] = (-9.5, 9.0)
    qvel = np.zeros(m.nv)
    qvel[0] = -3.0
    g = torch.Generator().manual_seed(0)

    def inside(t, qp, qv):
        assert (qp[:2].abs() < 14.5).all(), (t, qp[:2])
    qp, _ = _run(m, qpos, qvel, 120,
                 ctrl=lambda t: torch.sign(torch.randn((1, 8), generator=g)),
                 each=inside)
    assert float(qp[2]) > -0.5


def _sdf_wall_blocks():
    m = build_ant(dt=0.01, n_substeps=10, **TM.compile_sdf(TM.MAZE_v1))
    eng = T.Engine(m, "cpu")
    qp = torch.as_tensor(np.asarray(m.init_qpos, np.float32)).repeat(4, 1)
    qp[:, 0] = -1.2
    qv = torch.zeros(4, m.nv)
    qv[:, 0] = -3.0
    for _ in range(10):
        qp, qv = eng.step(qp, qv, torch.zeros(4, 8))
    assert bool(torch.isfinite(qp).all())
    assert float(qp[:, 0].min()) > -2.2


ANALYTIC = {
    "free_fall_ballistic": _ballistic, "free_fall_spin": _spin,
    "pendulum_energy": _pendulum_energy,
    "pendulum_frequency": _pendulum_frequency,
    "pendulum_gravity_torque": _gravity_torque,
    "sphere_rests_on_plane": _sphere_rests, "wall_blocks": _wall_blocks,
    "ant_mass": _ant_mass, "ant_settles_upright": _ant_settles,
    "ant_actions_move_it": _ant_moves, "ant_crba_spd": _crba_spd,
    "far_spin_translation_bounded": _far_spin_bounded,
    "impact_dissipative": _impact_dissipative,
    "deep_fast_impact_no_catapult": _deep_impact,
    "launch_state_replay_bounded": _launch_replay_bounded,
    "momentum_far_from_origin": _momentum_far_from_origin,
    "thrashing_ant_stays_inside": _thrashing_stays_inside,
    "sdf_wall_blocks": _sdf_wall_blocks,
}


@pytest.mark.parametrize("check", list(ANALYTIC))
def test_analytic(check):
    """tests/test_physics.py's analytic checks (and test_engine_cl.py's
    SDF wall) on the port's engine_cl, at their own thresholds and run
    lengths."""
    ANALYTIC[check]()
