"""The port's Panda physics against the JAX package: scene builder,
quaternions, kinematics, the plain substep against the Pallas kernel
(interpret mode) and engine_cl, the dynamic boxes' self-mask, and the
CUDA kernel's constants for the Panda model class."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from ddiffpg_tpu.physics import engine as jengine  # noqa: E402
from ddiffpg_tpu.physics import engine_cl, pallas_ant  # noqa: E402
from ddiffpg_tpu.physics import quat as jquat  # noqa: E402
from ddiffpg_tpu.physics.panda import \
    build_panda_scene as jax_scene  # noqa: E402
from ddiffpg_tpu_torch.physics import engine, quat, substep_cuda  # noqa: E402
from ddiffpg_tpu_torch.physics import types as T  # noqa: E402
from ddiffpg_tpu_torch.physics.ant import build_ant  # noqa: E402
from ddiffpg_tpu_torch.physics.builder import (BodySpec, GeomSpec,  # noqa: E402
                                               JointSpec, build)
from ddiffpg_tpu_torch.physics.panda import build_panda_scene  # noqa: E402
from ddiffpg_tpu_torch.physics.substep import (  # noqa: E402
    SubstepConstants, substep_reference)
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

TASKS = ["Reach", "PegInsertion", "DrawerMulti", "Cabinet"]


def _states(m, meta, B, seed):
    """tests/test_pallas.py's Panda draws: the init pose, qvel U(-0.2, 0.2),
    servo targets the neutral pose plus U(-0.05, 0.05)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qvel = rng.uniform(-0.2, 0.2, (B, m.nv)).astype(np.float32)
    ctrl = np.tile(np.concatenate(
        [meta["neutral"], [0.015, 0.015]])[None], (B, 1)).astype(np.float32)
    ctrl[:, :7] += rng.uniform(-0.05, 0.05, (B, 7))
    return qpos, qvel, ctrl


def _random_pose_states(m, meta, B, seed):
    """Arm joints anywhere within their limits, fingers and task joints
    within theirs, qvel U(-0.5, 0.5)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] = rng.uniform(
        np.float32(m.dof_limit_lo[meta["arm_dofadr"]]),
        np.float32(m.dof_limit_hi[meta["arm_dofadr"]]), (B, 7))
    qpos[:, meta["finger_qposadr"]] = rng.uniform(0, 0.04, (B, 2))
    if len(meta["task_qposadr"]):
        qpos[:, meta["task_qposadr"]] = rng.uniform(
            0, 0.25, (B, len(meta["task_qposadr"])))
    qvel = rng.uniform(-0.5, 0.5, (B, m.nv)).astype(np.float32)
    return qpos, qvel


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("task", TASKS)
def test_build_panda_scene_field_identical(task):
    (a, ma), (b, mb) = jax_scene(task), build_panda_scene(task)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_array_equal(np.asarray(ma[k]), np.asarray(mb[k]),
                                      err_msg=k)


def test_quat_matches_jax():
    rng = np.random.RandomState(0)
    q1, q2 = rng.normal(size=(2, 16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 16).astype(np.float32)
    pairs = [(quat.mul(*_t(q1, q2)), jquat.mul(q1, q2)),
             (quat.rotate(*_t(q1, v)), jquat.rotate(q1, v)),
             (quat.to_matrix(*_t(q1)), jquat.to_matrix(q1)),
             (quat.from_axis_angle(*_t(v, ang)),
              jquat.from_axis_angle(v, ang))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)


@pytest.mark.parametrize("task", TASKS + ["ant"])
def test_kinematics_match_engine(task):
    """fk, dof_subspaces, qvel_to_u and body_velocities at random poses
    against engine.py vmapped, float32 in another order: 2e-6. The ant
    covers the FREE root."""
    if task == "ant":
        m = build_ant()
        rng = np.random.RandomState(3)
        qpos = np.tile(m.init_qpos[None], (32, 1)).astype(np.float32)
        qpos[:, :3] += rng.uniform(-1, 1, (32, 3))
        qpos[:, 3:7] = rng.normal(size=(32, 4))
        qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
        qpos[:, 7:] += rng.uniform(-0.3, 0.3, (32, 8))
        qvel = rng.uniform(-1, 1, (32, m.nv)).astype(np.float32)
    else:
        m, meta = build_panda_scene(task)
        qpos, qvel = _random_pose_states(m, meta, 32, 3)
    pos, qu = engine.fk(m, torch.tensor(qpos))
    S = engine.dof_subspaces(m, pos, qu)
    u = engine.qvel_to_u(m, torch.tensor(qvel), pos)
    V = engine.body_velocities(m, S, u)
    jpos, jqu = jax.vmap(lambda q: jengine.fk(m, q))(jnp.asarray(qpos))
    jS = jax.vmap(lambda p, q: jengine.dof_subspaces(m, p, q))(jpos, jqu)
    ju = jax.vmap(lambda v, p: jengine.qvel_to_u(m, v, p))(
        jnp.asarray(qvel), jpos)
    jV = jax.vmap(lambda s, v: jengine.body_velocities(m, s, v))(jS, ju)
    for got, want in ((pos, jpos), (qu, jqu), (S, jS), (u, ju), (V, jV)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)


def test_substep_matches_pallas_interpret_drawer():
    """One DrawerMulti substep, B=128 (64 of tests/test_pallas.py's states
    and 64 with a hand or finger probe 1-5 mm inside a drawer's front
    face), against the Pallas kernel run by Pallas's HLO interpreter (the
    same kernel body as a jit of a scan; TPU interpret mode's simulation of
    VMEM and DMAs adds minutes and nothing for a kernel without DMAs), at
    tests/test_pallas.py's Panda tolerances: qpos 1e-5, qvel 2e-4. Stage g
    fires on the contact rows and on them only."""
    mj, _ = jax_scene("DrawerMulti", n_substeps=1)
    m, meta = build_panda_scene("DrawerMulti", n_substeps=1)
    c = SubstepConstants.from_model(m)
    contact = chip_smoke.drawer_contact_states(m, meta, c, 64, 2,
                                               device="cpu")
    qpos, qvel, ctrl = (np.concatenate([a, b.numpy()]) for a, b in
                        zip(_states(m, meta, 64, 1), contact))
    with pltpu.force_tpu_interpret_mode(True):
        fn = pallas_ant.make_substep_kernel(mj, tile=128)
        want = fn(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
    got = substep_reference(c, *_t(qpos, qvel, ctrl))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-4, rtol=0)
    free = substep_reference(chip_smoke.without_dynamic_boxes(c),
                             *_t(qpos, qvel, ctrl))
    assert float((free[1] - got[1])[64:].abs().max()) > 1e-2
    assert float((free[1] - got[1])[:64].abs().max()) == 0.0


@pytest.mark.parametrize("task", ["Reach", "PegInsertion", "Cabinet"])
def test_substep_matches_engine_cl(task):
    """One substep at random arm poses (the arm against the furniture and
    the table for many of them) against engine_cl.step at
    tests/test_pallas.py's Panda tolerances: qpos 1e-5, qvel 2e-4."""
    mj, _ = jax_scene(task, n_substeps=1)
    m, meta = build_panda_scene(task, n_substeps=1)
    qpos, qvel = _random_pose_states(m, meta, 64, 4)
    ctrl = _states(m, meta, 64, 5)[2]
    want = engine_cl.step(mj, jnp.asarray(qpos), jnp.asarray(qvel),
                          jnp.asarray(ctrl))
    got = substep_reference(m, *_t(qpos, qvel, ctrl))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-4, rtol=0)


def test_dynamic_box_skips_its_own_probes():
    """A sphere on a drawer body, deep inside that drawer's own box, adds
    neither force nor reaction: the substep equals that of the same scene
    without the box, bit for bit (the ground contact still acts)."""
    def scene(with_box):
        geoms = [GeomSpec(T.SPHERE, (0.03,), density=500.0)]
        if with_box:
            geoms.append(GeomSpec(T.BOX, (0.1, 0.1, 0.1), pos=(0.01, 0, 0),
                                  quat=(0.9238795, 0.0, 0.0, 0.3826834)))
        bodies = [BodySpec("base", "", pos=(0, 0, 0.5),
                           joint=JointSpec(T.FIXED),
                           geoms=[GeomSpec(T.SPHERE, (0.05,))]),
                  BodySpec("drawer", "", pos=(0.3, 0, 0.02),
                           joint=JointSpec(T.SLIDE, axis=(1, 0, 0),
                                           damping=1.0, limit=(-0.2, 0.2)),
                           mass=1.0, inertia_diag=(0.01, 0.01, 0.01),
                           geoms=geoms)]
        return build(bodies, [("drawer", 5.0)], dt=0.002, n_substeps=1)

    rng = np.random.RandomState(0)
    args = _t(rng.uniform(-0.1, 0.1, (16, 1)).astype(np.float32),
              rng.uniform(-1, 1, (16, 1)).astype(np.float32),
              rng.uniform(-1, 1, (16, 1)).astype(np.float32))
    c = SubstepConstants.from_model(scene(True))
    assert c.ndb == 1 and c.dbox_keep.tolist() == [[1.0, 0.0]]
    assert not c.dbox_ident[0]
    got = substep_reference(c, *args)
    want = substep_reference(scene(False), *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1].abs().max()) > 0.0


def test_kernel_constants_for_drawer_multi():
    """The Panda branches' constants: joint layout, servos, four dynamic
    boxes, and the kernel's compile-time flags."""
    m, meta = build_panda_scene("DrawerMulti")
    c = SubstepConstants.from_model(m)
    assert (c.nb, c.nv, c.nq, c.nu, c.npr, c.nsb, c.ndb) == (
        15, 13, 13, 9, 4, 4, 4)
    assert c.parent.count(-1) == 5 and c.has_servo
    assert c.dbox_body == tuple(meta["task_body_idx"])
    assert all(c.dbox_ident) and c.dbox_keep.min() == 1.0
    assert c.act_qadr == tuple(meta["arm_qposadr"]) + tuple(
        meta["finger_qposadr"])
    assert substep_cuda.defines(c)[-3:] == [
        "-DNDB=4", "-DHAS_SERVO=1", "-DNSUB=20"]
    block = substep_cuda.model_block(c)
    n = (6 * c.nb + c.nb * (3 + 3 + 4 + 1 + 3 + 9) + 6 * c.nv + 7 * c.nu
         + c.npr * (1 + 3 + 4) + 2 * 3 * c.nsb
         + c.ndb * (2 + 3 + 4 + 3 + c.npr) + 3 + 13)
    assert ctypes.sizeof(block) == 4 * n
