"""The port's physics against the JAX package for the ant: scene builder,
the plain substep against the Pallas kernel (interpret mode) and engine_cl,
the model check, and the packing of the CUDA kernel's constants."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from ddiffpg_tpu.physics import engine_cl, maze, pallas_ant  # noqa: E402
from ddiffpg_tpu.physics.ant import build_ant as build_ant_jax  # noqa: E402
from ddiffpg_tpu_torch.physics import substep_cuda  # noqa: E402
from ddiffpg_tpu_torch.physics.ant import build_ant  # noqa: E402
from ddiffpg_tpu_torch.physics.panda import build_panda_scene  # noqa: E402
from ddiffpg_tpu_torch.physics.substep import (  # noqa: E402
    SubstepConstants, substep_reference)
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)


def _states(m, B, seed, wall=False):
    """tests/test_pallas.py's random ant states; with `wall`, torsos 0.45 m
    from the start cell's x = -2 wall face, moving into it."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    if wall:
        qpos[:, 0] = -1.55 + rng.uniform(-0.1, 0.1, B)
        qvel[:, 0] = -2.0
    return qpos, qvel, ctrl


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def test_build_ant_field_identical():
    kw = dict(static_boxes=maze.compile_boxes(maze.MAZE_v1), dt=0.01,
              n_substeps=10, **maze.compile_sdf(maze.MAZE_v1))
    a, b = build_ant_jax(**kw), build_ant(**kw)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_substep_matches_pallas_interpret():
    """One substep, B=128 (64 random + 64 wall-contact envs), against the
    Pallas kernel in interpret mode, at tests/test_pallas.py's tolerances:
    qpos 5e-6, qvel 5e-5."""
    boxes = maze.compile_boxes(maze.MAZE_v1)
    mj = build_ant_jax(static_boxes=boxes, dt=0.01, n_substeps=1)
    mt = build_ant(static_boxes=boxes, dt=0.01, n_substeps=1)
    parts = [_states(mj, 64, 0), _states(mj, 64, 5, wall=True)]
    qpos, qvel, ctrl = (np.concatenate(x) for x in zip(*parts))
    with pltpu.force_tpu_interpret_mode():
        fn = pallas_ant.make_substep_kernel(mj, tile=128)
        want = fn(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
    got = substep_reference(mt, *_t(qpos, qvel, ctrl))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=5e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=5e-5, rtol=0)
    # the wall rows really touch the wall: without boxes they move freely
    free = substep_reference(dataclasses.replace(
        mt, static_box_min=np.zeros((0, 3), np.float32),
        static_box_max=np.zeros((0, 3), np.float32), nsb=0),
        *_t(qpos, qvel, ctrl))
    assert float((free[1] - got[1])[64:].abs().max()) > 0.1
    assert float((free[1] - got[1])[:64].abs().max()) == 0.0


def test_ten_substeps_match_engine_cl():
    """The model's 10 substeps (one control step) away from the walls,
    against engine_cl.step at tests/test_engine_cl.py's tolerances
    (qpos 2e-5, qvel 2e-4)."""
    boxes = maze.compile_boxes(maze.MAZE_v1)
    mj = build_ant_jax(static_boxes=boxes, dt=0.01, n_substeps=10)
    mt = build_ant(static_boxes=boxes, dt=0.01, n_substeps=10)
    qpos, qvel, ctrl = _states(mj, 32, 1)
    want = engine_cl.step(mj, jnp.asarray(qpos), jnp.asarray(qvel),
                          jnp.asarray(ctrl))
    got = substep_reference(mt, *_t(qpos, qvel, ctrl))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-4, rtol=0)


def test_model_check_rejects_panda():
    """A Panda scene taken out of the Pallas kernel's model class (a FREE
    joint below the root, a joint anchored off the body origin, an unknown
    actuator type) is refused by the constants, the plain substep and the
    kernel wrapper alike; the scene itself is accepted."""
    m0, _ = build_panda_scene("Reach")
    SubstepConstants.from_model(m0)
    jt = m0.jnt_type.copy()
    jt[1] = 0
    anchor = m0.jnt_pos.copy()
    anchor[2, 0] = 0.01
    for m in (dataclasses.replace(m0, jnt_type=jt),
              dataclasses.replace(m0, jnt_pos=anchor),
              dataclasses.replace(m0, act_type=m0.act_type + 1)):
        with pytest.raises(NotImplementedError):
            SubstepConstants.from_model(m)
        with pytest.raises(NotImplementedError):
            substep_reference(m, torch.zeros((2, m.nq)),
                              torch.zeros((2, m.nv)), torch.zeros((2, m.nu)))
        with pytest.raises(NotImplementedError):
            substep_cuda.SubstepKernel(m)


def test_kernel_constant_block_layout():
    """The ctypes block holds every constant, 4 bytes each, no padding, in
    the order of csrc/substep.cu's struct SubstepModel (the dynamic-box
    table, empty for the ant, takes one row)."""
    m = build_ant(static_boxes=maze.compile_boxes(maze.MAZE_v1), dt=0.01,
                  n_substeps=10)
    c = SubstepConstants.from_model(m)
    assert (c.nb, c.nv, c.nq, c.nu, c.npr, c.nsb) == (9, 14, 15, 8, 25, 17)
    block = substep_cuda.model_block(c)
    n = (6 * c.nb + c.nb * (3 + 3 + 4 + 1 + 3 + 9) + 6 * c.nv + 7 * c.nu
         + c.npr * (1 + 3 + 4) + 2 * 3 * c.nsb + (2 + 3 + 4 + 3 + c.npr)
         + 3 + 13)
    assert ctypes.sizeof(block) == 4 * n
    raw = np.frombuffer(bytes(block), np.float32)
    assert raw[-13] == np.float32(0.01)               # dt
    np.testing.assert_array_equal(np.frombuffer(bytes(block), np.int32)[
        :c.nb], [-1, 0, 1, 0, 3, 0, 5, 0, 7])        # parent
    assert substep_cuda.defines(c)[-1] == "-DNSUB=10"


def test_kernel_wrapper_refuses_cpu():
    m = build_ant(static_boxes=maze.compile_boxes(maze.MAZE_v1))
    with pytest.raises(ValueError):
        substep_cuda.SubstepKernel(m, device="cpu")
