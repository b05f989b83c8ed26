"""The CUDA substep kernel's arithmetic on the CPU, and its launch geometry.

`csrc/substep.cu` compiles as host C++ with `-DSUBSTEP_HOST`: the CUDA
qualifiers are empty, and each phase of a substep runs for every lane of
the env's group in turn, where the card runs the lanes together between
`__syncwarp` barriers. The phases exchange data only through the group's
shared-memory `Slice`, so the host build runs the card's per-lane work in
one of the orders the barriers allow. Built with `g++ -O1
-ffp-contract=off` (no contraction, as the card's `-fmad=false`), it is
held to the plain PyTorch substep at one substep on 8 envs with the card's
one-substep tolerances (ant qpos 5e-6 / qvel 5e-5, Panda 1e-5 / 2e-4; the
host's libm `sinf` is not the card's). Each model is compiled once for the
module.
"""

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv  # noqa: E402
from ddiffpg_tpu_torch.physics import substep_cuda  # noqa: E402
from ddiffpg_tpu_torch.physics.panda import Arm, build_panda_scene  # noqa: E402
from ddiffpg_tpu_torch.physics.substep import (  # noqa: E402
    SubstepConstants, substep_reference)
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

B = 8
MODELS = ("ant", "Reach", "PegInsertion", "DrawerMulti", "Cabinet")
TOL = {"ant": (5e-6, 5e-5), "panda": (1e-5, 2e-4)}


def _model(name):
    if name == "ant":
        return AntMazeEnv(random_init=True, device="cpu").model, None
    return build_panda_scene(name)


def _compile(c: SubstepConstants, out_dir, lanes=None) -> ctypes.CDLL:
    lib = out_dir / f"substep_host_{c.nb}_{c.npr}_{c.ndb}_{lanes}.so"
    cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
           "-fPIC", "-DSUBSTEP_HOST", *substep_cuda.defines(c, lanes),
           "-x", "c++", str(substep_cuda.SOURCE), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    dll.substep_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    dll.substep_host.restype = None
    for fn in (dll.substep_model_bytes, dll.substep_shared_bytes):
        fn.restype = ctypes.c_int
    return dll


LANE_MODELS = ("ant", "DrawerMulti")


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """name -> (model, meta, one-substep constants, host library), and
    (name, lanes) -> host library for the ant and DrawerMulti at 8 and 32
    lanes; all compile together, one g++ each."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("substep_host")
    models = {name: _model(name) for name in MODELS}
    consts = {name: SubstepConstants.from_model(m, n_substeps=1)
              for name, (m, _) in models.items()}
    jobs = [(n, None) for n in MODELS] + [
        (n, lanes) for n in LANE_MODELS for lanes in (8, 32)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda j: _compile(consts[j[0]], out, j[1]), jobs)))
    builds = {n: (*models[n], consts[n], libs[(n, None)]) for n in MODELS}
    builds.update({j: lib for j, lib in libs.items() if j[1] is not None})
    return builds


def _run_host(lib, c: SubstepConstants, qpos, qvel, ctrl):
    block = substep_cuda.model_block(c)
    ins = [np.ascontiguousarray(t.numpy()) for t in (qpos, qvel, ctrl)]
    qpos_out, qvel_out = np.empty_like(ins[0]), np.empty_like(ins[1])
    lib.substep_host(ctypes.addressof(block),
                     *(a.ctypes.data for a in (*ins, qpos_out, qvel_out)),
                     qpos.shape[0])
    return qpos_out, qvel_out


def _states(name, m, meta, c, batch):
    if name == "ant":
        return chip_smoke.ant_states(np.asarray(m.init_qpos), B,
                                     3 if batch == "wall" else 0,
                                     batch == "wall", device="cpu")
    if batch == "contact":
        return chip_smoke.drawer_contact_states(m, meta, c, B, 2,
                                                device="cpu")
    return chip_smoke.panda_states(m, meta, B, 1, device="cpu")


@pytest.mark.parametrize("name,batch", [
    ("ant", "random"), ("ant", "wall"), ("Reach", "random"),
    ("PegInsertion", "random"), ("DrawerMulti", "random"),
    ("DrawerMulti", "contact"), ("Cabinet", "random")])
def test_host_kernel_matches_plain(host_builds, name, batch):
    m, meta, c, lib = host_builds[name]
    args = _states(name, m, meta, c, batch)
    got = _run_host(lib, c, *args)
    want = substep_reference(c, *args)
    tq, tv = TOL["ant" if name == "ant" else "panda"]
    np.testing.assert_allclose(got[0], want[0].numpy(), atol=tq, rtol=0)
    np.testing.assert_allclose(got[1], want[1].numpy(), atol=tv, rtol=0)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


@pytest.mark.parametrize("name", MODELS[1:])
def test_host_ee_state_matches_kinematics(host_builds, name):
    """The Panda builds' second entry, `ee_state_host`, against the
    `Kinematics` path of `PandaTaskEnv._ee_state` (`Arm.ee_state`) on 8
    states with every joint within its limits and nonzero velocities:
    p_ee within 1e-5 and v_ee within 1e-4, the host libm's `sinf` against
    torch's (the card's within the same bounds). The ant's build has no
    such entry."""
    m, meta, c, lib = host_builds[name]
    rng = np.random.RandomState(len(name))
    assert c.nq == c.nv          # hinges and slides: one qpos a dof
    qadr = np.asarray(c.qposadr)[np.asarray(c.dof_body)]
    qpos = np.zeros((B, c.nq), np.float32)
    qpos[:, qadr] = rng.uniform(c.lim_lo, c.lim_hi, (B, c.nv))
    qvel = rng.uniform(-2, 2, (B, c.nv)).astype(np.float32)
    arm = Arm(m, meta, "cpu")
    want = arm.ee_state(torch.tensor(qpos), torch.tensor(qvel))
    got = np.empty((B, 6), np.float32)
    block = substep_cuda.model_block(c)
    lib.ee_state_host.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_int]
    lib.ee_state_host(ctypes.addressof(block), qpos.ctypes.data,
                      qvel.ctypes.data, got.ctypes.data, arm.hand,
                      *arm.ee_offset_host, B)
    np.testing.assert_allclose(got[:, :3], want[0].numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[:, 3:], want[1].numpy(), atol=1e-4,
                               rtol=0)
    assert np.abs(want[1].numpy()).max() > 0.1
    assert not hasattr(host_builds["ant"][3], "ee_state_host")


def _ik_case(host_builds, name, seed):
    """(arm, qpos [B, nq], targets [B, 3]) of one Panda scene: 8 states
    near its neutral pose, each asked to move its end effector by up to
    5 cm, as the `ee` control does."""
    m, meta, _, _ = host_builds[name]
    rng = np.random.RandomState(seed)
    qpos = chip_smoke.panda_states(m, meta, B, 2, device="cpu")[0].numpy()
    arm = Arm(m, meta, "cpu")
    point = arm.ee_point(torch.tensor(qpos)).numpy()
    target = (point + rng.uniform(-0.05, 0.05, (B, 3))).astype(np.float32)
    return arm, qpos, target


def _run_ik(host_builds, name, arm, qpos, target, iters):
    """`dls_ik_host`: (arm targets [B, 7], ee point [B, 3] at qpos)."""
    _, _, c, lib = host_builds[name]
    block = substep_cuda.model_block(c)
    lib.dls_ik_host.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_uint, ctypes.c_int] + [ctypes.c_float] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int]
    q = np.full((B, 7), np.nan, np.float32)
    p = np.empty((B, 3), np.float32)
    lib.dls_ik_host(ctypes.addressof(block), qpos.ctypes.data,
                    target.ctypes.data, q.ctypes.data, p.ctypes.data,
                    sum(1 << i for i in arm.arm_body_host), arm.hand,
                    *arm.ee_offset_host, iters, 0.05 ** 2, B)
    return q, p


@pytest.mark.parametrize("iters", [3, 2])
@pytest.mark.parametrize("name", MODELS[1:])
def test_host_dls_ik_matches_plain(host_builds, name, iters):
    """The Panda builds' third entry, `dls_ik_host` (on the card
    `dls_ik_kernel`: `SubstepKernel.dls_ik` and `ee_point`), against the
    plain `Arm.dls_ik` and `Arm.ee_point` on 8 states near the task's
    neutral pose, each asked to move its end effector by up to 5 cm as the
    `ee` control does: the arm targets and the ee point within 1e-5. On
    the card the entry is the plain route's bits; here the two differ by
    rounding (the host libm's `sinf` against torch's, the CPU's sums and
    products against the card's), which the damped solve amplifies by up
    to 1 / (2 damping) = 10. With no iterations the entry gives the same
    point and leaves the joints. The ant's build has no such entry."""
    arm, qpos, target = _ik_case(host_builds, name, len(name) + iters)
    point = arm.ee_point(torch.tensor(qpos)).numpy()
    want = arm.dls_ik(torch.tensor(qpos), torch.tensor(target), iters)
    got, p_got = _run_ik(host_builds, name, arm, qpos, target, iters)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_got, point, atol=1e-5, rtol=0)
    arm_q = qpos[:, arm.arm_qposadr.numpy()]
    assert np.abs(got - arm_q).max() > 1e-2
    still, p0 = _run_ik(host_builds, name, arm, qpos, target, 0)
    np.testing.assert_array_equal(p0, p_got)
    np.testing.assert_array_equal(still, arm_q)
    assert not hasattr(host_builds["ant"][3], "dls_ik_host")


def test_host_dls_ik_matches_jax(host_builds):
    """`dls_ik_host` against the JAX package's `dls_ik` (vmapped over the
    batch) on the same 8 DrawerMulti states and targets: the arm targets
    within 1e-5, as `tests/test_torch_envs_all.py` holds the plain
    `Arm.dls_ik` to JAX's. One iteration (FK, Jacobian, the closed-form
    solve, the clipped step; later ones repeat it from the new joints,
    which `test_host_dls_ik_matches_plain` covers): each iteration costs
    JAX about 2.5 s on the CPU to trace and compile its FK chain."""
    import jax

    from ddiffpg_tpu.physics import panda as JP

    arm, qpos, target = _ik_case(host_builds, "DrawerMulti", 11)
    got, _ = _run_ik(host_builds, "DrawerMulti", arm, qpos, target, 1)
    jm, jmeta = JP.build_panda_scene("DrawerMulti")
    want = jax.jit(jax.vmap(lambda q, t: JP.dls_ik(jm, jmeta, q, t, 1)))(
        qpos, target)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    assert np.abs(got - qpos[:, arm.arm_qposadr.numpy()]).max() > 1e-2


@pytest.mark.parametrize("name", MODELS)
def test_launch_geometry(host_builds, name):
    """Threads per env, envs per block and shared bytes per block: a block
    is 256 threads, its shared memory fits one H100 block, and the Python
    mirror of `struct Slice` has the host build's size."""
    m, _, c, lib = host_builds[name]
    lanes, groups, shared = substep_cuda.launch_geometry(c)
    assert lanes == 16
    assert lanes * groups == substep_cuda.BLOCK_THREADS
    assert shared <= 232_448
    assert lib.substep_model_bytes() == ctypes.sizeof(
        substep_cuda.model_block(c))
    assert lib.substep_shared_bytes() == shared
    for n in (8, 16, 32):
        assert substep_cuda.launch_geometry(c, n)[2] <= 232_448
    assert substep_cuda.defines(c)[:2] == [f"-DLANES={lanes}",
                                           f"-DGROUPS={groups}"]


@pytest.mark.parametrize("name", LANE_MODELS)
def test_host_lane_counts_agree_bitwise(host_builds, name):
    """Built for 8, 16 and 32 lanes, the host build gives the same bits on
    the wall and drawer-contact batches: an element's operations and their
    order do not depend on how the env's work is spread over its lanes."""
    m, meta, c, lib = host_builds[name]
    args = _states(name, m, meta, c, "wall" if name == "ant" else "contact")
    want = _run_host(lib, c, *args)
    for lanes in (8, 32):
        got = _run_host(host_builds[(name, lanes)], c, *args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_phase_clock_instrumentation_applies(host_builds):
    """tools/phase_clocks.py hooks into the kernel's text: it still finds
    its anchors, and names one counter per barrier of a substep (19 phases,
    one Cholesky column per dof, two for dynamic boxes, three for servos)."""
    from ddiffpg_tpu_torch.tools import phase_clocks

    src = substep_cuda.SOURCE.read_text()
    out = phase_clocks.instrument(src)
    assert out.count("clock64()") == 3
    for name in MODELS:
        c = host_builds[name][2]
        names = phase_clocks.phase_names(src, c)
        assert len(names) == (19 + c.nv + 2 * (c.ndb > 0)
                              + 3 * c.has_servo)
        assert names.count("cholesky") == c.nv
