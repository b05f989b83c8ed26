"""The CUDA substep and DTW kernels on the card, against their plain
PyTorch versions, and the DDiffPG agent on the card: its env steps through
the kernel, one update pass against the same pass on the CPU, and a
recluster identical on the card and the CPU; one update pass of each
baseline (TD3, SAC, DIPO, DiffQ) on the card against the CPU.

Needs an NVIDIA card and nvcc, and no JAX. Skipped without a card. On the
card's machine (no JAX, so without the suite's conftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from ddiffpg_tpu_torch.physics import maze  # noqa: E402
from ddiffpg_tpu_torch.physics.ant import build_ant  # noqa: E402
from ddiffpg_tpu_torch.physics.panda import build_panda_scene  # noqa: E402
from ddiffpg_tpu_torch.physics.substep import (  # noqa: E402
    SubstepConstants, substep_reference)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _states(m, B, seed, device):
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    return tuple(torch.tensor(a, device=device) for a in (qpos, qvel, ctrl))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 20, 4095, 4096])
def test_kernel_matches_plain_one_substep(card, B):
    """tests/test_pallas.py's tolerances: qpos 5e-6, qvel 5e-5."""
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    m = build_ant(static_boxes=maze.compile_boxes(maze.MAZE_v1), dt=0.01,
                  n_substeps=1)
    kern = SubstepKernel(m, device=card)
    args = _states(m, B, 0, card)
    got = kern(*args)
    want = substep_reference(SubstepConstants.from_model(m), *args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    torch.testing.assert_close(got[0], want[0], atol=5e-6, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=5e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 20, 4095, 4096])
@pytest.mark.parametrize("task", ["DrawerMulti", "Cabinet"])
def test_panda_kernel_matches_plain_one_substep(card, task, B):
    """tests/test_pallas.py's Panda tolerances: qpos 1e-5, qvel 2e-4; for
    DrawerMulti also with hand or finger probes inside a drawer's front."""
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    m, meta = build_panda_scene(task, n_substeps=1)
    c = SubstepConstants.from_model(m)
    kern = SubstepKernel(c, device=card)
    batches = [chip_smoke.panda_states(m, meta, B, 0, device=card)]
    if task == "DrawerMulti":
        batches.append(chip_smoke.drawer_contact_states(m, meta, c, B, 1,
                                                        device=card))
    for args in batches:
        got = kern(*args)
        want = substep_reference(c, *args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=2e-4, rtol=0)
    assert kern.launches == len(batches)


@pytest.mark.cuda
def test_kernel_wrapper_checks_inputs(card):
    """Wrong dtype, width, layout or device is refused for the ant's and
    DrawerMulti's sizes, and nothing is launched."""
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    ant = build_ant(static_boxes=maze.compile_boxes(maze.MAZE_v1), dt=0.01,
                    n_substeps=1)
    drawer, meta = build_panda_scene("DrawerMulti", n_substeps=1)
    for m, args in ((ant, _states(ant, 8, 1, card)),
                    (drawer, chip_smoke.panda_states(drawer, meta, 8, 1,
                                                     device=card))):
        kern = SubstepKernel(m, device=card)
        qpos, qvel, ctrl = args
        with pytest.raises(ValueError):
            kern(qpos.double(), qvel, ctrl)
        with pytest.raises(ValueError):
            kern(qpos, qvel[:, :m.nv - 1], ctrl)
        with pytest.raises(ValueError):
            kern(qpos, qvel, ctrl[:, :m.nu - 1])
        with pytest.raises(ValueError):
            kern(qpos, qvel, ctrl.t().contiguous().t())
        with pytest.raises(ValueError):
            kern(qpos.cpu(), qvel, ctrl)
        assert kern.launches == 0


def _model(name, n_substeps=None):
    """(model, meta, constants) of the ant on antmaze-v1 or a Panda scene;
    a whole control step unless `n_substeps` is given."""
    if name == "ant":
        m = build_ant(static_boxes=maze.compile_boxes(maze.MAZE_v1),
                      dt=0.01, n_substeps=n_substeps or 10)
        return m, None, SubstepConstants.from_model(m)
    m, meta = build_panda_scene(name, **(
        {} if n_substeps is None else {"n_substeps": n_substeps}))
    return m, meta, SubstepConstants.from_model(m)


def _batches(name, m, meta, c, B, device):
    if name == "ant":
        init = np.asarray(m.init_qpos)
        return [chip_smoke.ant_states(init, B, 0, False, device=device),
                chip_smoke.ant_states(init, B, 3, True, device=device)]
    out = [chip_smoke.panda_states(m, meta, B, 1, device=device)]
    if name == "DrawerMulti":
        out.append(chip_smoke.drawer_contact_states(m, meta, c, B, 2,
                                                    device=device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ant", "Reach", "PegInsertion",
                                  "DrawerMulti", "Cabinet"])
def test_kernel_matches_plain_control_step(card, name):
    """A whole control step (the ant's 10 substeps, Panda's 20) at B = 1,
    20, 4095 and 4096, against the plain version: ant qpos 5e-5 / qvel
    5e-4, Panda 1e-4 / 5e-3 (chip_smoke.py's control-step tolerances); the
    rows of every smaller batch equal the 4096-env launch's bit for bit."""
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    m, meta, c = _model(name)
    tq, tv = (5e-5, 5e-4) if name == "ant" else (1e-4, 5e-3)
    kern = SubstepKernel(c, device=card)
    for args in _batches(name, m, meta, c, 4096, card):
        full = kern(*args)
        for B in (1, 20, 4095, 4096):
            sub = tuple(a[:B].contiguous() for a in args)
            got = kern(*sub)
            want = substep_reference(c, *sub)
            torch.cuda.synchronize()
            torch.testing.assert_close(got[0], want[0], atol=tq, rtol=0)
            torch.testing.assert_close(got[1], want[1], atol=tv, rtol=0)
            assert torch.equal(got[0], full[0][:B])
            assert torch.equal(got[1], full[1][:B])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ant", "DrawerMulti"])
def test_lane_counts_agree_bitwise(card, name):
    """The kernel built with 8, 16 and 32 threads per env gives the same
    bits: each element's operations and their order do not depend on how
    the env's work is spread over its lanes."""
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    m, meta, c = _model(name, n_substeps=1)
    outs = []
    for lanes in (8, 16, 32):
        kern = SubstepKernel(c, device=card, lanes=lanes)
        assert kern.lanes == lanes
        outs.append([kern(*args) for args in
                     _batches(name, m, meta, c, 333, card)])
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _limit_states(c, B, seed, device):
    """Panda states with every joint uniform within its limits and
    velocities U(-2, 2)."""
    rng = np.random.RandomState(seed)
    qadr = np.asarray(c.qposadr)[np.asarray(c.dof_body)]
    qpos = np.zeros((B, c.nq), np.float32)
    qpos[:, qadr] = rng.uniform(c.lim_lo, c.lim_hi, (B, c.nv))
    qvel = rng.uniform(-2, 2, (B, c.nv)).astype(np.float32)
    return torch.tensor(qpos, device=device), torch.tensor(qvel,
                                                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["DrawerMulti", "Reach"])
def test_ee_state_kernel_matches_kinematics(card, task):
    """`SubstepKernel.ee_state` at 4096 envs against the `Kinematics` path
    (`Arm.ee_state`): p_ee within 1e-5, v_ee within 1e-4; one launch,
    counted apart from the substep's."""
    from ddiffpg_tpu_torch.physics.panda import Arm
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    m, meta, c = _model(task)
    kern = SubstepKernel(c, device=card)
    arm = Arm(m, meta, card)
    for qpos, qvel in (_limit_states(c, 4096, 0, card),
                       chip_smoke.panda_states(m, meta, 4096, 1, card)[:2]):
        out = kern.ee_state(qpos, qvel, arm.hand, arm.ee_offset_host)
        want = arm.ee_state(qpos, qvel)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[:, :3], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(out[:, 3:], want[1], atol=1e-4, rtol=0)
    assert (kern.ee_launches, kern.launches) == (2, 0)
    with pytest.raises(ValueError):
        kern.ee_state(qpos[:, 1:].contiguous(), qvel, arm.hand,
                      arm.ee_offset_host)
    assert kern.ee_launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["DrawerMulti", "Reach"])
def test_env_step_ee_state_kernel_matches_plain(card, task, monkeypatch):
    """A whole `step_batched` of 4096 envs on the kernel route against the
    same step with `_ee_state` on the plain `Kinematics` path, from one
    state and with the same reset noise: obs' ee position within 1e-5,
    its velocity within 1e-4, the rest and the next state equal; reward,
    done and success bitwise. The step makes one ee-state launch."""
    from ddiffpg_tpu_torch.envs.panda import PandaTaskEnv

    env = PandaTaskEnv(task, random_init_pos=True, device=card, seed=3)
    B = 4096
    state, _ = env.reset_batched(B)
    g = torch.Generator(device=card).manual_seed(4)
    for _ in range(3):   # moving arms, some envs in their last step
        action = torch.rand((B, env.action_dim), generator=g,
                            device=card) * 2 - 1
        state, *_ = env.step_batched(state, action)
    state = state._replace(t=torch.randint(
        90, 100, (B,), generator=g, device=card, dtype=torch.int32))
    noise = torch.rand((B, 7), generator=g, device=card) * 0.2 - 0.1
    env.kernel.ee_launches = 0
    got = env.step_batched(state, action, noise)
    assert env.kernel.ee_launches == 1
    monkeypatch.setattr(env, "_ee_state", env.arm.ee_state)
    want = env.step_batched(state, action, noise)
    torch.cuda.synchronize()
    assert env.kernel.ee_launches == 1
    (s1, o1, r1, d1, i1), (s2, o2, r2, d2, i2) = got, want
    torch.testing.assert_close(o1[:, :3], o2[:, :3], atol=1e-5, rtol=0)
    torch.testing.assert_close(o1[:, 3:6], o2[:, 3:6], atol=1e-4, rtol=0)
    assert torch.equal(o1[:, 6:], o2[:, 6:])
    for a, b in ((r1, r2), (d1, d2), (i1["success"], i2["success"]),
                 (i1["time_outs"], i2["time_outs"]), *zip(s1, s2)):
        assert torch.equal(a, b)
    assert bool(d1.any()) and bool(torch.isfinite(o1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ant", "DrawerMulti"])
def test_substep_kernel_ptxas_without_ee_state(card, name, tmp_path):
    """The ee-state entry leaves the substep kernel's code as it was:
    ptxas reports the same registers, stack frame and spills for
    `substep_kernel` with the entry and with its two blocks (the kernel,
    its shared-memory set-up) cut from the source; the ant's build has no
    `ee_state_kernel`."""
    import re

    from ddiffpg_tpu_torch.physics import substep_cuda as sc

    _, _, c = _model(name)
    src = sc.SOURCE.read_text()
    block = (r"#if HAS_SERVO  // ---- the end-effector state\n.*?"
             r"#endif  // HAS_SERVO: the end-effector state\n")
    cut, n = re.subn(block, "", src, flags=re.S)
    assert n == 2
    (tmp_path / "substep_cut.cu").write_text(cut)
    libs = (sc.build(c), sc.compile_library(
        sc._nvcc(), sc.NVCC_FLAGS + tuple(sc.defines(c)),
        tmp_path / "substep_cut.cu", "substep_cut", bytes(sc.model_block(c))))
    full, without = (sc.ptxas_report(lib.with_suffix(".log").read_text())
                     for lib in libs)
    assert set(full["substep_kernel"]) == {"registers", "stack",
                                           "spill_stores", "spill_loads"}
    assert full["substep_kernel"] == without["substep_kernel"]
    assert ("ee_state_kernel" in full) == (name != "ant")
    assert "ee_state_kernel" not in without


def _card_agent(card, num_envs=64, **over):
    """DDiffPG on antmaze-v1 on the card, the stock config at `num_envs`
    envs (`over` overrides), with a replay that holds one flushed
    episode per env (clocks set to 480 before 25 warm-up steps)."""
    from ddiffpg_tpu_torch.agents import make_agent
    from ddiffpg_tpu_torch.envs import make

    cfg = chip_smoke.stock_config("antmaze-v1").override(
        **{"num_envs": num_envs, "algo.warm_up": 25, **over})
    env = make("antmaze-v1", num_envs=num_envs, random_init=True,
               device=card)
    agent = make_agent("DDiffPG", env, cfg, device=card)
    ts = agent.init()
    ts.env_state = ts.env_state._replace(
        t=torch.full_like(ts.env_state.t, 480))
    return agent, agent.warmup(ts), env.env


@pytest.mark.cuda
def test_agent_env_steps_launch_the_kernel(card):
    """Every env step of the warm-up and of a train iteration is one
    launch of the substep kernel; the warm-up flushes every env."""
    agent, ts, ant = _card_agent(card)
    assert ant.kernel.launches == 25
    assert int((ts.replay.length == 20).sum()) == 64
    ant.kernel.launches = 0
    ts, logs = agent.train_iter(ts, steps=0)
    torch.cuda.synchronize()
    assert ant.kernel.launches == agent.cfg.algo.horizon_len
    assert all(bool(torch.isfinite(v)) for v in logs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3])
def test_update_once_card_matches_cpu(card, G):
    """One update pass at batch 1024 on the card and on the CPU from
    copies of one state with the same draws, within chip_smoke.py's
    bounds (CARD_CPU_TOL)."""
    from ddiffpg_tpu_torch.replay import episodic as ep

    agent, ts, _ = _card_agent(card, **{"algo.batch_size": 1024})
    if G > 1:
        S = ts.replay.capacity
        mask = torch.zeros((agent.G_max, S), dtype=torch.bool, device=card)
        mask[0] = ts.replay.length > 0
        mask[1:G] = mask[0] & (torch.arange(S, device=card) % 2 == 0)
        ep.set_groups(ts.replay, mask, [0] * G + [-1] * (agent.G_max - G))
    chip_smoke.card_vs_cpu(agent, ts, agent.cfg, G)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["td3", "sac", "dipo", "diffq"])
def test_baseline_update_once_card_matches_cpu(card, algo):
    """One update pass of the baseline's stock preset on antmaze-v1 (64
    envs, batch 1024, 100,000 replay rows after 25 warm-up steps) on the
    card and on the CPU from copies of one state with the same draws,
    within chip_smoke.py's bounds (CARD_CPU_TOL)."""
    from ddiffpg_tpu_torch.agents import make_agent
    from ddiffpg_tpu_torch.envs import make

    cfg = chip_smoke.baseline_config(algo).override(
        **{"num_envs": 64, "algo.batch_size": 1024,
           "algo.memory_size": 100_000, "algo.warm_up": 25})
    env = make("antmaze-v1", num_envs=64, random_init=True, device=card)
    agent = make_agent(cfg.algo.name, env, cfg, device=card)
    ts = agent.warmup(agent.init())
    assert env.env.kernel.launches == 25
    chip_smoke.baseline_card_vs_cpu(agent, ts, algo)


def _dtw_args(L, D, N, P, seed, device):
    rng = np.random.RandomState(seed)
    stack = np.cumsum(rng.randn(N, L, D), axis=1).astype(np.float32)
    lens = rng.randint(1, L + 1, N).astype(np.int32)
    lens[:2] = (1, L)
    ia = rng.randint(0, N, P).astype(np.int32)
    ib = rng.randint(0, N, P).astype(np.int32)
    k = min(P, 3)
    ia[:k], ib[:k] = (0, 0, 1)[:k], (0, 1, 1)[:k]
    return [torch.tensor(a, device=device)
            for a in (stack, stack, lens, lens, ia, ib)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, 64, 128, 256, 512])
def test_dtw_kernel_matches_plain(card, L, D):
    """The DTW kernel against its plain version on the card, tracks padded
    to L (every template of rows a lane: R = 1, 2, 4, 8, 16 at L = 32, 64,
    128, 256, 512, and the lengths about a warp): bitwise equal (both
    round op by op alike, and both square roots round correctly)."""
    from ddiffpg_tpu_torch.ops import dtw, dtw_cuda

    args = _dtw_args(L, D, 24, 300, L + D, card)
    kern = dtw_cuda.get_kernel(card)
    before = kern.launches
    got = dtw.dtw_batch_gather(*args)
    want = dtw.dtw_wavefront(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert float(got[0]) == 0.0 and float(got[2]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 4 * 37 + 1, 4 * 37 + 3])
def test_dtw_kernel_nan_and_ragged_grid(card, P):
    """P not a multiple of the warps a block (the last block's idle warps
    return at once), and a NaN coordinate in track 3: NaN for every pair
    that holds it, as the plain version (torch.minimum) gives; the other
    pairs bitwise the plain version's."""
    from ddiffpg_tpu_torch.ops import dtw, dtw_cuda

    args = _dtw_args(200, 2, 12, P, P, card)
    args[0][3, 7, 1] = args[1][3, 7, 1] = float("nan")
    args[2][3] = args[3][3] = 200
    args[4][-1] = 3
    assert P % dtw_cuda.launch_geometry(200, 2)[0]
    kern = dtw_cuda.get_kernel(card)
    before = kern.launches
    got = dtw.dtw_batch_gather(*args)
    want = dtw.dtw_wavefront(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    nan = (args[4] == 3) | (args[5] == 3)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.isnan(want), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
def test_recluster_card_matches_cpu(card):
    """chip_smoke's two routes (16 successes, 16 failures): a
    ClusterManager on the card and one on the CPU give the same
    ClusterResult."""
    from ddiffpg_tpu_torch.modes.cluster import ClusterManager

    rng = np.random.RandomState(0)
    S, L = 40, 120
    traj_id = np.full(S, -1, np.int64)
    length = np.zeros(S, np.int64)
    success = np.zeros(S, np.int64)
    tracks = np.zeros((S, L + 1, 2), np.float32)
    for k in range(32):
        n = int(rng.randint(60, L + 1))
        tr = chip_smoke.route_track(rng, n, (4.0, -4.0)[k % 2]) if k < 16 \
            else chip_smoke.failure_track(rng, n)
        traj_id[k], length[k], success[k] = k, n, int(k < 16)
        tracks[k, : n + 1] = tr
    res = [ClusterManager(capacity=24, threshold=50.0, device=d).recluster(
        traj_id, length, success, tracks) for d in (card, "cpu")]
    assert res[0].num_groups == 3
    assert chip_smoke.same_result(*res)
