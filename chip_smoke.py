#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`ddiffpg_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds the CUDA substep kernel from this checkout for the ant and the four
Panda scenes (one nvcc per model, all started together; the DTW kernel at
phase 10), holds every build
to its plain PyTorch version on the card (the Panda builds' ee-state entry
to `Arm.ee_state`, their IK entry bit for bit to `Arm.ee_point` and
`Arm.dls_ik`), drives DDiffPG's collect path at
4096 envs with a stock-width diffusion policy (random weights from a seed)
on antmaze-v1, PandaDrawerMultiJoints-v3 and PandaReachJoints-v3, and
probes the goals. A collect step and its parts are timed on the host clock
with a synchronize around each call, and, after every timed phase, read on
the device from torch.profiler windows (busy time and idle share). Then it
trains: stock DDiffPG on antmaze-v1 at 1024 envs (warm-up, timed train
iterations through the kernel, their host split and device time, three
live groups, one update pass on the card against the CPU). Last, the
loop: the CUDA DTW kernel (a warp a pair) bitwise against its plain
version, ptxas' report of each template and both timed, a
recluster of 1,000 synthetic successes on antmaze-v1's two corridors at
the stock size (full, then incremental, then two train iterations at the
groups found; a subset reclustered on the card and on the CPU alike), and
the entry point `ddiffpg_tpu_torch.train.main` with the stock config
(warm-up, reclusters, two evals, a light and the final checkpoint, which
must reload bit for bit). Then every other env of the package: the five
other mazes' builds (29-41 wall boxes) against the plain version with
random states and ants against that maze's walls, timed with their bounds,
their collects at 4096 envs and every goal probed, stock DDiffPG trained on
antmaze-v3 (700-step episodes) and a recluster of 700-step successes to
antmaze-v2's two goals (phase 11); Panda's `ee` control (the IK's targets
on the card against the CPU, ee collects of DrawerMulti and Reach with the
host split of a step, Reach trained with `env.control_type=ee`, a recluster
of 3-D ee tracks, phase 12); a pointmaze-v1 collect and the entry point on
antmaze-v2 and pointmaze-v2, each logging a success rate per goal (phase
13); the baselines TD3, SAC, DIPO and DiffQ with their stock presets on
antmaze-v1 at 256 envs (timed train iterations through the kernel, DIPO's
host split by part, one update pass on the card against the CPU each,
`train.main` each with two evals, a light and a full checkpoint that must
reload bit for bit) and TD3 on pointmaze-v1 with dense rewards (phase 14);
the checkpoint tools on the card (phase 15: eval_ckpt, eval_goals,
eval_modes, trace_goals, probe_qfield on the final checkpoints of phase
10c's antmaze-v1 run and phase 13's antmaze-v2 run, probe_energy,
run_status and archive_run, trace_launch, the weights bundle
round-tripped, and the rest of the model zoo on the card against the CPU;
the tools' rollouts step `physics/engine_cl.py`, as the JAX tools'); the
batched engine `engine_cl` through `make(..., use_pallas=False)` on
antmaze-v1 (SDF walls) and DrawerMulti at 4096 envs, card against CPU,
bitwise on a repeat and through its CUDA graph, each substep of its
control steps held to the one-substep bounds against the CPU from the
card's own state, timed eager and graphed
(phase 16); DDiffPG data-parallel (`parallel/`) in spawned processes,
world 2 through gloo on the one card with a recluster and world 1
through NCCL, replicated leaves bitwise alike across ranks (phase 17);
the last helpers (phase 18: the DTW kernel against the host float64 DTW
of `csrc/cluster.cpp`, `waypoint_policy` driving pointmaze-v1 and v2 to
every goal on the card, `quat.integrate` on the card against the CPU);
last the profiler windows. It prints one line per phase and its wall
seconds, JSON lines `{"train": {...}}`, `{"loop": {...}}`,
`{"envs": {...}}`, `{"baselines": {...}}`, `{"tools": {...}}`,
`{"engine_cl": {...}}`, `{"parallel": {...}}`, `{"helpers": {...}}` and
`{"kernels": [...]}`,
the
card's name and power limit as nvidia-smi gives them, and last
`{"ok": true, "device": {...}}`. It exits non-zero, printing
no result, when there is no CUDA card, when the port cannot be imported, or
when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.profiler
from torch.utils._python_dispatch import TorchDispatchMode

from ddiffpg_tpu_torch.agents import make_agent
from ddiffpg_tpu_torch.agents.ddiffpg import collect, explore_actions
from ddiffpg_tpu_torch.config import Config, algo_preset, preprocess
from ddiffpg_tpu_torch.envs import make
from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
from ddiffpg_tpu_torch.envs.base import VecEnv
from ddiffpg_tpu_torch.envs.panda import PandaTaskEnv
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy
from ddiffpg_tpu_torch.modes import _native
from ddiffpg_tpu_torch.ops import dtw, dtw_cuda
from ddiffpg_tpu_torch.physics import engine, maze
from ddiffpg_tpu_torch.physics.engine_cl import Engine, chol_solve
from ddiffpg_tpu_torch.physics import quat as Q
from ddiffpg_tpu_torch.physics.panda import (JOINT_LIMIT_HI, JOINT_LIMIT_LO,
                                             Arm, build_panda_scene)
from ddiffpg_tpu_torch.physics.substep import (SubstepConstants,
                                               substep_reference)
from ddiffpg_tpu_torch.physics.substep_cuda import (SubstepKernel, build,
                                                    build_all)
from ddiffpg_tpu_torch.replay import episodic as ep

NUM_ENVS = 4096          # bench.py's headline cell
EVAL_ENVS = 20           # the eval batch: checks the kernel's tail masking
BASELINE_ENVS = 256      # the baselines' stock train env (phase 14)
N_STEPS = 64             # control steps of the timed collect (bench.py:71)
N_PLAIN_STEPS = 4        # ant control steps timed with the plain physics
N_REACH_STEPS = 16       # PandaReachJoints-v3 control steps
N_PANDA_PLAIN_STEPS = 2  # DrawerMulti control steps with the plain physics
P_EXPLOIT = 0.5
NUM_MODES = 2            # live behaviour modes (exercises the mode gather)
PANDA_TASKS = ("Reach", "PegInsertion", "DrawerMulti", "Cabinet")
# kernel vs plain version: one substep as tests/test_pallas.py holds the
# Pallas kernel (ant qpos 5e-6 / qvel 5e-5, Panda 1e-5 / 2e-4); more
# substeps compound the ulp-level differences of single float32 ops
# (PyTorch's CUDA division by a Python number multiplies by its reciprocal;
# the kernel divides) through contact thresholds and the Cholesky solve, so
# those bounds are ten times wider; for Panda's twenty substeps the
# kp = 2e4 servos amplify them further, and qvel's bound is 25 times wider
# (2.06e-3 measured on Cabinet, one env of 4096, on an H100)
TOL = {1: (5e-6, 5e-5), 10: (5e-5, 5e-4)}
PANDA_TOL = {1: (1e-5, 2e-4), 20: (1e-4, 5e-3)}
# the Panda ee state (p_ee, v_ee) of `SubstepKernel.ee_state` against the
# plain `Arm.ee_state`: one FK and velocity walk in float32, no substep
EE_STATE_TOL = (1e-5, 1e-4)
TRAIN_ENVS = 1024        # bench.py:26's train-iteration cell
TRAIN_ITERS = 10         # timed train iterations, after 2 untimed
SPLIT_REPS = 5           # calls per part of the host split (median)
PROFILE_CALLS = 5        # calls in a profiler window of a collect part
TRAIN_GROUPS = 3         # live groups of the G > 1 check
DTW_PAIRS = 4096         # pairs of the DTW kernel's check and timing
# kernel vs plain DTW: both round op by op alike (-fmad=false) and both
# square roots round correctly, so phase 10a asks for bitwise equality,
# and for this relative bound beside it
DTW_TOL = 1e-6
N_SUCCESS = 1000         # successes in the stock-size recluster, 500 a route
N_NEW = 64               # new successes before the incremental recluster
SUBSET = 64              # successes of the card-vs-CPU recluster
# one update pass on the card against the CPU, from one state with the same
# draws (4096 samples): float32 GEMMs summed in another order feed one Adam
# step of the parameters (3e-8 and 7e-8 seen on an H100). The action
# gradient's 20 Adam steps of lr 0.03 turn an action's near-zero gradient,
# whose sign the summation order can flip, into a whole step either way:
# one action may end up to 2 lr apart (1.75e-2 seen), while the mean over
# the moved entries stays small
CARD_CPU_TOL = {"critic rows (max)": 1e-4, "critic targets (max)": 1e-4,
                "actor (max)": 1e-4, "target actions (max)": 0.06,
                "target actions (mean over the moved)": 1e-4,
                "logs (max relative)": 1e-3}
# the rest of the model zoo on the card against the CPU from the same
# weights and draws (phase 15): float32 GEMMs of up to 1024 terms summed in
# another order (TF32 off), through at most a K = 5 denoise; relative to
# the larger of 1 and the output's largest magnitude
ZOO_TOL = 1e-4
# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores, HBM
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# elementwise ops the plain substep issues on its [B] rows
ROW_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin",
           "cos", "clamp", "clamp_min", "clamp_max", "maximum", "minimum",
           "where", "gt", "lt", "ge", "le", "eq", "ne", "bitwise_and",
           "bitwise_or", "bitwise_not", "logical_and", "logical_or",
           "logical_not"}


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fns: dict, reps: int) -> dict:
    """Median host wall-clock ms of each fn(), every call between two
    synchronizes, the fns taken in turns after one warm-up each."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def device_ms(fn, reps: int):
    """(device busy ms, substep kernel ms, device activities) per call of
    fn(), from a torch.profiler window of `reps` calls after a warm-up: the
    sums of the device activities' own times. None when the profiler saw
    no device activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sub = count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += e.self_device_time_total
        count += e.count
        if e.key.startswith("substep_kernel"):
            sub += e.self_device_time_total
    if not busy:
        return None
    return busy / 1e3 / reps, sub / 1e3 / reps, count / reps


def host_split(actor, env, state, obs, parts: dict, phase: str, smi: str):
    """Log the host time of one collect step and of its parts (`host_ms`);
    returns the callables and their times for `device_split`."""
    zeros = torch.zeros((env.num_envs, env.action_dim), device=obs.device)
    fns = {"collect step": lambda: actor.collect(env, state, obs, 1),
           "explore_actions": lambda: actor.act(obs),
           "env.step": lambda: env.step(state, zeros), **parts}
    host = host_ms(fns, 20)
    log(phase, "host ms per call (median of 20, each call between "
        "synchronizes, parts in turns): " + ", ".join(
            f"{k} {v:.3f}" for k, v in host.items()) + f" [{smi}]")
    return fns, host


def device_split(fns: dict, host: dict, what: str, smi: str):
    """Log the device time of each of `host_split`'s callables
    (`device_ms`) and its idle share of the host time. Runs after every
    timed phase, so that the profiler slows none of them."""
    for k, fn in fns.items():
        dev = device_ms(fn, PROFILE_CALLS)
        if dev is None:
            log("8 profile", f"{what} {k}: not measured (the profiler saw "
                "no device activity)")
            continue
        log("8 profile", f"{what} {k} on the device (torch.profiler, "
            f"{PROFILE_CALLS} calls): {dev[2]:.0f} device activities, busy "
            f"{dev[0]:.3f} ms, "
            f"of which substep_kernel {dev[1]:.3f} ms; idle "
            f"{1 - dev[0] / host[k]:.1%} of the host time [{smi}]")


class RowOpCounter(TorchDispatchMode):
    """Counts, per env, the elementwise operations run on tensors of B
    rows: each op adds its output's element count over B."""

    def __init__(self, B: int):
        super().__init__()
        self.B = B
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if (name in ROW_OPS and isinstance(out, torch.Tensor)
                and out.numel() % self.B == 0):
            self.ops += out.numel() // self.B
        return out


def substep_bound(c: SubstepConstants, qpos, qvel, ctrl):
    """(bound ms, what sets it, flops per env per substep) of one launch of
    `c.n_substeps` substeps on these inputs: the larger of the flops over
    the card's fp32 peak and the bytes that must move (qpos, qvel, ctrl
    read once; qpos, qvel written once) over its HBM rate. The flops are
    the plain version's elementwise ops on [B] rows for one substep, each
    counted once (a sqrt, sin, cos or division as one)."""
    B = qpos.shape[0]
    counter = RowOpCounter(B)
    with counter:
        substep_reference(c, qpos, qvel, ctrl, n_substeps=1)
    t_ops = counter.ops * c.n_substeps * B / PEAK_FP32_FLOPS
    t_bytes = 4 * B * (2 * c.nq + 2 * c.nv + c.nu) / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, counter.ops


def ee_state_bound(arm: Arm, qpos, qvel):
    """(bound ms, what sets it, flops per env) of one ee-state launch on
    these inputs: the larger of the plain `Arm.ee_state`'s elementwise ops
    on [B] rows over the card's fp32 peak and the bytes that must move
    (qpos, qvel read once; [p_ee, v_ee] written once) over its HBM rate."""
    B = qpos.shape[0]
    counter = RowOpCounter(B)
    with counter:
        arm.ee_state(qpos, qvel)
    t_ops = counter.ops * B / PEAK_FP32_FLOPS
    t_bytes = 4 * B * (qpos.shape[1] + qvel.shape[1] + 6) / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, counter.ops


def dls_ik_bound(arm: Arm, qpos, target, iters: int = 3):
    """(bound ms, what sets it, flops per env) of one IK launch on these
    inputs: the larger of the plain `Arm.dls_ik`'s ops on [B] rows
    (counted as the benchmark's `ik_bound` counts them) over the card's
    fp32 peak and the bytes that must move (qpos and the target read once,
    the 7 arm targets written once) over its HBM rate. The plain FK walks
    every body, drawers and fingers too, where the entry's point needs only
    the hand's ancestors, so the count is above the entry's own work."""
    from benchmark.harness.ik_bound import IKOpCounter

    B = qpos.shape[0]
    counter = IKOpCounter(B)
    with counter:
        arm.dls_ik(qpos, target, iters)
    t_ops = counter.ops * B / PEAK_FP32_FLOPS
    t_bytes = 4 * B * (qpos.shape[1] + 3 + 7) / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, counter.ops


def ant_states(init_qpos: np.ndarray, B: int, seed: int, wall: bool,
               device="cuda"):
    """Random ant states as tests/test_pallas.py draws them; with `wall`,
    torsos sit 0.45 m from the start cell's walls moving into them, half
    against the x = -2 face and half against the y = +2 face."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(init_qpos[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    if wall:
        h = B // 2
        qpos[:h, 0] = -1.55 + rng.uniform(-0.1, 0.1, h)
        qvel[:h, 0] = -2.0
        qpos[h:, 1] = 1.55 + rng.uniform(-0.1, 0.1, B - h)
        qvel[h:, 1] = 2.0
    return tuple(torch.tensor(a, device=device) for a in (qpos, qvel, ctrl))


def panda_states(m, meta, B: int, seed: int, device="cuda"):
    """Panda states as tests/test_pallas.py draws them: the init pose plus
    arm noise U(-0.1, 0.1), qvel U(-0.2, 0.2), servo targets the neutral
    pose plus U(-0.05, 0.05) and fingers at 0.015."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (B, 7))
    qvel = rng.uniform(-0.2, 0.2, (B, m.nv)).astype(np.float32)
    ctrl = np.tile(np.concatenate([meta["neutral"], [0.015, 0.015]])[None],
                   (B, 1)).astype(np.float32)
    ctrl[:, :7] += rng.uniform(-0.05, 0.05, (B, 7))
    return tuple(torch.tensor(a, device=device) for a in (qpos, qvel, ctrl))


def drawer_contact_states(m, meta, c: SubstepConstants, B: int, seed: int,
                          device="cuda"):
    """DrawerMulti states in which the hand's or a finger's probe sits 1-5
    mm inside a drawer's front face. Arm poses are drawn uniformly within
    the joint limits; for a pose whose probe lies within a drawer's y-z
    extent, that drawer's joint is set from the probe's x (the port's fk)
    and the servos hold the pose. qvel and the fingers as `panda_states`."""
    qpos, qvel, ctrl = panda_states(m, meta, B, seed, device)
    g = torch.Generator(device=device).manual_seed(seed)
    arm = torch.as_tensor(meta["arm_qposadr"], device=device)
    lo = torch.tensor(JOINT_LIMIT_LO, device=device)
    hi = torch.tensor(JOINT_LIMIT_HI, device=device)
    n = 200 * B
    cand = torch.tensor(np.asarray(m.init_qpos), device=device).repeat(n, 1)
    cand[:, arm] = lo + (hi - lo) * torch.rand((n, 7), generator=g,
                                               device=device)
    pos, quat = engine.fk(m, cand)
    pb = torch.as_tensor(c.probe_body, device=device)
    pw = pos[:, pb] + Q.rotate(quat[:, pb], torch.tensor(c.probe_off,
                                                         device=device))
    dpos = torch.tensor(m.body_pos[meta["task_body_idx"]], device=device)
    half = torch.tensor(c.dbox_half, device=device)              # [4, 3]
    pen = 0.001 + 0.004 * torch.rand((n, 1), generator=g, device=device)
    gripper = (meta["hand_idx"], *meta["finger_idx"])
    found = torch.zeros(n, dtype=torch.bool, device=device)
    drawer = torch.zeros(n, dtype=torch.long, device=device)
    joint = torch.zeros(n, device=device)
    for k in [k for k in range(c.npr) if c.probe_body[k] in gripper]:
        p = pw[:, k, None]                                        # [n, 1, 3]
        near = (((p[..., 1] - dpos[:, 1]).abs() < half[:, 1] - 0.01)
                & ((p[..., 2] - dpos[:, 2]).abs() < half[:, 2] - 0.01))
        # the drawer slides along -x: front face at x = x0 - q - half_x
        q = dpos[:, 0] - half[:, 0] - (p[..., 0] + c.probe_rad[k] - pen)
        ok = near & (q > 0.01) & (q < 0.24) & ~found[:, None]
        j = torch.argmax(ok.to(torch.int32), dim=1)
        hit = ok.any(dim=1)
        drawer = torch.where(hit, j, drawer)
        joint = torch.where(hit, q.gather(1, j[:, None])[:, 0], joint)
        found = found | hit
    idx = torch.nonzero(found)[:B, 0]
    if idx.numel() < B:
        raise RuntimeError(f"only {idx.numel()} drawer-contact poses found")
    qpos[:, arm] = cand[idx][:, arm]
    adr = torch.as_tensor(meta["task_qposadr"], device=device)[drawer[idx]]
    qpos[torch.arange(B, device=device), adr] = joint[idx]
    ctrl[:, :7] = cand[idx][:, arm]
    return qpos, qvel, ctrl


def without_dynamic_boxes(c: SubstepConstants) -> SubstepConstants:
    return dataclasses.replace(
        c, ndb=0, dbox_body=(), dbox_ident=(), dbox_pos=c.dbox_pos[:0],
        dbox_quat=c.dbox_quat[:0], dbox_half=c.dbox_half[:0],
        dbox_keep=c.dbox_keep[:0])


def check_kernel(kern: SubstepKernel, label: str, args, tol, phase: str):
    """Kernel vs plain version at NUM_ENVS rows; the launches at
    BASELINE_ENVS and EVAL_ENVS rows (the kernel's tail masking) must give
    the largest one's first rows bit for bit, which holds them to the
    plain version too. Returns the largest error."""
    full = tuple(a[:NUM_ENVS].contiguous() for a in args)
    got = kern(*full)
    ref = substep_reference(kern.consts, *full)
    torch.cuda.synchronize()
    eq = float((got[0] - ref[0]).abs().max())
    ev = float((got[1] - ref[1]).abs().max())
    tq, tv = tol
    ok = eq <= tq and ev <= tv and all(
        bool(torch.isfinite(g).all()) for g in got)
    log(phase, f"{label} B={NUM_ENVS} n_substeps={kern.consts.n_substeps}: "
        f"max|err| qpos {eq:.3e} (tol {tq:g}) qvel {ev:.3e} (tol {tv:g})"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("kernel disagrees with plain version")
    for B in (BASELINE_ENVS, EVAL_ENVS):
        small = kern(*(a[:B].contiguous() for a in args))
        same = all(torch.equal(a, b[:B]) for a, b in zip(small, got))
        log(phase, f"{label} B={B} n_substeps={kern.consts.n_substeps}: "
            f"bitwise the B={NUM_ENVS} launch's first rows {same}")
        if not same:
            raise RuntimeError(f"{label}: B={B} rows differ from "
                               f"B={NUM_ENVS} rows")
    return max(eq, ev)


def check_ee_state(kern: SubstepKernel, arm: Arm, qpos, qvel, label: str,
                   phase: str):
    """`kern.ee_state` against the plain `arm.ee_state` at NUM_ENVS rows
    (EE_STATE_TOL); the launches at BASELINE_ENVS and EVAL_ENVS rows must
    give the largest one's first rows bit for bit. Returns the largest
    error."""
    got = kern.ee_state(qpos, qvel, arm.hand, arm.ee_offset_host)
    p_ee, v_ee = arm.ee_state(qpos, qvel)
    torch.cuda.synchronize()
    ep = float((got[:, :3] - p_ee).abs().max())
    ev = float((got[:, 3:] - v_ee).abs().max())
    tp, tv = EE_STATE_TOL
    ok = ep <= tp and ev <= tv and bool(torch.isfinite(got).all())
    log(phase, f"{label} ee state B={NUM_ENVS}: max|err| p_ee {ep:.3e} "
        f"(tol {tp:g}) v_ee {ev:.3e} (tol {tv:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ee-state kernel disagrees with Arm.ee_state")
    for B in (BASELINE_ENVS, EVAL_ENVS):
        small = kern.ee_state(qpos[:B].contiguous(), qvel[:B].contiguous(),
                              arm.hand, arm.ee_offset_host)
        same = torch.equal(small, got[:B])
        log(phase, f"{label} ee state B={B}: bitwise the B={NUM_ENVS} "
            f"launch's first rows {same}")
        if not same:
            raise RuntimeError(f"{label} ee state: B={B} rows differ from "
                               f"B={NUM_ENVS} rows")
    return max(ep, ev)


def ik_inputs(arm: Arm, qpos, seed: int):
    """Targets [B, 3] as the `ee` control sets them: the ee point of qpos
    moved by U(-0.05, 0.05) on each axis."""
    g = torch.Generator(device=qpos.device).manual_seed(seed)
    step = torch.rand((qpos.shape[0], 3), generator=g,
                      device=qpos.device) * 0.1 - 0.05
    return arm.ee_point(qpos) + step


def check_dls_ik(kern: SubstepKernel, arm: Arm, qpos, target, label: str,
                 phase: str):
    """The kernel's IK entry (`ee_point`, `dls_ik`) against the plain
    `Arm.ee_point` and `Arm.dls_ik` at NUM_ENVS rows (`arm` holds no
    kernel): bit for bit, as the `ee` control's servos need; the launches
    at BASELINE_ENVS and EVAL_ENVS rows must give the largest one's first
    rows bit for bit. Returns the largest error."""
    args = (arm.arm_body_host, arm.hand, arm.ee_offset_host, 3, 0.05)
    got = kern.dls_ik(qpos, target, *args)
    got_p = kern.ee_point(qpos, arm.hand, arm.ee_offset_host)
    want = arm.dls_ik(qpos, target)
    want_p = arm.ee_point(qpos)
    torch.cuda.synchronize()
    err = max(float((got - want).abs().max()),
              float((got_p - want_p).abs().max()))
    ok = (torch.equal(got, want) and torch.equal(got_p, want_p)
          and bool(torch.isfinite(got).all()))
    log(phase, f"{label} DLS IK B={NUM_ENVS}: max|err| of the arm targets "
        f"and the ee point {err:.3e} (bit for bit: {ok})")
    if not ok:
        raise RuntimeError("IK kernel disagrees with Arm.dls_ik")
    for B in (BASELINE_ENVS, EVAL_ENVS):
        small = kern.dls_ik(qpos[:B].contiguous(), target[:B].contiguous(),
                            *args)
        same = torch.equal(small, got[:B])
        log(phase, f"{label} DLS IK B={B}: bitwise the B={NUM_ENVS} "
            f"launch's first rows {same}")
        if not same:
            raise RuntimeError(f"{label} DLS IK: B={B} rows differ from "
                               f"B={NUM_ENVS} rows")
    return err


def check_collect(env, roll, state, t_before, n_steps: int, what: str):
    """Finite records of the right shapes, actions in [-1, 1], and
    auto-reset: an env's clock restarts at 0 on the step it finished.
    Returns the number of envs that finished inside the window."""
    B = env.num_envs
    for k in ("action", "obs", "reward"):
        if not bool(torch.isfinite(getattr(roll, k)).all()):
            raise RuntimeError(f"{what}: non-finite {k} in the collect")
    if roll.action.abs().max() > 1.0:
        raise RuntimeError(f"{what}: action outside [-1, 1]")
    if (tuple(roll.obs.shape) != (n_steps, B, env.obs_dim)
            or tuple(roll.action.shape) != (n_steps, B, env.action_dim)):
        raise RuntimeError(f"{what}: collect records have the wrong shapes")
    steps = torch.arange(n_steps, device="cuda")[:, None]
    last_done = torch.where(roll.done, steps, -1).max(dim=0).values
    expect_t = torch.where(last_done >= 0, n_steps - 1 - last_done,
                           t_before + n_steps).to(torch.int32)
    n_reset = int(roll.done.any(dim=0).sum())
    if n_reset == 0 or not torch.equal(state.t, expect_t):
        raise RuntimeError(f"{what}: auto-reset check failed ({n_reset} "
                           "envs done)")
    return n_reset


class Actor:
    """The stock-width diffusion policy of `Config()` for one env, with its
    mode embeddings and noise range (random weights from seed 0)."""

    def __init__(self, env, cfg: Config, gen: torch.Generator):
        emb_dim = cfg.algo.embedding_dim
        self.policy = DiffusionPolicy(
            env.action_dim, env.obs_dim + emb_dim,
            cfg.diffusion.diffusion_iter, device="cuda",
            generator=torch.Generator().manual_seed(0))
        self.embeddings = torch.randn((cfg.algo.max_modes + 1, emb_dim),
                                      generator=gen, device="cuda")
        self.num_modes = torch.tensor(NUM_MODES, device="cuda")
        self.std = (cfg.algo.noise.std_min, cfg.algo.noise.std_max)
        self.gen = gen

    def collect(self, env, state, obs, n_steps: int):
        return collect(env, self.policy, state, obs, n_steps, P_EXPLOIT,
                       self.embeddings, self.num_modes, *self.std,
                       generator=self.gen)

    def act(self, obs):
        return explore_actions(self.policy, obs, P_EXPLOIT, self.embeddings,
                               self.num_modes, *self.std, generator=self.gen)


def timed_collect(actor: Actor, env, kernel: SubstepKernel, n_steps: int,
                  what: str):
    """Reset with staggered episode clocks (so truncation and auto-reset
    fall inside the window), one warm-up step, then `n_steps` timed control
    steps with the kernel's counts (`launches`, `ee_launches`,
    `ik_launches`) set to 0 just before and read just after: a Panda
    kernel must have launched its ee state once a step too, and under the
    `ee` control its IK entry twice a step (the ee point, the IK).
    Returns (state, obs, rollout, seconds, launches, envs reset)."""
    state, obs = env.reset()
    t_start = torch.randint(0, env.max_episode_length, (env.num_envs,),
                            generator=actor.gen, device="cuda",
                            dtype=torch.int32)
    state, obs, _ = actor.collect(env, state._replace(t=t_start), obs, 1)
    t_before = state.t.clone()
    torch.cuda.synchronize()
    kernel.launches = kernel.ee_launches = kernel.ik_launches = 0
    t0 = time.time()
    state, obs, roll = actor.collect(env, state, obs, n_steps)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = kernel.launches
    if launches != n_steps:
        raise RuntimeError(f"{what}: collect launched the kernel {launches} "
                           "times")
    ik = kernel.ik_launches
    ee_ctrl = getattr(env.env, "control_type", None) == "ee"
    if ik != (2 * n_steps if ee_ctrl else 0):
        raise RuntimeError(f"{what}: collect launched the IK {ik} times")
    ee = kernel.ee_launches
    if ee != (n_steps if kernel.consts.has_servo else 0):
        raise RuntimeError(f"{what}: collect launched the ee state {ee} "
                           "times")
    n_reset = check_collect(env, roll, state, t_before, n_steps, what)
    return state, obs, roll, seconds, launches, n_reset


def goal_probe(env, set_qpos, phase: str, where: str):
    state, _ = env.reset()
    qpos = state.qpos.clone()
    set_qpos(qpos)
    state, _, reward, done, info = env.step(
        state._replace(qpos=qpos),
        torch.zeros((env.num_envs, env.action_dim), device="cuda"))
    got = (float(reward[0]), bool(done[0]), int(info["success"][0]),
           int(state.t[0]))
    if got != (10.0, True, 1, 0):
        raise RuntimeError(f"goal probe: (reward, done, success, t) = {got}")
    log(phase, f"env 0 {where}: reward {got[0]}, done {got[1]}, success "
        f"{got[2]}, t {got[3]}")


def replay_add_bytes(E: int, L: int, D: int, A: int, G: int, NG: int = 1):
    """Bytes one `replay.episodic.add` moves, counted from the shapes
    (float32 4 bytes, bools 1), each input read once and each output
    written once: (an env step with no finishing env, the extra per
    finishing env, an env step in the JAX package's formulation, which
    rewrites E slot rows of every table and re-selects the whole in-flight
    tables). E envs, episodes of L steps, obs D, action A, G group rows of
    target actions, NG goal anchors."""
    f = 4
    row = ((L + 1) * D + L * A + L) * f + L      # obs, action, reward, done
    slot = row + 3 * f + NG * f                  # + length, success, id
    step = E * ((2 * D + A + 1 + NG + 1) * f + 2     # the inputs
                + (2 * D + A + 1 + 2 * NG + 2) * f + 1)  # in-flight rows
    finisher = (row + slot + G * L * A * f + L * A * f  # read, slot, table
                + row + f + NG * f)              # in-flight rows zeroed
    jax_step = step + E * (2 * slot + 2 * G * L * A * f + row + L * A * f) \
        + 2 * E * (row + f + NG * f)
    return step, finisher, jax_step


def stock_config(name: str, **over) -> Config:
    """The stock DDiffPG config for env `name` (`algo_preset`, then
    `preprocess`), at TRAIN_ENVS envs, seed 0, with `over` applied
    before `preprocess`."""
    cfg = Config(algo=algo_preset("ddiffpg")).override(
        **{"env.name": name, **over})
    return preprocess(cfg).override(num_envs=TRAIN_ENVS, seed=0)


def to_device(x, device):
    """Tensors, and tuples of them, on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if x is None:
        return None
    return type(x)(*(to_device(v, device) for v in x))


def check_logs(logs: dict, what: str):
    bad = [k for k, v in logs.items() if not bool(torch.isfinite(v))]
    if bad:
        raise RuntimeError(f"{what}: non-finite logs {bad}")


def critic_rows(ts) -> list:
    """Copies of the stacked critics, targets and their adam states."""
    return [x.detach().clone() for x in
            ts.critics.params() + ts.critic_targets.params()
            + ts.critic_opts.mu + ts.critic_opts.nu
            + [ts.critic_opts.count]]


def pass_parts(agent, state: list) -> dict:
    """Median host ms of each part of an update pass (the agent's `mark`
    hook, a synchronize at each mark) over SPLIT_REPS passes after one
    warm-up; `state[0]` is updated."""
    parts = {}
    for _ in range(SPLIT_REPS + 1):
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            parts.setdefault(name, []).append((now - last[0]) * 1e3)
            last[0] = now

        state[0], _ = agent.update_once(state[0], mark=mark)
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def card_vs_cpu(agent, ts, cfg, G: int):
    """One update pass on the card and on the CPU from copies of one state
    with the same draws; the largest differences, each against its bound
    in CARD_CPU_TOL."""
    cpu_env = make("antmaze-v1", num_envs=agent.env.num_envs,
                   random_init=True, device="cpu")
    cpu_agent = make_agent("DDiffPG", cpu_env, cfg, device="cpu")
    cpu_agent.num_groups = agent.num_groups = G
    draws = agent.draw_update(ts, G)
    cpu_ts = ts.to("cpu")
    table = ts.replay.target_action.clone()
    ts, logs = agent.update_once(ts, G, draws)
    t0 = time.time()
    cpu_ts, cpu_logs = cpu_agent.update_once(cpu_ts, G,
                                             to_device(draws, "cpu"))
    cpu_s = time.time() - t0
    def diff(xs, ys):
        return max(float((x.detach().cpu() - y.detach()).abs().max())
                   for x, y in zip(xs, ys))

    got = {
        "critic rows (max)": diff([p[:G] for p in ts.critics.params()],
                            [p[:G] for p in cpu_ts.critics.params()]),
        "critic targets (max)": diff(
            [p[:G] for p in ts.critic_targets.params()],
            [p[:G] for p in cpu_ts.critic_targets.params()]),
        "actor (max)": diff(list(ts.actor.parameters()),
                      list(cpu_ts.actor.parameters())),
        "target actions (max)": diff([ts.replay.target_action],
                               [cpu_ts.replay.target_action]),
        "target actions (mean over the moved)": float(
            (ts.replay.target_action - cpu_ts.replay.target_action.to(
                table.device)).abs()[ts.replay.target_action != table]
            .mean()),
        "logs (max relative)": max(
            abs(float(logs[k]) - float(cpu_logs[k]))
            / max(abs(float(cpu_logs[k])), 1e-6) for k in logs)}
    for k, v in got.items():
        ok = v <= CARD_CPU_TOL[k]
        log("9 train", f"card vs CPU, one update pass at G={G}: {k} "
            f"|diff| {v:.3e} (bound {CARD_CPU_TOL[k]:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"card and CPU disagree on {k}")
    log("9 train", f"the CPU's update pass took {cpu_s:.1f} s")
    return ts, got


def train_phase(smi: str):
    """Stock DDiffPG on antmaze-v1 at TRAIN_ENVS envs: warm-up, timed
    train iterations (the kernel's launches counted), the host split of an
    iteration and of an update pass, the device time of an iteration from
    a profiler window, then three live groups with rows >= 3 untouched and
    one update pass on the card against the CPU (neither timed). Returns
    (the train record, the kernel's launches in the timed window)."""
    cfg = stock_config("antmaze-v1")
    torch.cuda.reset_peak_memory_stats()
    env = make("antmaze-v1", num_envs=TRAIN_ENVS,
               random_init=cfg.env.random_init, device="cuda", seed=0)
    ant: AntMazeEnv = env.env
    agent = make_agent("DDiffPG", env, cfg)
    t0 = time.time()
    ts = agent.warmup(agent.init())
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    L = env.max_episode_length
    full = int((ts.replay.length == L).sum())
    stored = int((ts.replay.traj_id >= 0).sum())
    log("9 train", f"init + warm-up ({cfg.algo.warm_up} random steps x "
        f"{TRAIN_ENVS} envs): {warm_s:.2f} s; {stored} trajectories stored, "
        f"{full} of length {L} [{smi}]")
    step, fin, jax_step = replay_add_bytes(
        TRAIN_ENVS, L, env.obs_dim, env.action_dim, agent.G_max,
        ts.replay.frontier.shape[1])
    log("9 train", f"replay add, bytes from the shapes: {step:,} an env step "
        f"without a finisher, {fin:,} more per finishing env; the JAX "
        f"formulation {jax_step:,} an env step")
    if full != TRAIN_ENVS or stored != TRAIN_ENVS:
        raise RuntimeError("warm-up did not flush every env's episode")

    spi = TRAIN_ENVS * cfg.algo.horizon_len
    steps = int(ts.global_step)
    for _ in range(2):
        ts, logs = agent.train_iter(ts, steps)
        steps += spi
    torch.cuda.synchronize()
    ant.kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        ts, logs = agent.train_iter(ts, steps)
        steps += spi
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / TRAIN_ITERS
    launches = ant.kernel.launches
    if launches != cfg.algo.horizon_len * TRAIN_ITERS:
        raise RuntimeError(f"train: the kernel launched {launches} times in "
                           f"{TRAIN_ITERS} iterations")
    check_logs(logs, "train")
    log("9 train", f"{TRAIN_ITERS} train iterations (horizon "
        f"{cfg.algo.horizon_len}, {cfg.algo.update_times} update passes, "
        f"batch {cfg.algo.batch_size}): {s_iter:.4f} s per iteration, "
        f"{spi / s_iter:.0f} env steps/s, kernel launches {launches} "
        f"[{smi}]")
    log("9 train", "logs: " + ", ".join(f"{k} {float(v):.4g}"
                                        for k, v in logs.items()))
    peak = torch.cuda.max_memory_allocated()

    state = [ts]
    p = agent.get_exp_p(steps)

    def env_step():
        state[0] = agent._env_step(state[0], p, random=False)

    def update_passes():
        for _ in range(cfg.algo.update_times):
            state[0], _ = agent.update_once(state[0])

    def train_iter():
        state[0], _ = agent.train_iter(state[0], steps)

    host = host_ms({"train iteration": train_iter, "env step": env_step,
                    f"{cfg.algo.update_times} update passes": update_passes},
                   SPLIT_REPS)
    parts = pass_parts(agent, state)
    log("9 train", f"host ms (median of {SPLIT_REPS}, each call between "
        "synchronizes): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
        + "; one update pass by part: " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()) + f" [{smi}]")

    # the profiler last, after every timed call
    dev = device_ms(train_iter, 3)
    if dev is None:
        busy = idle = None
        log("9 train", "train iteration on the device: not measured (the "
            "profiler saw no device activity)")
    else:
        busy, idle = dev[0], 1 - dev[0] / host["train iteration"]
        log("9 train", f"train iteration on the device (torch.profiler, 3 "
            f"iterations): {dev[2]:.0f} device activities, busy "
            f"{busy:.2f} ms, of which substep_kernel {dev[1]:.3f} ms; idle "
            f"{idle:.1%} of the host time; peak memory "
            f"{peak / 2**20:.0f} MiB [{smi}]")

    # G = 3: hand-made groups, parents [0, 0, -1, ...]
    ts = state[0]
    S, G = ts.replay.capacity, TRAIN_GROUPS
    valid = ts.replay.length > 0
    odd = torch.arange(S, device="cuda") % 2 == 1
    mask = torch.zeros((agent.G_max, S), dtype=torch.bool, device="cuda")
    mask[0], mask[1], mask[2] = valid, valid & ~odd, valid & odd
    ep.set_groups(ts.replay, mask, [0, 0] + [-1] * (agent.G_max - 2))
    agent.num_groups = G
    before = critic_rows(ts)
    for _ in range(2):
        ts, logs = agent.train_iter(ts, steps)
        steps += spi
        check_logs(logs, f"train at G={G}")
    after = critic_rows(ts)
    if not all(torch.equal(x[G:], y[G:]) for x, y in zip(after, before)):
        raise RuntimeError(f"train at G={G}: rows >= {G} moved")
    if any(torch.equal(x[1:G], y[1:G]) for x, y in zip(after, before)):
        raise RuntimeError(f"train at G={G}: rows 1..{G - 1} did not move")
    log("9 train", f"G={G}: two train iterations, logs finite, critic rows "
        f"{G}..{agent.G_max - 1} (params, targets, adam) bitwise unchanged, "
        f"rows 1..{G - 1} moved; critic_loss "
        f"{float(logs['train/critic_loss']):.4g}")
    _, card_cpu = card_vs_cpu(agent, ts, cfg, G)

    record = {
        "env": "antmaze-v1", "num_envs": TRAIN_ENVS,
        "batch_size": cfg.algo.batch_size,
        "update_times": cfg.algo.update_times,
        "action_gradient_steps": cfg.diffusion.update_times,
        "warmup_s": warm_s, "s_per_train_iter": s_iter,
        "env_steps_per_s": spi / s_iter, "kernel_launches": launches,
        "host_ms": host, "update_pass_ms": parts,
        "device_busy_ms_per_iter": busy, "device_idle_share": idle,
        "peak_memory_bytes": peak, "card_vs_cpu": card_cpu, "card": smi}
    return record, launches


def kernel_entry(name: str, launches: int, err: float, ms: float,
                 plain_ms: float, bound,
                 source: str = "ddiffpg_tpu_torch/csrc/substep.cu",
                 replaces: str = "ddiffpg_tpu/physics/pallas_ant.py:143"
                 ) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


# ------------------------------------------------------------ 10. the loop

def path_track(rng, n: int, corners, wander: float,
               noise: float) -> np.ndarray:
    """n + 1 points evenly along the polyline `corners` (its width is Dx),
    with a random walk of step `wander` and point noise `noise` added."""
    corners = np.asarray(corners, np.float64)
    seg = np.linalg.norm(np.diff(corners, axis=0), axis=1)
    at = np.concatenate([[0], np.cumsum(seg)])
    s = np.linspace(0.0, seg.sum(), n + 1)
    D = corners.shape[1]
    pts = np.stack([np.interp(s, at, corners[:, d]) for d in range(D)], 1)
    walk = np.cumsum(rng.randn(n + 1, D), axis=0) * wander
    return pts + walk + noise * rng.randn(n + 1, D)


def route_track(rng, n: int, y: float) -> np.ndarray:
    """n + 1 xy points of an antmaze-v1 success: from the reset cell (0, 0)
    up or down the corridor at y = +-4, around MAZE_v1's central wall, to
    the goal (-8, 0), with a slow wander and point noise."""
    return path_track(rng, n, [[0.0, 0.0], [0.0, y], [-8.0, y], [-8.0, 0.0]],
                      0.02, 0.05)


def failure_track(rng, n: int) -> np.ndarray:
    """n + 1 xy points of a failure: a random walk in the reset cell."""
    return np.clip(np.cumsum(rng.randn(n + 1, 2) * 0.1, axis=0), -1.9, 1.9)


def write_trajectories(ts, plans, steps: int, seed: int):
    """Record synthetic trajectories through `replay/episodic.py:add`, one
    env step at a time for `steps` steps. plans[e] lists env e's
    trajectories in order as (kind, n steps, route y): kind "success"
    (reward 10 and goal id 1 on its last step) or "failure"; an env whose
    plan ends before `steps` leaves the rest in flight. Obs are the track's
    xy and zeros."""
    rng = np.random.RandomState(seed)
    rep = ts.replay
    E, D = rep.tmp_obs.shape[0], rep.obs.shape[-1]
    A = rep.action.shape[-1]
    xy = np.zeros((2, steps, E, 2), np.float32)      # obs, next obs
    end = np.zeros((steps, E), bool)
    succ = np.zeros((steps, E), np.int32)
    for e, plan in enumerate(plans):
        t = 0
        for kind, n, y in plan + [("flight", steps - sum(
                p[1] for p in plan), 0.0)]:
            if n <= 0:
                continue
            tr = route_track(rng, n, y) if kind == "success" else \
                failure_track(rng, n)
            xy[0, t: t + n, e], xy[1, t: t + n, e] = tr[:-1], tr[1:]
            if kind != "flight":
                end[t + n - 1, e] = True
                succ[t + n - 1, e] = kind == "success"
            t += n
    dev = rep.obs.device
    xy, end, succ = (torch.tensor(a, device=dev) for a in (xy, end, succ))
    goal = torch.tensor([[-8.0, 0.0]], device=dev)
    obs = torch.zeros((2, steps, E, D), device=dev)
    obs[..., :2] = xy
    for t in range(steps):
        ep.add(rep, obs[0, t], torch.zeros((E, A), device=dev),
               10.0 * succ[t], obs[1, t], end[t] & (succ[t] > 0), end[t],
               succ[t], goal_dist=torch.linalg.vector_norm(
                   obs[1, t, :, None, :2] - goal, dim=-1))
    return ts


def dtw_inputs(seed: int, n_tracks: int, pairs: int, device="cuda"):
    """antmaze-like xy tracks (the two routes and failures, lengths
    300-500, Dx 2) stacked [N, 500, 2], with `pairs` random pairs of them
    and edge pairs (length 1 and 2 against themselves and against 500)."""
    rng = np.random.RandomState(seed)
    L = 500
    lens = rng.randint(300, L + 1, n_tracks).astype(np.int32)
    lens[:3] = (1, 2, L)
    stack = np.zeros((n_tracks, L, 2), np.float32)
    for k, n in enumerate(lens):
        tr = route_track(rng, n, (4.0, -4.0)[k % 2]) if k % 3 else \
            failure_track(rng, n)
        stack[k, :n] = tr[:n]
    ia = rng.randint(0, n_tracks, pairs).astype(np.int32)
    ib = rng.randint(0, n_tracks, pairs).astype(np.int32)
    edge = np.array([[0, 0], [0, 1], [1, 0], [0, 2], [2, 0], [1, 2],
                     [2, 1], [2, 2]], np.int32)
    ia, ib = np.concatenate([ia, edge[:, 0]]), np.concatenate([ib,
                                                               edge[:, 1]])
    return tuple(torch.tensor(a, device=device)
                 for a in (stack, stack, lens, lens, ia, ib))


def dtw_bound(args):
    """(bound ms, what sets it, flops) of one DTW call on these inputs:
    8 flops a DP cell (Dx subtractions, products and sums, two minimums,
    the add) over sum(la * lb) cells at the fp32 peak, against the bytes
    that must move (each referenced track row read once, the lengths and
    pair indices read, the distances written) at the HBM rate."""
    stack_a, stack_b, la, lb, ia, ib = args
    la_p, lb_p = la[ia.long()].double(), lb[ib.long()].double()
    flops = float((la_p * lb_p).sum()) * 8
    Dx = stack_a.shape[-1]
    rows = float(la[torch.unique(ia.long())].sum()
                 + lb[torch.unique(ib.long())].sum())
    nbytes = 4 * (rows * Dx + la.numel() + lb.numel() + 3 * ia.numel())
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops


def dtw_phase(smi: str):
    """10a: the DTW kernel against its plain version on DTW_PAIRS pairs
    (bitwise), ptxas' report of each template built and the launch
    geometry, then both timed (CUDA events) and the bound. Returns the
    record."""
    t0 = time.time()
    kern = dtw_cuda.get_kernel("cuda")
    report = dtw_cuda.ptxas_report(
        dtw_cuda.build().with_suffix(".log").read_text())
    log("10 loop", f"DTW kernel loaded in {time.time() - t0:.1f} s")
    for (R, D), r in sorted(report.items()):
        log("10 loop", f"DTW kernel R={R} Dx={D}: {r.get('registers')} "
            f"registers, {r.get('stack')} bytes stack frame, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spill "
            "stores / loads")
    args = dtw_inputs(5, 640, DTW_PAIRS)
    L, D = args[0].shape[1:]
    warps, R, shared = dtw_cuda.launch_geometry(L, D)
    if (R, D) not in report or "registers" not in report[(R, D)]:
        raise RuntimeError(f"no ptxas report of the DTW kernel at R={R}, "
                           f"Dx={D}")
    log("10 loop", f"DTW launch at L={L}, Dx={D}: {warps} warps (pairs) a "
        f"block, R={R} rows a lane at most, {shared} shared bytes a block")
    got = dtw.dtw_batch_gather(*args)
    want = dtw.dtw_wavefront(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    bitwise = bool(torch.equal(got, want))
    edge = got[-8:].tolist()
    ok = bitwise and rel <= DTW_TOL and bool(torch.isfinite(got).all()) \
        and edge[0] == 0.0 and edge[-1] == 0.0
    log("10 loop", f"DTW kernel vs plain on {args[4].numel()} pairs "
        f"(lengths 300-500 and 1, 2, 500): max |diff| {err:.3e}, max "
        f"relative {rel:.3e} (bound {DTW_TOL:g}), bitwise {bitwise}; edge "
        f"pairs {edge} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the DTW kernel disagrees with its plain version")
    ms = cuda_ms(lambda: kern(*args), 20)
    plain_ms = cuda_ms(lambda: dtw.dtw_wavefront(*args), 2)
    bound = dtw_bound(args)
    P = args[4].numel()
    log("10 loop", f"DTW of {P} pairs: kernel {ms:.4f} ms "
        f"({P / ms * 1e3:,.0f} pairs/s), plain PyTorch {plain_ms:.2f} ms, "
        f"bound {bound[0]:.5f} ms ({bound[1]}, {bound[2]:.4e} flops; "
        f"{bound[0] / ms:.1%} of it reached) [{smi}]")
    return {"pairs": P, "max_abs_err": err, "max_rel_err": rel,
            "bitwise": bitwise, "ms": ms, "plain_ms": plain_ms,
            "bound": bound, "geometry": {"warps": warps, "R": R,
                                         "shared_bytes": shared},
            "ptxas": {f"R{R}_D{D}": r for (R, D), r in report.items()}}


def fill_plans(rng, n_env: int, n_success: int, steps: int):
    """Per-env trajectory plans for `write_trajectories`: envs 0.. first
    run a success (alternating the two routes, lengths 300 to steps - 20)
    then a failure to the window's end; of the n_success of them the last
    24 run a success of the whole window; the others one failure of the
    window. Returns (plans, successes, failures)."""
    plans = []
    for e in range(n_env):
        y = (4.0, -4.0)[e % 2]
        if e < n_success - 24:
            n = int(rng.randint(300, steps - 19))
            plans.append([("success", n, y), ("failure", steps - n, 0.0)])
        elif e < n_success:
            plans.append([("success", steps, y)])
        else:
            plans.append([("failure", steps, 0.0)])
    n_fail = sum(k == "failure" for p in plans for k, _, _ in p)
    return plans, n_success, n_fail


def recluster_checks(agent, ts, what: str):
    """Two modes, each route's successes in one of them, the two masks
    disjoint on the successes. Returns the number of successes."""
    rep = ts.replay
    valid = (rep.traj_id >= 0) & (rep.length > 0)
    succ = valid & (rep.success > 0)
    L = rep.obs.shape[1] - 1
    steps = torch.arange(L + 1, device=rep.obs.device)
    live = (steps[None] <= rep.length[:, None]).float()
    mean_y = (rep.obs[:, :, 1] * live).sum(1) / live.sum(1)
    upper, lower = succ & (mean_y > 0), succ & (mean_y < 0)
    m = rep.group_mask
    g_up = [g for g in (1, 2) if bool(m[g][upper].all())]
    g_lo = [g for g in (1, 2) if bool(m[g][lower].all())]
    ok = (agent.num_groups == 3 and len(g_up) == len(g_lo) == 1
          and g_up != g_lo and not bool((m[1] & m[2] & succ).any())
          and bool(upper.any()) and bool(lower.any()))
    log("10 loop", f"{what}: {agent.num_clusters} modes, successes "
        f"{int(upper.sum())} upper + {int(lower.sum())} lower, each route "
        f"in one mode, masks disjoint on the successes: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{what}: the recluster did not find the routes")
    return int(succ.sum())


def same_result(a, b) -> bool:
    """Two ClusterResults agree: clusters, masks, evictions, plan, goal
    counts, linkage merges (heights compared apart)."""
    same = (a.num_groups == b.num_groups and a.goal_counts == b.goal_counts
            and a.clusters == b.clusters
            and a.unsuccess_clusters == b.unsuccess_clusters
            and np.array_equal(a.group_mask, b.group_mask)
            and np.array_equal(a.evict_slots, b.evict_slots)
            and all(np.array_equal(getattr(a.plan, f.name),
                                   getattr(b.plan, f.name))
                    for f in dataclasses.fields(a.plan)))
    if a.Z is None or b.Z is None:
        return same and a.Z is None and b.Z is None
    return same and np.array_equal(a.Z[:, [0, 1, 3]], b.Z[:, [0, 1, 3]])


def card_vs_cpu_recluster(ts, cfg, n_success: int):
    """The same recluster on a subset of the replay (its first n_success
    successes and as many failures) by a ClusterManager on the card and
    one on the CPU (the plain DTW): (identical, heights' max relative
    difference, CPU seconds)."""
    from ddiffpg_tpu_torch.modes.cluster import ClusterManager

    rep = ts.replay
    host = lambda x: x.cpu().numpy().copy()  # noqa: E731
    traj_id, length, success = (host(rep.traj_id), host(rep.length),
                                host(rep.success))
    tracks = host(rep.obs[:, :, :2])
    valid = (traj_id >= 0) & (length > 0)
    keep = np.concatenate([np.flatnonzero(valid & (success > 0))[:n_success],
                           np.flatnonzero(valid & (success == 0))[
                               :n_success]])
    drop = np.setdiff1d(np.arange(len(traj_id)), keep)
    traj_id[drop], length[drop] = -1, 0
    a = cfg.algo
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        cm = ClusterManager(capacity=int(a.memory_size),
                            max_modes=a.max_modes,
                            threshold=a.cluster_threshold, seed=cfg.seed,
                            device=dev)
        t0 = time.time()
        res[dev] = cm.recluster(traj_id, length, success, tracks)
        secs[dev] = time.time() - t0
    za, zb = res["cuda"].Z, res["cpu"].Z
    rel = float(np.max(np.abs(za[:, 2] - zb[:, 2])
                       / np.maximum(np.abs(zb[:, 2]), 1e-30)))
    return same_result(res["cuda"], res["cpu"]), rel, secs, \
        res["cuda"].num_groups


def recluster_phase(smi: str):
    """10b: the stock DDiffPG agent on antmaze-v1 at TRAIN_ENVS envs, its
    replay filled through `add` with N_SUCCESS successes on the two routes
    and as many failures; a full recluster timed, then N_NEW new
    successes and an incremental one, then two train iterations at G = 3;
    beside it the recluster of a subset on the card and on the CPU.
    Returns (the record, the DTW kernel's launches in the two
    reclusters)."""
    cfg = stock_config("antmaze-v1")
    env = make("antmaze-v1", num_envs=TRAIN_ENVS,
               random_init=cfg.env.random_init, device="cuda", seed=0)
    agent = make_agent("DDiffPG", env, cfg)
    ts = agent.init()
    rng = np.random.RandomState(0)
    L = env.max_episode_length
    plans, n_succ, n_fail = fill_plans(rng, TRAIN_ENVS, N_SUCCESS, L)
    t0 = time.time()
    write_trajectories(ts, plans, L, 1)
    torch.cuda.synchronize()
    stored = int((ts.replay.traj_id >= 0).sum())
    log("10 loop", f"replay of {ts.replay.capacity} slots filled through "
        f"add: {n_succ} successes, {n_fail} failures, {stored} stored in "
        f"{time.time() - t0:.1f} s [{smi}]")
    kern = dtw_cuda.get_kernel("cuda")
    cm = agent.cluster_manager
    out = {}
    kern.launches = 0
    for what in ("full", "incremental"):
        if what == "incremental":
            # N_NEW envs end a success and a failure inside a window of
            # L - 20 steps; the others stay in flight
            steps = L - 20
            plans = []
            for e in range(N_NEW):
                n = int(rng.randint(300, steps - 19))
                plans.append([("success", n, (4.0, -4.0)[e % 2]),
                              ("failure", steps - n, 0.0)])
            write_trajectories(ts, plans + [[]] * (TRAIN_ENVS - N_NEW),
                               steps, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = agent.update_cluster(ts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = dict(cm.dtw_stats)
        n = recluster_checks(agent, ts, f"{what} recluster")
        out[what] = {"seconds": secs, "dtw_seconds": st["seconds"],
                     "host_seconds": secs - st["seconds"],
                     "pairs": st["pairs"], "calls": st["calls"],
                     "successes": n}
        log("10 loop", f"{what} recluster over {n} successes: {secs:.3f} s, "
            f"{st['pairs']} DTW pairs in {st['calls']} calls, DTW "
            f"{st['seconds']:.3f} s ({st['seconds'] / secs:.1%}), host "
            f"{secs - st['seconds']:.3f} s [{smi}]")
    launches = kern.launches
    if launches == 0:
        raise RuntimeError("the reclusters launched no DTW kernel")
    steps = int(ts.global_step)
    for _ in range(2):
        ts, logs = agent.train_iter(ts, steps)
        steps += TRAIN_ENVS
        check_logs(logs, "train after the recluster")
    log("10 loop", f"two train iterations at G={agent.num_groups}: logs "
        f"finite, critic_loss {float(logs['train/critic_loss']):.4g}")
    same, rel, secs, groups = card_vs_cpu_recluster(ts, cfg, SUBSET)
    log("10 loop", f"recluster of {SUBSET} successes + {SUBSET} failures on "
        f"the card and on the CPU: ClusterResults identical {same} "
        f"({groups} groups; linkage heights max relative difference "
        f"{rel:.3e}); card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s "
        f"[{smi}]")
    if not same:
        raise RuntimeError("card and CPU reclusters differ")
    out["card_vs_cpu"] = {"identical": same, "heights_max_rel": rel,
                          "card_s": secs["cuda"], "cpu_s": secs["cpu"]}
    return out, launches


def loop_phase(smi: str, keep: Path):
    """10c: `ddiffpg_tpu_torch.train.main` with the stock config on
    antmaze-v1 at TRAIN_ENVS envs: warm-up, the initial recluster, four
    train iterations with an eval and a recluster every two, a light
    checkpoint at the second eval, the final full checkpoint. Checks the
    substep kernel's launches (once an env step, eval included) and that
    the final checkpoint loads back equal tensor by tensor. The run's
    directory moves to `keep` (phase 15 reads it). Returns the record."""
    from ddiffpg_tpu_torch import train
    from ddiffpg_tpu_torch.utils import checkpoint as ckpt

    cfg = stock_config("antmaze-v1")
    warm, iters = cfg.algo.warm_up, 4
    made, make_envs = [], train.make_envs

    def recording_make_envs(*a, **k):
        made.extend(make_envs(*a, **k))
        return made[-2:]

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        train.make_envs = recording_make_envs
        try:
            t0 = time.time()
            ts = train.main([
                "algo=ddiffpg", "env.name=antmaze-v1",
                f"num_envs={TRAIN_ENVS}", "seed=0", "eval_freq=2",
                "ckpt_freq_mult=1",
                f"max_step={(warm + iters) * TRAIN_ENVS}",
                f"logdir={tmp}", "run_name=smoke"])
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            train.make_envs = make_envs
        peak = torch.cuda.max_memory_allocated()
        train_env, eval_env = made[:2]
        launches = {"train": train_env.env.kernel.launches,
                    "eval": eval_env.env.kernel.launches}
        want = {"train": warm + cfg.algo.horizon_len * iters,
                "eval": 2 * eval_env.max_episode_length}
        log("10 loop", f"train.main: {wall:.1f} s; substep kernel launches "
            f"{launches} (want {want}); peak memory {peak / 2**20:.0f} MiB "
            f"[{smi}]")
        if launches != want:
            raise RuntimeError("the loop's env steps did not each launch the "
                               "kernel once")
        run = Path(tmp) / "smoke"
        recs = [json.loads(x) for x in
                (run / "metrics.jsonl").read_text().splitlines()]
        times = {}
        for r in recs:
            for k, v in r.items():
                if k.startswith("time/"):
                    times.setdefault(k[5:], []).append(v)
        names = sorted(p.name for p in run.glob("ckpt_*.pt"))
        log("10 loop", f"checkpoints {names}; " + ", ".join(
            f"{k} {v}" for k, v in sorted(times.items())) + f" [{smi}]")
        evals = sum("eval/return" in r for r in recs)
        if evals != 2 or len(names) != 2:
            raise RuntimeError(f"{evals} evals and checkpoints {names}")
        # the final checkpoint into a fresh state on the card
        env, _ = train.make_envs(cfg, torch.device("cuda"))
        fresh = make_agent("DDiffPG", env, cfg).init()
        fresh, meta = ckpt.load(run / "ckpt_final.pt", fresh)
        got, want_t = dict(ckpt.leaves(fresh)), dict(ckpt.leaves(ts))
        bad = [k for k in want_t if not torch.equal(got[k], want_t[k])]
        log("10 loop", f"final checkpoint reloaded into a fresh state: "
            f"{len(want_t)} tensors, {len(bad)} differ; num_groups "
            f"{meta['num_groups']}")
        if bad or set(got) != set(want_t):
            raise RuntimeError(f"the reload differs: {bad[:5]}")
        shutil.move(str(run), str(keep))
    return {"wall_s": wall, "times": times, "checkpoints": names,
            "substep_launches": launches, "peak_memory_bytes": peak}

# ------------------------------------------- 11-13. every env of the package

OTHER_MAZES = ("antmaze-v2", "antmaze-v2-hard", "antmaze-v3", "antmaze-v4",
               "antmaze-v5")
N_MAZE_STEPS = {"antmaze-v3": 64}   # collect steps at 4096 envs; else 16
MAZE_TRAIN_ITERS = 5                 # timed train iterations, after 2
# ee control targets on the card against the CPU, from copies of one state:
# the 3x3 solves take float32 J J^T from cuBLAS in another order than the
# CPU's, which moves a target by a few ulps (the CPU against JAX:
# 1.2e-6, tests/test_torch_envs_all.py)
EE_CTRL_TOL = 1e-5


def maze_wall_states(init_qpos: np.ndarray, maze_map, B: int, seed: int,
                     device="cuda"):
    """Random ant states (`ant_states`) with each torso 0.45 m outside a
    face of one of the maze's wall cells that borders a free cell (the
    faces drawn uniformly), anywhere along the face's middle 3 m, moving
    into it at 2 m/s."""
    qpos, qvel, ctrl = (a.cpu().numpy() for a in ant_states(
        init_qpos, B, seed, False, device="cpu"))
    ri, rj = maze.find_reset(maze_map)
    rows, cols = len(maze_map), len(maze_map[0])
    faces = []                     # (face centre x, y, outward normal)
    for i in range(rows):
        for j in range(cols):
            if maze_map[i][j] != 1:
                continue
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ni, nj = i + di, j + dj
                if 0 <= ni < rows and 0 <= nj < cols and \
                        maze_map[ni][nj] != 1:
                    cx, cy = (j - rj) * 4.0, (i - ri) * 4.0
                    faces.append((cx + 2.0 * dj, cy + 2.0 * di, dj, di))
    rng = np.random.RandomState(seed)
    pick = np.asarray(faces)[rng.randint(0, len(faces), B)]
    along = rng.uniform(-1.5, 1.5, B)
    nx, ny = pick[:, 2], pick[:, 3]
    qpos[:, 0] = pick[:, 0] + 0.45 * nx + along * np.abs(ny)
    qpos[:, 1] = pick[:, 1] + 0.45 * ny + along * np.abs(nx)
    qvel[:, 0] = np.where(nx != 0, -2.0 * nx, qvel[:, 0])
    qvel[:, 1] = np.where(ny != 0, -2.0 * ny, qvel[:, 1])
    return tuple(torch.tensor(a, device=device) for a in (qpos, qvel, ctrl))


def maze_goal_probe(env, name: str, phase: str):
    """Env k at goal k (0.2, -0.1) away, for every goal of the maze: each
    must pay its reward exactly with its id, end and reset; the others
    go on."""
    goals = maze.GOALS[name]
    state, _ = env.reset()
    qpos = state.qpos.clone()
    for k, (xy, _) in enumerate(goals):
        qpos[k, :2] = torch.tensor(xy, device="cuda") + torch.tensor(
            [0.2, -0.1], device="cuda")
    state, _, reward, done, info = env.step(
        state._replace(qpos=qpos),
        torch.zeros((env.num_envs, env.action_dim), device="cuda"))
    G = len(goals)
    got = (reward[:G].tolist(), info["success"][:G].tolist(),
           bool(done[:G].all()), state.t[:G].tolist())
    want = ([r for _, r in goals], list(range(1, G + 1)), True, [0] * G)
    if got != want or bool(done[G:].any()):
        raise RuntimeError(f"{name} goal probe: (rewards, ids, done, t) "
                           f"{got}, want {want}")
    log(phase, f"{name}: every goal pays (rewards {got[0]}, ids {got[1]}),"
        " ends and resets")


def short_train(name: str, kernel_of, smi: str, phase: str, **over):
    """The stock agent on env `name` at TRAIN_ENVS envs: init and
    warm-up, 2 + MAZE_TRAIN_ITERS train iterations, the kernel's launches
    in the timed ones exactly horizon x iterations, finite logs; one eval
    rollout (cfg.eval_num_envs envs, a whole episode) timed. Returns the
    record."""
    from ddiffpg_tpu_torch.agents.evaluation import eval_rollout

    cfg = stock_config(name, **over)
    torch.cuda.reset_peak_memory_stats()
    env = make(name, num_envs=TRAIN_ENVS, device="cuda", seed=0,
               **({"control_type": cfg.env.control_type}
                  if name.startswith("Panda") else
                  {"random_init": cfg.env.random_init}))
    agent = make_agent("DDiffPG", env, cfg)
    t0 = time.time()
    ts = agent.warmup(agent.init())
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    spi = TRAIN_ENVS * cfg.algo.horizon_len
    steps = int(ts.global_step)
    for _ in range(2):
        ts, logs = agent.train_iter(ts, steps)
        steps += spi
    kern = kernel_of(env)
    torch.cuda.synchronize()
    kern.launches = 0
    t0 = time.perf_counter()
    for _ in range(MAZE_TRAIN_ITERS):
        ts, logs = agent.train_iter(ts, steps)
        steps += spi
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / MAZE_TRAIN_ITERS
    launches = kern.launches
    if launches != cfg.algo.horizon_len * MAZE_TRAIN_ITERS:
        raise RuntimeError(f"{name}: the kernel launched {launches} times in "
                           f"{MAZE_TRAIN_ITERS} train iterations")
    check_logs(logs, f"{name} train")
    eval_env = make(name, num_envs=cfg.eval_num_envs, device="cuda", seed=1,
                    **({"control_type": cfg.env.control_type}
                       if name.startswith("Panda") else
                       {"random_init": cfg.env.random_init}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, _ = eval_rollout(eval_env, lambda obs: agent.eval_actor(
        ts, obs, generator=gen))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    L = env.max_episode_length
    log(phase, f"{name} stock DDiffPG at {TRAIN_ENVS} envs: warm-up "
        f"{warm_s:.2f} s, {MAZE_TRAIN_ITERS} train iterations "
        f"{s_iter:.4f} s each ({spi / s_iter:.0f} env steps/s), kernel "
        f"launches {launches}; replay {ts.replay.capacity} slots of {L} "
        f"steps; eval ({cfg.eval_num_envs} envs x {L} steps) {eval_s:.2f} s"
        f", return {metrics['eval/return']:.3g}; peak memory "
        f"{peak / 2**20:.0f} MiB [{smi}]")
    return {"env": name, "num_envs": TRAIN_ENVS, "episode_len": L,
            "warmup_s": warm_s, "s_per_train_iter": s_iter,
            "kernel_launches": launches, "eval_s": eval_s,
            "eval_envs": cfg.eval_num_envs, "peak_memory_bytes": peak,
            "card": smi}


def two_family_recluster(families, fail_len: int, D: int, noise: float,
                         smi: str, phase: str, what: str, **cm_kw):
    """A recluster on the card of synthetic successes of two families
    (families[g] = (corners, lengths), goal ids 1 and 2, `path_track`
    with point noise `noise` and a wander of 0.4 `noise` a step) and as
    many failures (random walks at the start): two modes, each family in
    one, and the DTW kernel launched on stacks of at most 512 points.
    Returns (the record, the kernel's launches)."""
    from ddiffpg_tpu_torch.modes.cluster import ClusterManager

    rng = np.random.RandomState(7)
    tracks, lengths, goal = [], [], []
    for g, (corners, lens) in enumerate(families):
        for n in lens:
            tracks.append(path_track(rng, int(n), corners, 0.4 * noise,
                                     noise))
            lengths.append(int(n))
            goal.append(g + 1)
    n_fail = len(tracks)
    for _ in range(n_fail):
        tr = np.cumsum(rng.randn(fail_len + 1, D) * 0.4 * noise, axis=0)
        tracks.append(tr + np.asarray(families[0][0][0]))
        lengths.append(fail_len)
        goal.append(0)
    Lmax = max(lengths)
    S = len(tracks)
    stack = np.zeros((S, Lmax + 1, D), np.float32)
    for k, tr in enumerate(tracks):
        stack[k, : len(tr)] = tr
    lengths, goal = np.asarray(lengths), np.asarray(goal, np.int32)
    kern = dtw_cuda.get_kernel("cuda")
    kern.launches = 0
    cm = ClusterManager(capacity=2000, device="cuda", traj_dim=D, **cm_kw)
    t0 = time.perf_counter()
    res = cm.recluster(np.arange(S), lengths, goal, stack)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    L_dtw = int(cm._tracks_dev[0].shape[1])
    m = res.group_mask
    fam = [np.flatnonzero(goal == g) for g in (1, 2)]
    g_of = [[g for g in range(1, res.num_groups) if bool(m[g][f].all())]
            for f in fam]
    ok = (res.num_groups == 3 and all(len(x) == 1 for x in g_of)
          and g_of[0] != g_of[1] and kern.launches > 0 and L_dtw <= 512)
    log(phase, f"{what}: {len(fam[0]) + len(fam[1])} successes of lengths "
        f"{min(lengths[goal > 0])}-{Lmax} (Dx {D}) and {n_fail} failures: "
        f"{res.num_groups - 1} modes, each family in one: "
        f"{'ok' if ok else 'FAIL'}; DTW on stacks of {L_dtw} points, "
        f"{cm.dtw_stats['pairs']} pairs in {kern.launches} kernel launches; "
        f"{secs:.3f} s [{smi}]")
    if not ok:
        raise RuntimeError(f"{what}: the recluster did not find the two "
                           "families")
    return {"successes": int((goal > 0).sum()), "max_len": Lmax,
            "dtw_len": L_dtw, "modes": res.num_groups - 1,
            "pairs": cm.dtw_stats["pairs"], "launches": kern.launches,
            "seconds": secs}, kern.launches


def mazes_phase(smi: str, maze_kernels: dict, cfg: Config):
    """11: each other maze's substep builds against the plain version
    (random and wall batches at 4096 and 20 envs), timed with their
    bounds; collects at 4096 envs; every goal probed; stock DDiffPG
    trained on antmaze-v3; a recluster of 700-step successes to v2's two
    goals. Returns (record, {maze: launches}, kernel entries, the DTW
    kernel's launches, antmaze-v3's collect split for `device_split`)."""
    rec, launches, entries = {}, {}, []
    for name in OTHER_MAZES:
        k10, k1 = maze_kernels[name]
        env0 = AntMazeEnv(name, device="cpu")
        init_qpos = np.asarray(env0.model.init_qpos)
        nobox = dataclasses.replace(k1.consts, nsb=0,
                                    box_min=k1.consts.box_min[:0],
                                    box_max=k1.consts.box_max[:0])
        err = 0.0
        for wall in (False, True):
            args = maze_wall_states(init_qpos, env0.maze_map, NUM_ENVS, 11) \
                if wall else ant_states(init_qpos, NUM_ENVS, 0, False)
            for nsub, kern in ((1, k1), (10, k10)):
                err = max(err, check_kernel(
                    kern, f"{name} {'wall' if wall else 'random'}", args,
                    TOL[nsub], "11 mazes"))
            if wall:
                free = substep_reference(nobox, *args)[1]
                dv = float((k1(*args)[1] - free).abs().max())
                log("11 mazes", f"{name} wall batch: max|dqvel| from the "
                    f"walls {dv:.3f}")
                if dv < 1e-2:
                    raise RuntimeError(f"{name}: wall batch made no contact")
        qp, qv, ct = ant_states(init_qpos, NUM_ENVS, 0, False)
        ms = cuda_ms(lambda: k10(qp, qv, ct), 50)
        plain_ms = cuda_ms(lambda: substep_reference(k10.consts, qp, qv, ct),
                           1)
        bound = substep_bound(k10.consts, qp, qv, ct)
        log("11 mazes", f"{name} ({k10.consts.nsb} walls) one control step "
            f"at B={NUM_ENVS}: kernel {ms:.4f} ms, plain PyTorch "
            f"{plain_ms:.2f} ms, bound {bound[0]:.5f} ms ({bound[1]}, "
            f"{bound[2]} flops per env per substep); {k10.shared_bytes} "
            f"shared bytes per block [{smi}]")
        rec[name] = {"walls": k10.consts.nsb, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "max_abs_err": err}
        entries.append((name, err, ms, plain_ms, bound))

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in OTHER_MAZES:
        n_steps = N_MAZE_STEPS.get(name, 16)
        env = make(name, num_envs=NUM_ENVS, random_init=True, device="cuda",
                   seed=0)
        actor = Actor(env, cfg, gen)
        state, obs, roll, secs, n, n_reset = timed_collect(
            actor, env, env.env.kernel, n_steps, name)
        launches[name] = n
        log("11 mazes", f"{name} collect {n_steps} steps x {NUM_ENVS} envs "
            f"({env.max_episode_length}-step episodes): {secs:.3f} s, "
            f"{NUM_ENVS * n_steps / secs:.0f} env steps/s, kernel launches "
            f"{n}, envs auto-reset {n_reset} [{smi}]")
        rec[name]["collect_env_steps_per_s"] = NUM_ENVS * n_steps / secs
        maze_goal_probe(env, name, "11 mazes")
        if name == "antmaze-v3":
            v3_split = host_split(actor, env, state, obs, {}, "11 mazes",
                                  smi)

    train = short_train("antmaze-v3", lambda e: e.env.kernel, smi,
                        "11 mazes")
    launches["antmaze-v3"] += train["kernel_launches"]
    rec["train_v3"] = train
    # v2's goals: (-8, 8) up the west corridor, (8, 0) east; 600-700 steps
    rng = np.random.RandomState(3)
    fam = [([[0, 0], [-8, 0], [-8, 8]], rng.randint(600, 701, 100)),
           ([[0, 0], [8, 0]], rng.randint(600, 701, 100))]
    rec["recluster_v2"], dtw_n = two_family_recluster(
        fam, 60, 2, 0.05, smi, "11 mazes", "antmaze-v2 recluster of 700-step "
        "successes", threshold=70.0)
    return rec, launches, entries, dtw_n, v3_split


def panda_ee_phase(smi: str, cfg: Config):
    """12: the ee control targets on the card against the CPU at 4096 envs;
    collects of PandaDrawerMulti-v3 and PandaReach-v3 (ee) at 4096 envs
    with the host split of a control step; stock DDiffPG on
    PandaReach-v3 with `env.control_type=ee`; a recluster of 3-D ee tracks
    with use_downsampling. Returns (record, launches, split, DTW
    launches); `launches` holds the substep's and, of the two collects,
    the ee state's (`drawer_ee`, `reach_ee`)."""
    rec = {}
    env = make("PandaDrawerMulti-v3", num_envs=NUM_ENVS, device="cuda",
               seed=0)
    drawer: PandaTaskEnv = env.env
    cpu = PandaTaskEnv("DrawerMulti", control_type="ee", device="cpu")
    qpos, _, _ = panda_states(drawer.model, drawer.meta, NUM_ENVS, 4)
    act = torch.rand((NUM_ENVS, 4), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4))
    act = act * 2.4 - 1.2
    got = drawer._ctrl_from_action(qpos, act)
    want = cpu._ctrl_from_action(qpos.cpu(), act.cpu())
    err = float((got.cpu() - want).abs().max())
    ok = err <= EE_CTRL_TOL and bool(torch.isfinite(got).all())
    log("12 panda ee", f"ee control targets at B={NUM_ENVS}, card vs CPU "
        f"from copies of one state: max|diff| {err:.3e} (bound "
        f"{EE_CTRL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ee control targets: card and CPU disagree")
    rec["ctrl_card_vs_cpu"] = err

    gen = torch.Generator(device="cuda").manual_seed(0)
    actor = Actor(env, cfg, gen)
    state, obs, roll, secs, drawer_n, n_reset = timed_collect(
        actor, env, drawer.kernel, N_STEPS, "PandaDrawerMulti-v3")
    drawer_ee = drawer.kernel.ee_launches
    drawer_ik = drawer.kernel.ik_launches
    log("12 panda ee", f"DrawerMulti (ee, 4-D actions) collect {N_STEPS} "
        f"steps x {NUM_ENVS} envs: {secs:.3f} s, "
        f"{NUM_ENVS * N_STEPS / secs:.0f} env steps/s, kernel launches "
        f"{drawer_n}, envs auto-reset {n_reset} [{smi}]")
    rec["drawer_collect_env_steps_per_s"] = NUM_ENVS * N_STEPS / secs
    zeros = torch.zeros((NUM_ENVS, 4), device="cuda")
    ctrl = drawer._ctrl_from_action(state.qpos, zeros)
    split = host_split(actor, env, state, obs, {
        "ctrl (IK)": lambda s=state: drawer._ctrl_from_action(s.qpos, zeros),
        "kernel": lambda s=state, c=ctrl: drawer.kernel(s.qpos, s.qvel, c),
        "ee state": lambda s=state: drawer._ee_state(s.qpos, s.qvel)},
        "12 panda ee", smi)
    rec["drawer_host_ms"] = split[1]

    reach = make("PandaReach-v3", num_envs=NUM_ENVS, device="cuda", seed=0)
    reach_actor = Actor(reach, cfg, gen)
    _, _, _, secs, reach_n, n_reset = timed_collect(
        reach_actor, reach, reach.env.kernel, N_REACH_STEPS, "PandaReach-v3")
    reach_ee = reach.env.kernel.ee_launches
    log("12 panda ee", f"Reach (ee, 3-D actions) collect {N_REACH_STEPS} "
        f"steps x {NUM_ENVS} envs: {secs:.3f} s, "
        f"{NUM_ENVS * N_REACH_STEPS / secs:.0f} env steps/s, kernel "
        f"launches {reach_n}, envs auto-reset {n_reset} [{smi}]")
    rec["reach_collect_env_steps_per_s"] = NUM_ENVS * N_REACH_STEPS / secs

    # warm-up cut from 500 to 100 random steps (one whole 100-step episode
    # per env): an ee control step spends ~55 ms of host in the IK
    train = short_train("PandaReach-v3", lambda e: e.env.kernel, smi,
                        "12 panda ee", **{"env.control_type": "ee",
                                          "algo.warm_up": 100})
    rec["train_reach_ee"] = train
    # 3-D ee tracks to two drawers (Panda's preset: use_downsampling)
    rng = np.random.RandomState(5)
    fam = [([[-0.1, 0.0, 0.6], [-0.25, -0.185, 0.48]],
            rng.randint(20, 100, 60)),
           ([[-0.1, 0.0, 0.6], [-0.25, 0.185, 0.68]],
            rng.randint(20, 100, 60))]
    rec["recluster_ee"], dtw_n = two_family_recluster(
        fam, 100, 3, 0.002, smi, "12 panda ee", "PandaDrawerMulti ee-track "
        "recluster (use_downsampling)", use_downsampling=True)
    launches = {"drawer": drawer_n, "reach": reach_n
                + train["kernel_launches"], "drawer_ee": drawer_ee,
                "reach_ee": reach_ee, "drawer_ik": drawer_ik}
    return rec, launches, split, dtw_n


def entry_point_run(name: str, smi: str, phase: str, *extra,
                    keep: Path | None = None):
    """`train.main` on `name` with the stock config (and `extra`
    overrides) at TRAIN_ENVS envs, cut to warm-up + 4 iterations with an
    eval every two: its metrics.jsonl must hold an eval/success_goal{g}
    key for each of the env's goals. The run's directory moves to `keep`
    when given. Returns the record."""
    from ddiffpg_tpu_torch import train

    cfg = stock_config(name)
    goals = len(maze.GOALS[name.replace("pointmaze", "antmaze")])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        train.main(["algo=ddiffpg", f"env.name={name}",
                    f"num_envs={TRAIN_ENVS}", "seed=0", "eval_freq=2",
                    f"max_step={(cfg.algo.warm_up + 4) * TRAIN_ENVS}",
                    f"logdir={tmp}", "run_name=smoke", *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        recs = [json.loads(x) for x in (Path(tmp) / "smoke" /
                                        "metrics.jsonl").read_text()
                .splitlines()]
        if keep is not None:
            shutil.move(str(Path(tmp) / "smoke"), str(keep))
    evals = [r for r in recs if "eval/return" in r]
    keys = sorted({k for r in evals for k in r
                   if k.startswith("eval/success_goal")})
    want = [f"eval/success_goal{g + 1}" for g in range(goals)]
    eval_s = [r["time/eval_s"] for r in evals]
    log(phase, f"train.main on {name}: {wall:.1f} s, {len(evals)} evals "
        f"({', '.join(f'{s:.2f}' for s in eval_s)} s), per-goal keys "
        f"{keys} [{smi}]")
    if len(evals) != 2 or keys != want:
        raise RuntimeError(f"{name}: evals {len(evals)}, per-goal keys "
                           f"{keys}, want {want}")
    return {"env": name, "wall_s": wall, "eval_s": eval_s,
            "goal_keys": keys}


def pointmaze_phase(smi: str, cfg: Config, keep_v2: Path):
    """13: a collect of pointmaze-v1 at 4096 envs (plain PyTorch, no
    kernel), then the entry point on antmaze-v2 (its run directory moved
    to `keep_v2`) and on pointmaze-v2. Returns (record, launches of the
    antmaze-v2 run's train and eval kernels, split)."""
    env = make("pointmaze-v1", num_envs=NUM_ENVS, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    actor = Actor(env, cfg, gen)
    state, obs = env.reset()
    t_start = torch.randint(0, env.max_episode_length, (NUM_ENVS,),
                            generator=gen, device="cuda", dtype=torch.int32)
    state, obs, _ = actor.collect(env, state._replace(t=t_start), obs, 1)
    t_before = state.t.clone()
    torch.cuda.synchronize()
    t0 = time.time()
    state, obs, roll = actor.collect(env, state, obs, N_STEPS)
    torch.cuda.synchronize()
    secs = time.time() - t0
    n_reset = check_collect(env, roll, state, t_before, N_STEPS,
                            "pointmaze-v1")
    log("13 pointmaze", f"pointmaze-v1 collect {N_STEPS} steps x {NUM_ENVS} "
        f"envs: {secs:.3f} s, {NUM_ENVS * N_STEPS / secs:.0f} env steps/s, "
        f"envs auto-reset {n_reset}, goals reached "
        f"{int((roll.success > 0).sum())} [{smi}]")
    split = host_split(actor, env, state, obs, {}, "13 pointmaze", smi)
    rec = {"pointmaze_collect_env_steps_per_s": NUM_ENVS * N_STEPS / secs}

    from ddiffpg_tpu_torch import train
    made, make_envs = [], train.make_envs

    def recording_make_envs(*a, **k):
        made.extend(make_envs(*a, **k))
        return made[-2:]

    train.make_envs = recording_make_envs
    try:
        rec["main_antmaze_v2"] = entry_point_run("antmaze-v2", smi,
                                                 "13 pointmaze", keep=keep_v2)
        # no preset names pointmaze-v2: its 7-row maze needs a density
        # grid resolution that 7 divides (the presets' 357), in both
        # packages (the stock 255 raises)
        rec["main_pointmaze_v2"] = entry_point_run(
            "pointmaze-v2", smi, "13 pointmaze", "env.resolution=357")
    finally:
        train.make_envs = make_envs
    v2_launches = made[0].env.kernel.launches + made[1].env.kernel.launches
    return rec, v2_launches, split


# ------------------------------------------------------ 14. the baselines

BASELINES = ("td3", "sac", "dipo", "diffq")
BASELINE_ITERS = 5       # timed train iterations, after 2 untimed
BASELINE_MAIN_ITERS = 4  # train.main's iterations (an eval every two)
# tests/test_agents.py:157-176's TD3 on pointmaze-v1 with dense rewards
TD3_DENSE = {"num_envs": 32, "eval_num_envs": 4, "env.name": "pointmaze-v1",
             "env.resolution": 255, "algo.batch_size": 128,
             "algo.warm_up": 100, "algo.update_times": 4,
             "algo.tracker_len": 16, "algo.memory_size": 2000,
             "algo.num_atoms": 11, "algo.horizon_len": 4,
             "algo.v_min": -10.0, "algo.v_max": 10.0, "intrinsic.L": 4,
             "seed": 0}
TD3_DENSE_ITERS = 120


def baseline_config(algo: str) -> Config:
    """The stock preset of `algo` on antmaze-v1 (256 envs, 1M replay rows,
    batch 4096, 8 update passes), seed 0."""
    cfg = Config(algo=algo_preset(algo)).override(**{"env.name":
                                                     "antmaze-v1"})
    return preprocess(cfg, if_ddiffpg=False).override(seed=0)


def baseline_tensors(ts) -> dict:
    """The parameters a pass moves, by part (SAC's log_alpha with the
    actor)."""
    params = lambda m: [p.detach() for p in m.parameters()]  # noqa: E731
    actor = params(ts.actor) + params(ts.actor_target)
    if hasattr(ts, "log_alpha"):
        actor.append(ts.log_alpha)
    return {"critic rows (max)": params(ts.critic),
            "critic targets (max)": params(ts.critic_target),
            "actor (max)": actor}


def baseline_train(algo: str, smi: str):
    """Stock `algo` on antmaze-v1 on the card: warm-up, 2 + BASELINE_ITERS
    train iterations (the kernel's launches counted, one an env step), DIPO
    its host split by part, then one update pass on the card against the
    CPU from copies of one state with the same draws (bounds
    CARD_CPU_TOL). Returns (record, launches, agent and state for the
    profiler window)."""
    cfg = baseline_config(algo)
    if cfg.num_envs != BASELINE_ENVS:
        raise RuntimeError(f"{algo}: {cfg.num_envs} envs, but the kernel "
                           f"was checked at {BASELINE_ENVS}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the earlier agents' states
    env = make("antmaze-v1", num_envs=cfg.num_envs, random_init=True,
               device="cuda", seed=0)
    agent = make_agent(cfg.algo.name, env, cfg)
    ant: AntMazeEnv = env.env
    t0 = time.time()
    ts = agent.warmup(agent.init())
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    for _ in range(2):
        ts, logs = agent.train_iter(ts)
    torch.cuda.synchronize()
    ant.kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(BASELINE_ITERS):
        ts, logs = agent.train_iter(ts)
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / BASELINE_ITERS
    launches = ant.kernel.launches
    if launches != cfg.algo.horizon_len * BASELINE_ITERS:
        raise RuntimeError(f"{algo}: the kernel launched {launches} times in "
                           f"{BASELINE_ITERS} iterations")
    check_logs(logs, algo)
    peak = torch.cuda.max_memory_allocated() - held
    log("14 baselines", f"{algo}: warm-up ({cfg.algo.warm_up} x "
        f"{cfg.num_envs} envs) {warm_s:.2f} s, replay {int(ts.replay.size)}"
        f" of {ts.replay.capacity} rows; {BASELINE_ITERS} train iterations "
        f"(horizon {cfg.algo.horizon_len}, {cfg.algo.update_times} passes "
        f"of {cfg.algo.batch_size}): {s_iter:.4f} s per iteration, kernel "
        f"launches {launches}, peak memory (its own) {peak / 2**20:.0f} MiB "
        f"[{smi}]")
    log("14 baselines", f"{algo} logs: " + ", ".join(
        f"{k} {float(v):.4g}" for k, v in logs.items()))
    rec = {"warmup_s": warm_s, "s_per_train_iter": s_iter,
           "env_steps_per_s": cfg.num_envs * cfg.algo.horizon_len / s_iter,
           "kernel_launches": launches, "peak_memory_bytes": peak}

    state = [ts]
    if algo == "dipo":
        def env_step():
            state[0] = agent._env_step(state[0], random=False)

        def update_passes():
            for _ in range(cfg.algo.update_times):
                state[0], _ = agent.update_once(state[0])

        def train_iter():
            state[0], _ = agent.train_iter(state[0])

        host = host_ms({"train iteration": train_iter, "env step": env_step,
                        f"{cfg.algo.update_times} update passes":
                        update_passes}, SPLIT_REPS)
        parts = pass_parts(agent, state)
        log("14 baselines", f"dipo host ms (median of {SPLIT_REPS}, each "
            "call between synchronizes): " + ", ".join(
                f"{k} {v:.2f}" for k, v in host.items())
            + "; one update pass by part: " + ", ".join(
                f"{k} {v:.2f}" for k, v in parts.items()) + f" [{smi}]")
        rec["host_ms"], rec["update_pass_ms"] = host, parts

    ts, rec["card_vs_cpu"] = baseline_card_vs_cpu(agent, state[0], algo)
    return rec, launches, (agent, ts)


def baseline_card_vs_cpu(agent, ts, algo: str):
    """One update pass of a baseline on the card and on the CPU from
    copies of one state with the same draws; the largest differences,
    each against its bound in CARD_CPU_TOL. Returns (card state,
    differences)."""
    cfg = agent.cfg
    cpu_env = make(cfg.env.name, num_envs=cfg.num_envs, random_init=True,
                   device="cpu")
    cpu_agent = make_agent(cfg.algo.name, cpu_env, cfg, device="cpu")
    draws = agent.draw_update(ts)
    cpu_ts = ts.to("cpu")
    table = ts.replay.target_action.clone()
    ts, logs = agent.update_once(ts, draws)
    t0 = time.time()
    cpu_ts, cpu_logs = cpu_agent.update_once(cpu_ts, to_device(draws, "cpu"))
    cpu_s = time.time() - t0

    def diff(xs, ys):
        return max(float((x.cpu() - y).abs().max()) for x, y in zip(xs, ys))

    got = {k: diff(v, baseline_tensors(cpu_ts)[k])
           for k, v in baseline_tensors(ts).items()}
    got["logs (max relative)"] = max(
        abs(float(logs[k]) - float(cpu_logs[k]))
        / max(abs(float(cpu_logs[k])), 1e-6) for k in logs)
    if algo in ("dipo", "diffq"):
        card_t = ts.replay.target_action
        cpu_t = cpu_ts.replay.target_action
        got["target actions (max)"] = diff([card_t], [cpu_t])
        got["target actions (mean over the moved)"] = float(
            (card_t - cpu_t.to(card_t.device)).abs()[card_t != table].mean())
    for k, v in got.items():
        ok = v <= CARD_CPU_TOL[k]
        log("14 baselines", f"{algo} card vs CPU, one update pass: {k} "
            f"|diff| {v:.3e} (bound {CARD_CPU_TOL[k]:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{algo}: card and CPU disagree on {k}")
    log("14 baselines", f"{algo}: the CPU's update pass took {cpu_s:.1f} s")
    return ts, got


def baseline_main(algo: str, smi: str):
    """`train.main` for `algo` with the stock preset on antmaze-v1 (256
    envs): warm-up, BASELINE_MAIN_ITERS iterations with an eval every two,
    a light checkpoint at the second eval, the final full one, which must
    reload bit for bit; the light one holds no replay row. Checks the
    substep kernel's launches (once an env step of the train env and of
    the eval env). Returns (record, launches)."""
    import tempfile

    from ddiffpg_tpu_torch import train
    from ddiffpg_tpu_torch.utils import checkpoint as ckpt

    cfg = baseline_config(algo)
    warm, iters = cfg.algo.warm_up, BASELINE_MAIN_ITERS
    made, make_envs = [], train.make_envs

    def recording_make_envs(*a, **k):
        made.extend(make_envs(*a, **k))
        return made[-2:]

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the earlier agents' states
    with tempfile.TemporaryDirectory() as tmp:
        train.make_envs = recording_make_envs
        try:
            t0 = time.time()
            ts = train.main([
                f"algo={algo}", "env.name=antmaze-v1", "seed=0",
                "eval_freq=2", "ckpt_freq_mult=1",
                f"max_step={(warm + iters) * cfg.num_envs}",
                f"logdir={tmp}", "run_name=smoke"])
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            train.make_envs = make_envs
        peak = torch.cuda.max_memory_allocated() - held
        train_env, eval_env = made[:2]
        launches = {"train": train_env.env.kernel.launches,
                    "eval": eval_env.env.kernel.launches}
        want = {"train": warm + cfg.algo.horizon_len * iters,
                "eval": 2 * eval_env.max_episode_length}
        run = Path(tmp) / "smoke"
        recs = [json.loads(x) for x in
                (run / "metrics.jsonl").read_text().splitlines()]
        times = {}
        for r in recs:
            for k, v in r.items():
                if k.startswith("time/"):
                    times.setdefault(k[5:], []).append(v)
        names = sorted(p.name for p in run.glob("ckpt_*.pt"))
        evals = sum("eval/return" in r for r in recs)
        log("14 baselines", f"{algo} train.main: {wall:.1f} s; substep "
            f"launches {launches} (want {want}); {evals} evals; checkpoints "
            f"{names}; " + ", ".join(f"{k} {v}" for k, v in
                                     sorted(times.items()))
            + f"; peak memory (its own) {peak / 2**20:.0f} MiB [{smi}]")
        if launches != want:
            raise RuntimeError(f"{algo}: the loop's env steps did not each "
                               "launch the kernel once")
        if evals != 2 or len(names) != 2:
            raise RuntimeError(f"{algo}: {evals} evals, checkpoints {names}")
        light = torch.load(run / names[0], weights_only=False)
        if any(".replay." in f".{k}" for k in light["tensors"]):
            raise RuntimeError(f"{algo}: the light checkpoint holds replay "
                               "rows")
        env, _ = train.make_envs(cfg, torch.device("cuda"))
        fresh = make_agent(cfg.algo.name, env, cfg).init()
        fresh, _ = ckpt.load(run / "ckpt_final.pt", fresh)
        got, want_t = dict(ckpt.leaves(fresh)), dict(ckpt.leaves(ts))
        bad = [k for k in want_t if not torch.equal(got[k], want_t[k])]
        log("14 baselines", f"{algo}: final checkpoint reloaded into a "
            f"fresh state: {len(want_t)} tensors, {len(bad)} differ")
        if bad or set(got) != set(want_t):
            raise RuntimeError(f"{algo}: the reload differs: {bad[:5]}")
    return {"wall_s": wall, "times": times, "checkpoints": names,
            "substep_launches": launches,
            "peak_memory_bytes": peak}, sum(launches.values())


def td3_dense(smi: str) -> dict:
    """TD3 on pointmaze-v1 with dense rewards at the JAX test's config:
    the train return's early and late means. The gate is finiteness only
    (the two packages' seeds differ)."""
    cfg = Config(algo=algo_preset("td3")).override(**TD3_DENSE)
    env = make("pointmaze-v1", num_envs=cfg.num_envs, reward_type="dense",
               device="cuda", seed=0)
    agent = make_agent("TD3", env, cfg)
    t0 = time.time()
    ts = agent.warmup(agent.init())
    rets = []
    for _ in range(TD3_DENSE_ITERS):
        ts, logs = agent.train_iter(ts)
        rets.append(logs["train/return"])
    rets = torch.stack(rets).tolist()
    secs = time.time() - t0
    early, late = float(np.mean(rets[10:30])), float(np.mean(rets[-20:]))
    log("14 baselines", f"TD3 pointmaze-v1 dense ({TD3_DENSE_ITERS} "
        f"iterations, {secs:.1f} s): train return early (iterations 10-30) "
        f"{early:.3f}, late (last 20) {late:.3f} [{smi}]")
    if not (np.isfinite(early) and np.isfinite(late)):
        raise RuntimeError("TD3 dense: non-finite returns")
    return {"early_return": early, "late_return": late, "seconds": secs}


def baselines_phase(smi: str):
    """14: each baseline's timed iterations and card-vs-CPU pass
    (`baseline_train`), its `train.main` run (`baseline_main`), then TD3
    dense on pointmaze-v1. Returns (record, substep launches of the
    baselines' main paths, the agents and states for
    `baselines_profile`)."""
    rec, launches, held = {}, 0, {}
    for algo in BASELINES:
        r, n, held[algo] = baseline_train(algo, smi)
        r["main"], n_main = baseline_main(algo, smi)
        rec[algo] = r
        launches += n + n_main
    rec["td3_pointmaze_dense"] = td3_dense(smi)
    return rec, launches, held


def baselines_profile(rec: dict, held: dict, smi: str):
    """Each baseline's train iteration on the device from a profiler
    window of 2, after every timed phase: busy ms and the idle share of
    its timed seconds per iteration."""
    for algo, (agent, ts) in held.items():
        state = [ts]

        def train_iter():
            state[0], _ = agent.train_iter(state[0])

        dev = device_ms(train_iter, 2)
        if dev is None:
            log("14 baselines", f"{algo} train iteration on the device: not "
                "measured (the profiler saw no device activity)")
            rec[algo]["device_busy_ms_per_iter"] = None
            rec[algo]["device_idle_share"] = None
            continue
        idle = 1 - dev[0] / (rec[algo]["s_per_train_iter"] * 1e3)
        log("14 baselines", f"{algo} train iteration on the device "
            f"(torch.profiler, 2 iterations): {dev[2]:.0f} device "
            f"activities, busy {dev[0]:.2f} ms, of which substep_kernel "
            f"{dev[1]:.3f} ms; idle {idle:.1%} of the timed iteration "
            f"[{smi}]")
        rec[algo]["device_busy_ms_per_iter"] = dev[0]
        rec[algo]["device_idle_share"] = idle
        rec[algo]["device_activities_per_iter"] = dev[2]


# ------------------------------------------------------------ 15. the tools
def zoo_card_vs_cpu(device="cuda") -> dict:
    """The rest of the model zoo (and `ema_update`) on the card against the
    CPU, from one set of weights drawn from a seed and the same inputs and
    draws at the train batch: each output's largest difference relative to
    the larger of 1 and its largest magnitude, which must stay within
    ZOO_TOL."""
    from ddiffpg_tpu_torch.models import baseline_diffusion as bd
    from ddiffpg_tpu_torch.models import diffusion as dm
    from ddiffpg_tpu_torch.models import mlp
    from ddiffpg_tpu_torch.utils.ema import ema_update

    B, D, A, K, NA = TRAIN_ENVS, 29, 8, 5, 8
    M = min(64, B)          # the EBM's logprob and entropy rows
    g = torch.Generator().manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    x = {"obs": randn(B, D), "act": torch.rand((B, A), generator=g) * 2 - 1,
         "t": torch.randint(0, K, (B,), generator=g).float(),
         "noise": randn(B, A), "buf": randn(64, A).clamp(-1, 1),
         "logz": randn(M), "x_init": randn(M * NA, A),
         "steps": randn(K, M * NA, A),
         "idx": torch.randint(1, K + 1, (B,), generator=g)}
    ebm = dm.EBMDiffusionPolicy(A, D, K, device="cpu", generator=g)
    cases = {
        "DiagGaussianMLPPolicy": (
            mlp.DiagGaussianMLPPolicy(D, A, generator=g),
            lambda m, i: m.sample(*m(i["obs"]), noise=i["noise"])),
        "DistributionalEnsembleQ": (
            mlp.DistributionalEnsembleQ(D, A, generator=g),
            lambda m, i: torch.cat([m(i["obs"], i["act"]).flatten(),
                                    m.q_mean(i["obs"], i["act"])])),
        "MLPCritic": (mlp.MLPCritic(D, generator=g),
                      lambda m, i: m(i["obs"])),
        "DynamicModel": (
            mlp.DynamicModel(D, A, generator=g),
            lambda m, i: torch.cat([
                m(i["obs"], i["act"]).flatten(),
                m.disagreement_reward(i["obs"], i["act"])])),
        "MLPResNet": (dm.MLPResNet(D, A, generator=g),
                      lambda m, i: m(i["obs"])),
        "EBMDiffusionPolicy.score": (
            ebm, lambda m, i: m(i["act"], i["t"], i["obs"]).detach()),
        "EBMDiffusionPolicy.logprob": (
            ebm, lambda m, i: m.logprob(i["act"][:M], i["t"][:M],
                                        i["obs"][:M], i["buf"])),
        "EBMDiffusionPolicy.entropy": (
            ebm, lambda m, i: m.entropy(i["obs"][:M], i["logz"], NA,
                                        x_init=i["x_init"],
                                        noise=i["steps"])),
        "Consistency": (
            bd.Consistency(A, D, K, device="cpu", generator=g),
            lambda m, i: torch.cat([
                m.sample(i["obs"], noise=i["noise"]).flatten(),
                m.loss(i["obs"], i["act"], idx=i["idx"],
                       noise=i["noise"]).reshape(1)])),
        "ema_update": (
            mlp.MLPCritic(D, generator=g),
            lambda m, i: torch.cat([
                p.flatten() for p in ema_update(
                    list(m.parameters()),
                    [p + 1.0 for p in m.parameters()], 0.9)])),
    }
    card = {k: v.to(device) for k, v in x.items()}
    errs = {}
    for name, (module, fn) in cases.items():
        want = fn(copy.deepcopy(module), x).detach()
        got = fn(copy.deepcopy(module).to(device), card).detach().cpu()
        errs[name] = float((got - want).abs().max()
                           / max(1.0, float(want.abs().max())))
        log("15 tools", f"{name} card vs CPU ({tuple(want.shape)} values): "
            f"{errs[name]:.2e} relative (bound {ZOO_TOL:g})")
        if not errs[name] <= ZOO_TOL:
            raise RuntimeError(f"{name}: the card differs from the CPU by "
                               f"{errs[name]:.3g}")
    return errs


def tools_phase(smi: str, runs: dict, scratch: Path):
    """15: each checkpoint tool on the card at its own defaults (num_envs
    is the runs' own) on the final checkpoints of phase 10c's antmaze-v1
    run (eval_ckpt, eval_goals, eval_modes) and phase 13's antmaze-v2 run
    (eval_goals for its two per-goal rates, and trace_goals and
    probe_qfield, whose default env it is), probe_energy, run_status and
    archive_run on both runs (its REPO pointed at `scratch`, so nothing
    is written into the checkout), trace_launch on antmaze-v1's; the stock
    agent's weights bundle round-tripped bit for bit; the zoo on the card
    against the CPU. The tools roll out on `engine_cl` (`use_pallas=False`,
    as the JAX tools): its control steps are counted, and the substep
    kernels the tools build count their launches from 0 (none expected).
    Returns (record, antmaze-v1 launches, antmaze-v2 launches)."""
    import contextlib
    import importlib.util
    import io

    from ddiffpg_tpu_torch.tools import (archive_run, common, eval_ckpt,
                                         eval_goals, eval_modes,
                                         probe_energy, probe_qfield,
                                         run_status, trace_goals,
                                         trace_launch)
    from ddiffpg_tpu_torch.utils import checkpoint as ckpt

    made, init = [], SubstepKernel.__init__
    cl_steps, graphed = [0], Engine.graphed_step

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def counting_step(self, *a):
        cl_steps[0] += 1
        return graphed(self, *a)

    launches = {"antmaze-v1": 0, "antmaze-v2": 0}
    rec = {}

    def run(label, env, fn, *args):
        made.clear()
        cl_steps[0] = 0
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = fn(list(args))
        torch.cuda.synchronize()
        secs = time.time() - t0
        n = sum(k.launches for k in made)
        launches[env] += n
        for line in out.getvalue().splitlines():
            log("15 tools", f"{label}: {line}")
        log("15 tools", f"{label}: {secs:.1f} s, {cl_steps[0]} engine_cl "
            f"control steps, {n} substep launches [{smi}]")
        rec[label] = {"s": secs, "engine_cl_steps": cl_steps[0],
                      "substep_launches": n, "out": result}

    v1 = str(runs["antmaze-v1"] / "ckpt_final.pt")
    v2 = str(runs["antmaze-v2"] / "ckpt_final.pt")
    n_envs = f"num_envs={TRAIN_ENVS}"
    SubstepKernel.__init__ = recording_init
    Engine.graphed_step = counting_step
    try:
        run("eval_ckpt v1", "antmaze-v1", eval_ckpt.main, v1, n_envs)
        run("eval_goals v1", "antmaze-v1", eval_goals.main, v1,
            "env=antmaze-v1", n_envs)
        run("eval_modes v1", "antmaze-v1", eval_modes.main, v1, n_envs)
        run("probe_energy", "antmaze-v1", probe_energy.main)
        run("eval_goals v2", "antmaze-v2", eval_goals.main, v2,
            "env=antmaze-v2", n_envs)
        run("trace_goals v2", "antmaze-v2", trace_goals.main, v2, n_envs)
        run("probe_qfield v2", "antmaze-v2", probe_qfield.main, v2, n_envs)
        run("trace_launch v1", "antmaze-v1", trace_launch.main, v1, n_envs)
    finally:
        SubstepKernel.__init__ = init
        Engine.graphed_step = graphed
    goal_keys = sorted(k for k in rec["eval_goals v2"]["out"]
                       if k.startswith("eval/success_goal"))
    log("15 tools", f"eval_goals v2 per-goal rates "
        f"{ {k: rec['eval_goals v2']['out'][k] for k in goal_keys} }")
    if goal_keys != ["eval/success_goal1", "eval/success_goal2"]:
        raise RuntimeError(f"eval_goals on antmaze-v2: keys {goal_keys}")
    subs = rec["trace_launch v1"]["out"]["substeps"]
    if len(subs) != 10 or not all(np.isfinite(v) for d in subs
                                  for v in d.values()):
        raise RuntimeError(f"trace_launch: substeps {subs}")
    rollouts = [k for k in rec if k != "probe_qfield v2"]
    if any(rec[k]["substep_launches"] for k in rec) or \
            any(rec[k]["engine_cl_steps"] == 0 for k in rollouts):
        raise RuntimeError("a tool's rollout did not step engine_cl alone")

    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for d in runs.values():
            run_status.status(d)
    lines = out.getvalue().splitlines()
    for line in lines:
        log("15 tools", f"run_status: {line}")
    rec["run_status"] = {"s": time.time() - t0, "lines": lines}
    t0 = time.time()
    repo, archive_run.REPO = archive_run.REPO, scratch
    try:
        dst = [archive_run.archive(d) for d in runs.values()]
    finally:
        archive_run.REPO = repo
    files = {d.name: sorted(p.name for p in d.iterdir()) for d in dst}
    log("15 tools", f"archive_run into {scratch}: {files}")
    if any(not d.is_relative_to(scratch) for d in dst) or \
            any("metrics.jsonl.gz" not in f for f in files.values()):
        raise RuntimeError(f"archive_run wrote {dst}")
    rec["archive_run"] = {"s": time.time() - t0, "files": files}

    # the stock agent's weights bundle, bit for bit
    with contextlib.redirect_stdout(io.StringIO()):
        _, agent, ts, meta = common.load(v1, {
            "env": "antmaze-v1", "device": "auto", "num_envs": TRAIN_ENVS})
    G = int(meta["num_groups"])
    path = scratch / "model.pt"
    torch.cuda.synchronize()
    t0 = time.time()
    nbytes = ckpt.save_model(path, ts.actor, ckpt.critic_rows(ts.critics, G),
                             rms=ts.obs_rms, embeddings=ts.embeddings,
                             coverage=ts.density_grid)
    save_s = time.time() - t0
    t0 = time.time()
    blob = ckpt.load_model(path)
    load_s = time.time() - t0
    want = {f"actor.{k}": v for k, v in ts.actor.state_dict().items()}
    want |= {f"critics.{g}.{k}": v for g, row in enumerate(
        ckpt.critic_rows(ts.critics, G)) for k, v in row.items()}
    want |= {"embeddings": ts.embeddings, "coverage": ts.density_grid}
    got = {f"actor.{k}": v for k, v in blob["actor"].items()}
    got |= {f"critics.{g}.{k}": v for g, row in enumerate(blob["critics"])
            for k, v in row.items()}
    got |= {"embeddings": blob["embeddings"], "coverage": blob["coverage"]}
    bad = [k for k in want if k not in got
           or not torch.equal(got[k], want[k].cpu())]
    log("15 tools", f"weights bundle of the stock agent ({G} groups): "
        f"{nbytes} bytes, saved in {save_s:.3f} s, loaded in {load_s:.3f} "
        f"s, {len(want)} tensors, {len(bad)} differ [{smi}]")
    if bad or set(got) != set(want):
        raise RuntimeError(f"the bundle's round trip differs: {bad[:5]}")
    rec["bundle"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                     "tensors": len(want)}
    rec["zoo_card_vs_cpu"] = zoo_card_vs_cpu()
    if importlib.util.find_spec("matplotlib") is None:
        rec["plots"] = "skipped: matplotlib is not installed"
    else:
        rec["plots"] = {name: sorted(p.name for p in d.glob("*.png"))
                        for name, d in runs.items()}
    log("15 tools", f"maze plots of the kept runs: {rec['plots']}")
    return rec, launches["antmaze-v1"], launches["antmaze-v2"]


# ------------------------------------------------------- 16. engine_cl

CL_STEPS = 8             # control steps of engine_cl's collects
CL_SMALL = 40            # the tools' eval batch


def stage_errors(card: Engine, cpu: Engine, qpos, qvel, ctrl) -> dict:
    """{stage: (max |card - CPU|, max |card|)} of one `Engine.substep` on
    these card tensors, each stage fed the card's own inputs on both sides
    (copied to the CPU), so that a stage's error is its own and not what
    it inherits; `substep` is the whole substep, its integration last."""
    err = {}

    def cmp(stage, got, fn, *args):
        want = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        err[stage] = (max(float((a.cpu() - b).abs().max())
                          for a, b in zip(got, want)),
                      max(float(a.abs().max()) for a in got))

    bp, bq = card.fk(qpos)
    cmp("fk", (bp, bq), cpu.fk, qpos)
    p0 = bp.sum(1) * card.inv_nb
    br = bp - p0[:, None]
    S = card.kin.dof_subspaces(br, bq)
    cmp("dof_subspaces", S, cpu.kin.dof_subspaces, br, bq)
    u = card.kin.qvel_to_u(qvel, br)
    V = card.body_velocities(S, u)
    cmp("body_velocities", V, cpu.body_velocities, S, u)
    I6 = card.spatial_inertia(br, bq)
    cmp("spatial_inertia", I6, cpu.spatial_inertia, br, bq)
    if card.sdf:
        pts = card.probe_points(bp, bq)
        cmp("_sdf_walls", card._sdf_walls(pts), cpu._sdf_walls, pts)
    f_ext = card.contact_forces(bp, bq, V, p0)
    cmp("contact_forces", f_ext, cpu.contact_forces, bp, bq, V, p0)
    grav = card.gravity_torques(I6, S) if card.has_servo else None
    if grav is not None:
        cmp("gravity_torques", grav, cpu.gravity_torques, I6, S)
    act = card.actuator_torques(ctrl, qpos, u, grav)
    cmp("actuator_torques", act, cpu.actuator_torques, ctrl, qpos, u, grav)
    bias = card.bias_forces(I6, S, V, u, f_ext)
    cmp("bias_forces", bias, cpu.bias_forces, I6, S, V, u, f_ext)
    M = card.crba(I6, S)
    cmp("crba", M, cpu.crba, I6, S)
    tau = act + card.passive_torques(qpos, u) - bias
    cmp("chol_solve", chol_solve(M, tau), chol_solve, M, tau)
    cmp("substep", card.substep(qpos, qvel, ctrl), cpu.substep, qpos, qvel,
        ctrl)
    return err


def substep_walk(card: Engine, cpu: Engine, args, n: int, tol, what: str):
    """The card's trajectory from `args` (qpos, qvel, ctrl on the card)
    walked one substep at a time over `n` substeps: each substep stepped
    on the card from the card's state and on the CPU from the same state
    copied there, the two held to the one-substep bounds `tol`; the walk
    carries on from the card's result. Beside it the CPU's own trajectory
    from the same start, whose distance to the card's is the accumulated
    error. On the first substep out of bound, logs `stage_errors` on its
    state and raises. Returns (the curve, the card's end state, the CPU's
    seconds)."""
    qp, qv, ct = args
    ct_cpu = ct.cpu()
    own = (qp.cpu(), qv.cpu())
    curve, cpu_s = [], 0.0
    for k in range(1, n + 1):
        nxt = card.step(qp, qv, ct)
        here = (qp.cpu(), qv.cpu())
        t0 = time.time()
        ref = cpu.step(*here, ct_cpu)
        own = cpu.step(*own, ct_cpu)
        cpu_s += time.time() - t0
        one = [float((a.cpu() - b).abs().max()) for a, b in zip(nxt, ref)]
        acc = [float((a.cpu() - b).abs().max()) for a, b in zip(nxt, own)]
        curve.append({"substep": k, "one": one, "accumulated": acc})
        log("16 engine_cl", f"{what} substep {k}/{n}: one substep card vs "
            f"CPU max|dqpos| {one[0]:.3g}, max|dqvel| {one[1]:.3g} (bounds "
            f"{tol[0]:g}, {tol[1]:g}); accumulated {acc[0]:.3g}, "
            f"{acc[1]:.3g}")
        if one[0] > tol[0] or one[1] > tol[1]:
            for stage, (e, mag) in stage_errors(card, cpu, qp, qv,
                                                ct).items():
                log("16 engine_cl", f"{what} substep {k}: stage {stage} "
                    f"max|card - CPU| {e:.3g} (max|card| {mag:.3g})")
            raise RuntimeError(f"engine_cl {what}: substep {k} of the walk "
                               f"is out of the one-substep bounds: {one}")
        qp, qv = nxt
    return curve, (qp, qv), cpu_s


def kernel_count(fn) -> int:
    """CUDA kernels one call of fn() launches (a torch.profiler window)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def engine_cl_phase(smi: str, kernel_ms: dict) -> dict:
    """16: `physics/engine_cl.py` on the card through `make(...,
    use_pallas=False)`: antmaze-v1 (the SDF walls) and
    PandaDrawerMultiJoints-v3 collected at 4096 envs; then one control
    step from the collect's last state and from the kernel's check
    states (the ant's random and wall batches, Panda's random one) eager,
    eager again and through its CUDA graph, all bitwise alike, against
    the same step on the CPU, walked a substep at a time
    (`substep_walk`: every substep held to the kernel's one-substep bounds
    from the card's own state, the walk's end bitwise the control step),
    the ant's check states also held to its control-step bounds, the
    other batches' control-step error reported; SDF contacts seen
    on the wall states; ms and kernels a control step, eager and graphed,
    at 40 and 4096 envs beside the substep kernel's ms (`kernel_ms`)."""
    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    for name, tol, k_ms in (
            ("antmaze-v1", TOL[10], kernel_ms["antmaze-v1"]),
            ("PandaDrawerMultiJoints-v3", PANDA_TOL[20],
             kernel_ms["DrawerMulti"])):
        kw = {"random_init": True} if name.startswith("antmaze") else {}
        env = make(name, num_envs=NUM_ENVS, device="cuda", seed=0,
                   use_pallas=False, **kw)
        inner, eng = env.env, env.env.engine
        if inner.kernel is not None or eng is None:
            raise RuntimeError(f"{name}: use_pallas=False built a kernel")
        actor = Actor(env, cfg, gen)
        state, obs = env.reset()
        torch.cuda.synchronize()
        t0 = time.time()
        state, obs, roll = actor.collect(env, state, obs, CL_STEPS)
        torch.cuda.synchronize()
        secs = time.time() - t0
        if not bool(torch.isfinite(roll.obs).all()):
            raise RuntimeError(f"{name}: non-finite obs from engine_cl")
        action = actor.act(obs)
        ctrl = action if name.startswith("antmaze") else \
            inner._ctrl_from_action(state.qpos, action)
        # from every batch the card's control step is walked one substep
        # at a time (`substep_walk`), each substep held to the one-substep
        # bounds against the CPU from the same state; the ant's check
        # states (phases 3, 11) are also held to the control-step bounds.
        # The collect's last state and Panda's control step are reported
        # there: the CPU rounds sin and cos and orders its sums otherwise
        # than the card, and a chaotic contact or the kp = 2e4 servos
        # amplify in-bound substeps past the control-step bounds
        batches = [("collected", (state.qpos, state.qvel,
                                  ctrl.contiguous()), False)]
        if name.startswith("antmaze"):
            init = np.asarray(inner.model.init_qpos)
            batches += [("random", ant_states(init, NUM_ENVS, 0, False),
                         True),
                        ("walls", maze_wall_states(
                            init, maze.MAZES[name], NUM_ENVS, 5), True)]
        else:
            batches.append(("random", panda_states(
                inner.model, inner.meta, NUM_ENVS, 1), True))
        cpu = Engine(inner.model, "cpu")
        one = dataclasses.replace(inner.model, n_substeps=1)
        one_card, one_cpu = Engine(one, "cuda"), Engine(one, "cpu")
        tol1 = TOL[1] if name.startswith("antmaze") else PANDA_TOL[1]
        n_sub = int(inner.model.n_substeps)
        gate_step = name.startswith("antmaze")
        r = {"collect_s": secs, "env_steps_per_s": NUM_ENVS * CL_STEPS / secs}
        for label, args, gated in batches:
            curve, end, cpu_s = substep_walk(one_card, one_cpu, args, n_sub,
                                             tol1, f"{name} {label} "
                                             f"B={NUM_ENVS}")
            e1, e2 = eng.step(*args), eng.step(*args)
            # the walk is the control step: the same substeps in turn
            same = all(torch.equal(a, b) for a, b in zip(end, e1))
            r[f"{label}_walk"] = {"envs": NUM_ENVS, "substeps": n_sub,
                                  "bounds": list(tol1), "curve": curve,
                                  "cpu_s": cpu_s, "is_the_step": same}
            log("16 engine_cl", f"{name} {label}: walk of {n_sub} substeps "
                f"over all {NUM_ENVS} envs in bound (CPU {cpu_s:.1f} s); "
                f"its end bitwise the control step: {same}")
            if not same:
                raise RuntimeError(f"engine_cl {name} {label}: the walk is "
                                   "not the control step")
            g = eng.graphed_step(*args)
            bitwise = all(torch.equal(a, b) for a, b in zip(e1, e2))
            graph_bitwise = all(torch.equal(a, b) for a, b in zip(e1, g))
            ref = cpu.step(*(t.cpu() for t in args))
            d = [(a.cpu() - b).abs().amax(-1) for a, b in zip(e1, ref)]
            err = [float(x.max()) for x in d]
            over = [int((x > t).sum()) for x, t in zip(d, tol)]
            r[label] = {"max_abs_err": err, "envs_over": over,
                        "p99_9": [float(x.quantile(0.999)) for x in d],
                        "bitwise_repeat": bitwise,
                        "graph_bitwise": graph_bitwise}
            log("16 engine_cl", f"{name} {label} B={NUM_ENVS}: card vs CPU "
                f"max|dqpos| {err[0]:.3g}, max|dqvel| {err[1]:.3g} (bounds "
                f"{tol[0]:g}, {tol[1]:g}; envs over them {over}, 99.9th "
                f"percentiles {r[label]['p99_9']}); a second call bitwise "
                f"{bitwise}; the graph bitwise {graph_bitwise}")
            out = gated and gate_step and (err[0] > tol[0] or err[1] > tol[1])
            if not (bitwise and graph_bitwise) or out or \
                    not bool(torch.isfinite(e1[1]).all()):
                raise RuntimeError(f"engine_cl {name} {label}: {r[label]}")
            if label == "walls":
                qp, qv = args[0], args[1]
                bp, bq = eng.fk(qp)
                p0 = bp.mean(1)
                S = eng.kin.dof_subspaces(bp - p0[:, None], bq)
                V = eng.body_velocities(S, eng.kin.qvel_to_u(
                    qv, bp - p0[:, None]))
                diag = {}
                eng.contact_forces(bp, bq, V, p0, diag=diag)
                n_in = int((diag["pen_wall"] > 0).sum())
                r["sdf_contacts"] = n_in
                log("16 engine_cl", f"{name}: {n_in} probes inside the SDF "
                    f"walls of {NUM_ENVS} ants against them")
                if n_in == 0:
                    raise RuntimeError("engine_cl saw no SDF contact")
        t0 = time.time()
        for B in (CL_SMALL, NUM_ENVS):
            sub = tuple(t[:B].contiguous() for t in batches[0][1])
            eng.graphed_step(*sub)              # captured outside the timing
            eager = cuda_ms(lambda: eng.step(*sub), 3)
            graph = cuda_ms(lambda: eng.graphed_step(*sub), 20)
            kernels = kernel_count(lambda: eng.step(*sub))
            r[f"B{B}"] = {"eager_ms": eager, "graph_ms": graph,
                          "kernels": kernels}
            log("16 engine_cl", f"{name} one control step at B={B}: eager "
                f"{eager:.3f} ms, CUDA graph {graph:.3f} ms, {kernels} "
                f"kernels a step; the substep kernel at B={NUM_ENVS} "
                f"{k_ms:.4f} ms, 1 launch [{smi}]")
        log("16 engine_cl", f"{name} collect {CL_STEPS} steps x {NUM_ENVS} "
            f"envs: {secs:.3f} s, {r['env_steps_per_s']:.0f} env steps/s; "
            f"timings {time.time() - t0:.1f} s")
        rec[name] = r
    return rec


# ------------------------------------------------------- 17. parallel/

DP_ITERS = 3             # timed iterations before the recluster


def dp_digest(ts) -> dict:
    """{path: sha1 of the bytes} of every replicated leaf of a DP rank's
    state (`parallel/dp.py:state_specs`)."""
    import hashlib

    from ddiffpg_tpu_torch.parallel import dp
    specs = dp.state_specs(ts)
    return {k: hashlib.sha1(x.detach().cpu().numpy().tobytes()).hexdigest()
            for k, x in ((".".join(map(str, p)), x)
                         for p, x in dp.leaves(ts)) if specs[k] == ()}


def dp_rank(rank: int, world: int, backend: str, store: str, out: str,
            recluster: bool):
    """One rank of phase 17: stock DDiffPG on antmaze-v1 at TRAIN_ENVS
    envs across `world` ranks of one card (the substep kernel steps each
    rank's envs): warm-up, DP_ITERS timed iterations; with `recluster`,
    synthetic successes on MAZE_v1's two corridors written into each
    rank's replay, a recluster and one iteration at its groups. Writes its
    record to `out`/rank<r>.json."""
    import hashlib
    import pickle

    import torch.distributed as dist

    from ddiffpg_tpu_torch.agents import base
    from ddiffpg_tpu_torch.parallel import dp, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    cfg = stock_config("antmaze-v1")
    agent = dp.DPAgentDDiffPG(cfg, make_mesh(world, device="cuda"),
                              env_kwargs={"random_init":
                                          cfg.env.random_init})
    kernel = agent.agent.env.env.kernel
    t0 = time.time()
    ts = agent.warmup(agent.init())
    torch.cuda.synchronize()
    rec = {"rank": rank, "warmup_s": time.time() - t0,
           "local_envs": agent.agent.env.num_envs,
           "local_batch": agent.agent.cfg.algo.batch_size}
    ts, logs = agent.train_iter(ts)              # untimed
    torch.cuda.synchronize()
    base.DP_COUNTS.update(all_reduce=0, elements=0)
    kernel.launches = 0
    t0 = time.time()
    for _ in range(DP_ITERS):
        ts, logs = agent.train_iter(ts)
    torch.cuda.synchronize()
    rec["s_per_iter"] = (time.time() - t0) / DP_ITERS
    rec["all_reduce_per_iter"] = base.DP_COUNTS["all_reduce"] / DP_ITERS
    rec["bytes_per_iter"] = 4 * base.DP_COUNTS["elements"] / DP_ITERS
    rec["kernel_launches"] = kernel.launches
    rec["logs"] = {k: float(v) for k, v in logs.items()}
    if recluster:
        rng = np.random.RandomState(10 + rank)
        # the window ends before any in-flight episode outgrows the replay
        steps = agent.agent.env.max_episode_length - int(
            ts.replay.tmp_len.max())
        plans, n_succ, _ = fill_plans(rng, agent.agent.env.num_envs, 250,
                                      steps)
        write_trajectories(ts, plans, steps, seed=20 + rank)
        t0 = time.time()
        ts = agent.update_cluster(ts)
        torch.cuda.synchronize()
        rec["recluster_s"] = time.time() - t0
        rec["num_groups"] = agent.num_groups
        res = agent.last_recluster
        rec["plan"] = hashlib.sha1(pickle.dumps(
            (res.num_groups, res.plan))).hexdigest()
        # this rank's masks are its share of the broadcast global masks
        S = ts.replay.length.shape[0]
        rec["own_masks"] = bool(np.array_equal(
            ts.replay.group_mask.cpu().numpy(),
            res.group_mask[:, rank * S:(rank + 1) * S]))
        t0 = time.time()
        ts, logs = agent.train_iter(ts)
        torch.cuda.synchronize()
        rec["s_iter_after"] = time.time() - t0
        rec["logs"] = {k: float(v) for k, v in logs.items()}
        rec["successes_written"] = n_succ
    rec["digest"] = dp_digest(ts)
    rec["finite"] = all(np.isfinite(v) for v in rec["logs"].values())
    with open(Path(out) / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def dp_phase(smi: str) -> dict:
    """17: `parallel/` on the card, in processes from
    torch.multiprocessing.spawn (the main process holds no process group;
    a rank's failure raises here): world 2 through gloo on the one card
    (warm-up, iterations, a recluster of two corridors' successes and an
    iteration), its replicated leaves bitwise alike on both ranks and the
    masks alike; then world 1 through NCCL (warm-up, iterations)."""
    import torch.multiprocessing as mp

    rec = {}
    for world, backend, recl in ((2, "gloo", True), (1, "nccl", False)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
            t0 = time.time()
            mp.spawn(dp_rank, args=(world, backend, f"{d}/store", d, recl),
                     nprocs=world, join=True)
            wall = time.time() - t0
            ranks = [json.load(open(Path(d) / f"rank{r}.json"))
                     for r in range(world)]
        r0 = ranks[0]
        key = f"world{world}_{backend}"
        bad = [k for k in r0["digest"]
               if any(r["digest"][k] != r0["digest"][k] for r in ranks)]
        same = {k: all(r.get(k) == r0.get(k) for r in ranks)
                for k in ("num_groups", "plan", "logs")}
        if bad or not all(same.values()) or not all(
                r["finite"] and r.get("own_masks", True) for r in ranks):
            raise RuntimeError(f"DP {key}: leaves differ across ranks "
                               f"{bad[:5]}, alike {same}")
        rec[key] = {"spawn_s": wall, "ranks": [
            {k: v for k, v in r.items() if k not in ("digest", "logs")}
            for r in ranks], "replicated_leaves": len(r0["digest"])}
        log("17 parallel", f"{key}: {r0['local_envs']} envs and batch "
            f"{r0['local_batch']} a rank; warm-up {r0['warmup_s']:.1f} s, "
            f"{r0['s_per_iter']:.4f} s per iteration, "
            f"{r0['all_reduce_per_iter']:.1f} all_reduce "
            f"({r0['bytes_per_iter']:,.0f} bytes) an iteration, substep "
            f"launches {r0['kernel_launches']}; "
            + (f"recluster of {r0['successes_written']} + "
               f"{ranks[-1]['successes_written']} successes "
               f"{r0['recluster_s']:.2f} s -> {r0['num_groups']} groups, "
               f"then {r0['s_iter_after']:.3f} s an iteration; "
               if recl else "")
            + f"{len(r0['digest'])} replicated leaves bitwise alike on "
            f"{world} ranks; {wall:.1f} s with the spawn [{smi}]")
        if recl and r0["num_groups"] < 3:
            raise RuntimeError(f"DP recluster found {r0['num_groups']} "
                               "groups, not two modes and explore")
    return rec


# ----------------------------------------------- 18. the last helpers

WAYPOINT_MAZES = ("pointmaze-v1", "pointmaze-v2")
WAYPOINT_ENVS = 16
# quat.integrate on the card against the CPU: float32 sin, cos and square
# roots of the two libraries differ by an ulp or two
QUAT_TOL = 1e-6


def dtw_float32_bound(la: np.ndarray, lb: np.ndarray, Dx: int) -> np.ndarray:
    """Relative bound [P] of a float32 DTW distance against the exact one
    on the same points: a terminal cell sums at most la + lb - 1 cell
    costs of Dx squared differences, each op rounded once (unit 2^-24),
    and the square root rounds once more."""
    return (la.astype(np.float64) + lb + Dx + 2) * 2.0 ** -24


def helpers_phase(smi: str, device: str = "cuda") -> dict:
    """18: the port's last helpers on the card. The DTW kernel on phase
    10a's pairs against the host's float64 `modes/_native.py:dtw_batch`
    within float32 rounding (`dtw_float32_bound`); `physics/maze.py:
    waypoint_policy` driving WAYPOINT_ENVS pointmaze envs on the card
    toward each goal of WAYPOINT_MAZES over one episode, the action the
    clipped offset to the next waypoint, every env to reach its goal;
    `physics/quat.py:integrate` and `inv_rotate` on the card against the
    CPU. (`device="cpu"` rehearses the phase without a card.)"""
    rec = {}
    args = dtw_inputs(5, 640, DTW_PAIRS, device)
    got = dtw.dtw_batch_gather(*args).double().cpu().numpy()
    stack, _, lens, _, ia, ib = (t.cpu().numpy() for t in args)
    a, b = stack[ia].astype(np.float64), stack[ib].astype(np.float64)
    la, lb = lens[ia], lens[ib]
    t0 = time.time()
    want = _native.dtw_batch(a, b, la, lb)
    host_s = time.time() - t0
    rel = np.abs(got - want) / np.maximum(want, 1e-30)
    bound = dtw_float32_bound(la, lb, stack.shape[-1])
    over = int((np.abs(got - want) > bound * want).sum())
    rec["dtw_host"] = {"pairs": len(ia), "max_rel_err": float(rel.max()),
                       "max_rel_bound": float(bound.max()),
                       "pairs_over": over, "host_s": host_s}
    log("18 helpers", f"DTW kernel vs the host float64 dtw_batch on "
        f"{len(ia)} pairs: max relative {rel.max():.3e}, pairs over the "
        f"float32 bound (up to {bound.max():.3e}) {over}; the host DTW "
        f"{host_s:.2f} s [{smi}]")
    if over:
        raise RuntimeError(f"DTW kernel vs host: {rec['dtw_host']}")

    for name in WAYPOINT_MAZES:
        env = make(name, num_envs=WAYPOINT_ENVS, device=device, seed=0)
        inner = env.env
        rates = []
        for g, gxy in enumerate(inner.goal_xy.tolist()):
            policy = maze.waypoint_policy(inner.maze_map, gxy)
            state, _ = env.reset()
            reached = np.zeros(WAYPOINT_ENVS, bool)
            ended = np.zeros(WAYPOINT_ENVS, bool)
            for _ in range(inner.max_episode_steps):
                xy = state.qpos.cpu().numpy().astype(np.float64)
                wp = np.array([policy(tuple(p)) for p in xy])
                action = torch.tensor(np.clip(wp - xy, -1.0, 1.0),
                                      dtype=torch.float32, device=device)
                state, _, _, done, info = env.step(state, action)
                done = done.cpu().numpy()
                first = done & ~ended
                reached |= first & (info["success"].cpu().numpy() == g + 1)
                ended |= done
                if ended.all():
                    break
            rates.append(float(reached.mean()))
        rec[name] = {"success_per_goal": rates,
                     "goals": inner.goal_xy.tolist()}
        log("18 helpers", f"{name}: waypoint_policy over {WAYPOINT_ENVS} "
            f"envs on the card, success per goal {rates} (goals "
            f"{inner.goal_xy.tolist()})")
        if min(rates) < 1.0:
            raise RuntimeError(f"{name}: a waypoint rollout missed its goal")

    gen = torch.Generator().manual_seed(18)
    q = torch.randn((NUM_ENVS, 4), generator=gen)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w = torch.randn((NUM_ENVS, 3), generator=gen) * 3.0
    v = torch.randn((NUM_ENVS, 3), generator=gen)
    err = {}
    for what, fn in (("integrate", lambda q, w, v: Q.integrate(q, w, 0.01)),
                     ("inv_rotate", lambda q, w, v: Q.inv_rotate(q, v))):
        card = fn(q.to(device), w.to(device), v.to(device)).cpu()
        err[what] = float((card - fn(q, w, v)).abs().max())
    rec["quat"] = err
    log("18 helpers", f"quat on the card vs the CPU at B={NUM_ENVS}: max "
        f"|diff| {err} (bound {QUAT_TOL:g})")
    if max(err.values()) > QUAT_TOL:
        raise RuntimeError(f"quat card vs CPU: {err}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    # ---------------------------------------------------------- 1. device
    clock = [time.time()]

    def stamp(what: str):
        """Log the wall seconds since the last stamp (the smoke's time by
        phase)."""
        now = time.time()
        log("time", f"{what}: {now - clock[0]:.1f} s")
        clock[0] = now

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the port runs full float32")
    log("1 device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__}"
        f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    cfg = Config()

    # ---------------------------------------------------------- 2. build
    t0 = time.time()
    ant_env = AntMazeEnv(random_init=True, device="cpu")
    ant_c = {n: SubstepConstants.from_model(ant_env.model, n_substeps=n)
             for n in (10, 1)}
    scenes = {task: build_panda_scene(task) for task in PANDA_TASKS}
    panda_c = {(task, n): SubstepConstants.from_model(m, n_substeps=n)
               for task, (m, _) in scenes.items() for n in (20, 1)}
    maze_c = {(name, n): SubstepConstants.from_model(
        AntMazeEnv(name, device="cpu").model, n_substeps=n)
        for name in OTHER_MAZES for n in (10, 1)}
    builds = list(ant_c.values()) + list(panda_c.values()) + \
        list(maze_c.values())
    with ThreadPoolExecutor(max_workers=2) as pool:
        # the DTW kernel (nvcc) and the linkage library (g++) beside them
        others = [pool.submit(dtw_cuda.build), pool.submit(_native.build)]
        build_all(builds)
        for f in others:
            f.result()
    log("2 build", f"{len(builds)} substep kernels (antmaze-v1 at 10 and 1 "
        "substeps, four Panda scenes at 20 and 1, the five other mazes at "
        "10 and 1), the DTW kernel and the linkage library built in "
        f"{time.time() - t0:.1f} s")
    labels = [f"ant n_substeps {n}" for n in ant_c] + [
        f"{task} n_substeps {n}" for task, n in panda_c] + [
        f"{name} ({c.nsb} walls) n_substeps {n}"
        for (name, n), c in maze_c.items()]
    for label, c in zip(labels, builds):
        for line in build(c).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("2 build", f"{label}: {line.strip()}")
    t0 = time.time()
    k10, k1 = SubstepKernel(ant_c[10]), SubstepKernel(ant_c[1])
    pk = {key: SubstepKernel(c) for key, c in panda_c.items()}
    mk = {key: SubstepKernel(c) for key, c in maze_c.items()}
    maze_kernels = {name: (mk[(name, 10)], mk[(name, 1)])
                    for name in OTHER_MAZES}
    log("2 build", f"loaded in {time.time() - t0:.1f} s")
    for label, k in zip(labels, [k10, k1, *pk.values(), *mk.values()]):
        log("2 build", f"{label}: {k.lanes} lanes per env, {k.groups} envs "
            f"per block of {k.lanes * k.groups} threads, {k.shared_bytes} "
            "shared bytes per block")

    stamp("phases 1-2 (the builds)")

    # ------------------------------------ 3. ant kernel vs plain on the card
    init_qpos = np.asarray(ant_env.model.init_qpos)
    nobox = dataclasses.replace(
        ant_c[1], nsb=0, box_min=ant_c[1].box_min[:0],
        box_max=ant_c[1].box_max[:0])
    ant_err = 0.0
    for wall in (False, True):
        args = ant_states(init_qpos, NUM_ENVS, 3 if wall else 0, wall)
        for nsub, kern in ((1, k1), (10, k10)):
            ant_err = max(ant_err, check_kernel(
                kern, "wall" if wall else "random", args, TOL[nsub],
                "3 kernel"))
        if wall:
            # the AABB branch fired: walls change the one-substep result
            free = substep_reference(nobox, *args)[1]
            dv = float((k1(*args)[1] - free).abs().max())
            log("3 kernel", f"wall batch: max|dqvel| from the walls {dv:.3f}")
            if dv < 1e-2:
                raise RuntimeError("wall batch made no wall contact")
    qp, qv, ct = ant_states(init_qpos, NUM_ENVS, 0, False)
    ant_ms = cuda_ms(lambda: k10(qp, qv, ct), 50)
    ant_plain_ms = cuda_ms(lambda: substep_reference(k10.consts, qp, qv, ct),
                           3)
    ant_bound = substep_bound(k10.consts, qp, qv, ct)
    log("3 kernel", f"one control step (10 substeps) at B={NUM_ENVS}: kernel "
        f"{ant_ms:.4f} ms, plain PyTorch {ant_plain_ms:.2f} ms, bound "
        f"{ant_bound[0]:.5f} ms ({ant_bound[1]}, {ant_bound[2]} flops per "
        f"env per substep) [{smi}]")

    # ---------------------------------- 3p. Panda kernel vs plain on the card
    panda_err = {task: 0.0 for task in PANDA_TASKS}
    for task, (m, meta) in scenes.items():
        for nsub in (1, 20):
            kern = pk[(task, nsub)]
            batches = [("random", panda_states(m, meta, NUM_ENVS, 1))]
            if task == "DrawerMulti":
                batches.append(("contact", drawer_contact_states(
                    m, meta, kern.consts, NUM_ENVS, 2)))
            for label, args in batches:
                panda_err[task] = max(panda_err[task], check_kernel(
                    kern, f"{task} {label}", args, PANDA_TOL[nsub],
                    "3p panda"))
                if label == "contact" and nsub == 1:
                    # stage g fired: the drawers change the one-substep result
                    free = substep_reference(
                        without_dynamic_boxes(kern.consts), *args)[1]
                    dv = float((kern(*args)[1] - free).abs().max())
                    log("3p panda", f"contact batch: max|dqvel| from the "
                        f"drawers {dv:.3f}")
                    if dv < 1e-2:
                        raise RuntimeError("contact batch touched no drawer")
    panda_ms, panda_plain_ms, panda_bound = {}, {}, {}
    for task in ("DrawerMulti", "Reach"):
        m, meta = scenes[task]
        kern = pk[(task, 20)]
        qp, qv, ct = panda_states(m, meta, NUM_ENVS, 1)
        panda_ms[task] = cuda_ms(lambda: kern(qp, qv, ct), 20)
        panda_plain_ms[task] = cuda_ms(
            lambda: substep_reference(kern.consts, qp, qv, ct), 2)
        panda_bound[task] = substep_bound(kern.consts, qp, qv, ct)
        log("3p panda", f"{task} one control step (20 substeps) at "
            f"B={NUM_ENVS}: kernel {panda_ms[task]:.4f} ms, plain PyTorch "
            f"{panda_plain_ms[task]:.2f} ms, bound {panda_bound[task][0]:.5f}"
            f" ms ({panda_bound[task][1]}, {panda_bound[task][2]} flops per "
            f"env per substep) [{smi}]")
    # the Panda builds' second entry, the ee state, against Arm.ee_state
    ee_err, ee_ms, ee_plain_ms, ee_bound = {}, {}, {}, {}
    for task in ("DrawerMulti", "Reach"):
        m, meta = scenes[task]
        kern, arm = pk[(task, 20)], Arm(m, meta, "cuda")
        qp, qv, _ = panda_states(m, meta, NUM_ENVS, 1)
        ee_err[task] = check_ee_state(kern, arm, qp, qv, task, "3p panda")
        ee_ms[task] = cuda_ms(lambda: kern.ee_state(
            qp, qv, arm.hand, arm.ee_offset_host), 50)
        ee_plain_ms[task] = cuda_ms(lambda: arm.ee_state(qp, qv), 5)
        ee_bound[task] = ee_state_bound(arm, qp, qv)
        log("3p panda", f"{task} ee state at B={NUM_ENVS}: kernel "
            f"{ee_ms[task]:.4f} ms, plain PyTorch {ee_plain_ms[task]:.2f} "
            f"ms, bound {ee_bound[task][0]:.6f} ms ({ee_bound[task][1]}, "
            f"{ee_bound[task][2]} flops per env) [{smi}]")
    # the third entry, the ee control's DLS IK, against Arm.dls_ik
    m, meta = scenes["DrawerMulti"]
    kern, arm = pk[("DrawerMulti", 20)], Arm(m, meta, "cuda")
    qp = panda_states(m, meta, NUM_ENVS, 1)[0]
    tg = ik_inputs(arm, qp, 1)
    ik_err = check_dls_ik(kern, arm, qp, tg, "DrawerMulti", "3p panda")
    ik_args = (arm.arm_body_host, arm.hand, arm.ee_offset_host, 3, 0.05)
    ik_ms = cuda_ms(lambda: kern.dls_ik(qp, tg, *ik_args), 50)
    ik_plain_ms = cuda_ms(lambda: arm.dls_ik(qp, tg), 5)
    ik_bound = dls_ik_bound(arm, qp, tg)
    log("3p panda", f"DrawerMulti DLS IK (3 iterations) at B={NUM_ENVS}: "
        f"kernel {ik_ms:.4f} ms, plain PyTorch {ik_plain_ms:.2f} ms, bound "
        f"{ik_bound[0]:.6f} ms ({ik_bound[1]}, {ik_bound[2]} flops per env)"
        f" [{smi}]")

    stamp("phases 3-3p (kernels vs plain)")

    # ---------------------------------------------------- 4. antmaze-v1 slice
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    env = make("antmaze-v1", num_envs=NUM_ENVS, random_init=True,
               device="cuda", seed=0)
    ant: AntMazeEnv = env.env
    actor = Actor(env, cfg, gen)
    state, obs, roll, secs, ant_launches, n_reset = timed_collect(
        actor, env, ant.kernel, N_STEPS, "antmaze-v1")
    log("4 slice", f"collect {N_STEPS} steps x {NUM_ENVS} envs: {secs:.3f} "
        f"s, {NUM_ENVS * N_STEPS / secs:.0f} env steps/s, kernel launches "
        f"{ant_launches}, envs auto-reset {n_reset}, goals reached "
        f"{int((roll.success > 0).sum())} [{smi}]")
    ant_split = host_split(actor, env, state, obs, {}, "4 slice", smi)

    class PlainPhysicsAntMaze(AntMazeEnv):
        """The same env with the plain PyTorch substep, for timing only."""

        def _physics(self, qpos, qvel, ctrl):
            return substep_reference(self.consts, qpos, qvel, ctrl)

    plain_env = VecEnv(PlainPhysicsAntMaze(random_init=True, device="cuda"),
                       NUM_ENVS)
    torch.cuda.synchronize()
    t0 = time.time()
    _, _, plain_roll = actor.collect(plain_env, state, obs, N_PLAIN_STEPS)
    torch.cuda.synchronize()
    plain_sps = NUM_ENVS * N_PLAIN_STEPS / (time.time() - t0)
    if not bool(torch.isfinite(plain_roll.obs).all()):
        raise RuntimeError("non-finite obs with the plain physics")
    log("4 slice", f"collect with the plain PyTorch substep: {plain_sps:.0f} "
        f"env steps/s over {N_PLAIN_STEPS} steps [{smi}]")

    # ---------------------------------------------------------- 5. goal probe
    goal_probe(env, lambda q: q[0, :2].copy_(
        torch.tensor([-7.8, 0.1], device="cuda")), "5 goal", "at (-7.8, 0.1)")

    # ----------------------------------------------------- 6. Panda slice
    env = make("PandaDrawerMultiJoints-v3", num_envs=NUM_ENVS, device="cuda",
               seed=0)
    drawer: PandaTaskEnv = env.env
    actor = Actor(env, cfg, gen)
    state, obs, roll, secs, drawer_launches, n_reset = timed_collect(
        actor, env, drawer.kernel, N_STEPS, "PandaDrawerMultiJoints-v3")
    drawer_ee = drawer.kernel.ee_launches
    log("6 panda", f"DrawerMulti collect {N_STEPS} steps x {NUM_ENVS} envs: "
        f"{secs:.3f} s, {NUM_ENVS * N_STEPS / secs:.0f} env steps/s, kernel "
        f"launches {drawer_launches}, envs auto-reset {n_reset}, drawers "
        f"closed {int((roll.success > 0).sum())} [{smi}]")
    ctrl = drawer._ctrl_from_action(
        state.qpos, torch.zeros((NUM_ENVS, env.action_dim), device="cuda"))
    drawer_split = host_split(actor, env, state, obs, {
        "ee state": lambda s=state: drawer._ee_state(s.qpos, s.qvel),
        "kernel": lambda s=state, c=ctrl: drawer.kernel(s.qpos, s.qvel, c)},
        "6 panda", smi)

    class PlainPhysicsPanda(PandaTaskEnv):
        """The same env with the plain PyTorch substep, for timing only."""

        def _physics(self, qpos, qvel, ctrl):
            return substep_reference(self.consts, qpos, qvel, ctrl)

    plain_env = VecEnv(PlainPhysicsPanda("DrawerMulti", device="cuda"),
                       NUM_ENVS)
    torch.cuda.synchronize()
    t0 = time.time()
    _, _, plain_roll = actor.collect(plain_env, state, obs,
                                     N_PANDA_PLAIN_STEPS)
    torch.cuda.synchronize()
    plain_sps = NUM_ENVS * N_PANDA_PLAIN_STEPS / (time.time() - t0)
    if not bool(torch.isfinite(plain_roll.obs).all()):
        raise RuntimeError("non-finite obs with the plain physics")
    log("6 panda", f"DrawerMulti collect with the plain PyTorch substep: "
        f"{plain_sps:.0f} env steps/s over {N_PANDA_PLAIN_STEPS} steps "
        f"[{smi}]")

    reach_env = make("PandaReachJoints-v3", num_envs=NUM_ENVS, device="cuda",
                     seed=0)
    reach_actor = Actor(reach_env, cfg, gen)
    _, _, _, secs, reach_launches, n_reset = timed_collect(
        reach_actor, reach_env, reach_env.env.kernel, N_REACH_STEPS,
        "PandaReachJoints-v3")
    reach_ee = reach_env.env.kernel.ee_launches
    log("6 panda", f"Reach collect {N_REACH_STEPS} steps x {NUM_ENVS} envs: "
        f"{secs:.3f} s, {NUM_ENVS * N_REACH_STEPS / secs:.0f} env steps/s, "
        f"kernel launches {reach_launches}, envs auto-reset {n_reset} "
        f"[{smi}]")

    # ------------------------------------------------- 7. Panda goal probe
    goal_probe(env, lambda q: q[0, int(drawer.task_adr[0])].fill_(0.0),
               "7 goal", "with drawer 0 at 0.0")

    # ------------------------------------------ 8. device time of a step
    device_split(*ant_split, "antmaze-v1", smi)
    device_split(*drawer_split, "PandaDrawerMultiJoints-v3", smi)

    stamp("phases 4-8 (collects, probes, device splits)")

    # ------------------------------------------- 9. DDiffPG train iteration
    train, train_launches = train_phase(smi)
    stamp("phase 9 (train)")

    # --------------------------------------- 10. recluster, eval, the loop
    # the final checkpoints of phases 10c and 13, kept for phase 15 (the
    # directory goes at the end, or at exit when a phase fails)
    kept = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    runs = {name: Path(kept.name) / name
            for name in ("antmaze-v1", "antmaze-v2")}
    dtw_rec = dtw_phase(smi)
    recluster, dtw_launches = recluster_phase(smi)
    loop = loop_phase(smi, runs["antmaze-v1"])
    loop_launches = sum(loop["substep_launches"].values())
    stamp("phase 10 (the loop)")

    # ----------------------------------------- 11. the other antmazes
    mazes, maze_launches, maze_entries, dtw_maze, v3_split = mazes_phase(
        smi, maze_kernels, cfg)
    stamp("phase 11 (mazes)")

    # ------------------------------------------ 12. Panda ee control
    ee, ee_launches, ee_split, dtw_ee = panda_ee_phase(smi, cfg)
    stamp("phase 12 (Panda ee)")

    # --------------------------------- 13. pointmaze and the entry point
    points, v2_main_launches, point_split = pointmaze_phase(
        smi, cfg, runs["antmaze-v2"])
    maze_launches["antmaze-v2"] += v2_main_launches
    stamp("phase 13 (pointmaze, entry points)")

    # ----------------------------------------------------- 14. the baselines
    baselines, baseline_launches, held = baselines_phase(smi)
    stamp("phase 14 (baselines)")

    # ----------------------------------------------------- 15. the tools
    scratch = Path(kept.name) / "scratch"
    scratch.mkdir()
    tools, tools_v1_launches, tools_v2_launches = tools_phase(smi, runs,
                                                              scratch)
    maze_launches["antmaze-v2"] += tools_v2_launches
    kept.cleanup()
    stamp("phase 15 (the tools)")

    # --------------------------------------------- 16. engine_cl on the card
    engine_cl = engine_cl_phase(smi, {"antmaze-v1": ant_ms,
                                      "DrawerMulti": panda_ms["DrawerMulti"]})
    stamp("phase 16 (engine_cl)")

    # ------------------------------------------------- 17. data parallelism
    parallel = dp_phase(smi)
    stamp("phase 17 (parallel)")

    # ------------------------------------------------- 18. the last helpers
    helpers = helpers_phase(smi)
    stamp("phase 18 (helpers)")

    # device time of the new collect paths and the baselines' iterations,
    # after every timed phase
    device_split(*v3_split, "antmaze-v3", smi)
    device_split(*ee_split, "PandaDrawerMulti-v3 (ee)", smi)
    device_split(*point_split, "pointmaze-v1", smi)
    baselines_profile(baselines, held, smi)
    stamp("profiler windows")

    # ---------------------------------------------------------- the result
    print(json.dumps({"train": train}))
    print(json.dumps({"loop": {"dtw": dtw_rec, "recluster": recluster,
                               "run": loop, "card": smi}}))
    print(json.dumps({"envs": {"mazes": mazes, "panda_ee": ee,
                               "pointmaze": points, "card": smi}}))
    print(json.dumps({"baselines": {**baselines, "card": smi}}))
    print(json.dumps({"tools": {**tools, "card": smi}}))
    print(json.dumps({"engine_cl": {**engine_cl, "card": smi}}))
    print(json.dumps({"parallel": {**parallel, "card": smi}}))
    print(json.dumps({"helpers": {**helpers, "card": smi}}))
    print(json.dumps({"kernels": [
        kernel_entry("substep_ant",
                     ant_launches + train_launches + loop_launches
                     + baseline_launches + tools_v1_launches, ant_err,
                     ant_ms, ant_plain_ms, ant_bound),
        kernel_entry("substep_panda_drawermulti",
                     drawer_launches + ee_launches["drawer"],
                     panda_err["DrawerMulti"], panda_ms["DrawerMulti"],
                     panda_plain_ms["DrawerMulti"],
                     panda_bound["DrawerMulti"]),
        kernel_entry("substep_panda_reach",
                     reach_launches + ee_launches["reach"],
                     panda_err["Reach"], panda_ms["Reach"],
                     panda_plain_ms["Reach"], panda_bound["Reach"]),
        kernel_entry("ee_state_panda_drawermulti",
                     drawer_ee + ee_launches["drawer_ee"],
                     ee_err["DrawerMulti"], ee_ms["DrawerMulti"],
                     ee_plain_ms["DrawerMulti"], ee_bound["DrawerMulti"],
                     replaces="ddiffpg_tpu/envs/panda.py:66"),
        kernel_entry("ee_state_panda_reach",
                     reach_ee + ee_launches["reach_ee"], ee_err["Reach"],
                     ee_ms["Reach"], ee_plain_ms["Reach"], ee_bound["Reach"],
                     replaces="ddiffpg_tpu/envs/panda.py:66"),
        kernel_entry("dls_ik_panda_drawermulti", ee_launches["drawer_ik"],
                     ik_err, ik_ms, ik_plain_ms, ik_bound,
                     replaces="ddiffpg_tpu/physics/panda.py:251"),
        *[kernel_entry(f"substep_{name.replace('-', '_')}",
                       maze_launches[name], err, ms, plain_ms, bound)
          for name, err, ms, plain_ms, bound in maze_entries],
        kernel_entry("dtw", dtw_launches + dtw_maze + dtw_ee,
                     dtw_rec["max_abs_err"],
                     dtw_rec["ms"], dtw_rec["plain_ms"], dtw_rec["bound"],
                     source="ddiffpg_tpu_torch/csrc/dtw.cu",
                     replaces="ddiffpg_tpu/ops/dtw.py:25")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
