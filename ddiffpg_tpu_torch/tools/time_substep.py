"""Time the CUDA substep kernel of several checkouts, or of several lane
counts, in turns on one card.

    python3 -m ddiffpg_tpu_torch.tools.time_substep [DIR ...] [--lanes N ...]

Each DIR is another checkout of this repository, for example the parent
commit unpacked with `git archive`; `--lanes` runs this checkout's kernel
once for each given number of threads per env (8, 16 or 32; by default the
number `lanes_for` picks). Every variant runs in a process of its own (a
process imports one copy of the package), which builds and loads that
checkout's kernel for the three builds the collect paths launch: the ant
(antmaze-v1, 10 substeps), PandaDrawerMultiJoints-v3 and
PandaReachJoints-v3 (20 substeps each). Each runs on the same 4096 states
(the ant's drawn from seed 0, the Panda's from seed 1, as `chip_smoke.py`
draws them; the draws live here, so that every checkout gets the same
inputs), and reports the mean time of one launch of a control step over 50
launches timed with CUDA events after 50 launches of warm-up, and a digest
of its output. The variants run in turns, the order reversed every round
(A B C, C B A, ...), so drift on the card shows. The last line is a JSON
object with every time and, per build, whether all outputs agree bit for
bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
B, REPS = 4096, 50
BUILDS = ("ant", "DrawerMulti", "Reach")


def ant_states(init_qpos: np.ndarray, seed: int):
    rng = np.random.RandomState(seed)
    qpos = np.tile(init_qpos[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    return tuple(torch.tensor(a, device="cuda") for a in (qpos, qvel, ctrl))


def panda_states(m, meta, seed: int):
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.init_qpos)[None], (B, 1)).astype(np.float32)
    qpos[:, meta["arm_qposadr"]] += rng.uniform(-0.1, 0.1, (B, 7))
    qvel = rng.uniform(-0.2, 0.2, (B, m.nv)).astype(np.float32)
    ctrl = np.tile(np.concatenate([meta["neutral"], [0.015, 0.015]])[None],
                   (B, 1)).astype(np.float32)
    ctrl[:, :7] += rng.uniform(-0.05, 0.05, (B, 7))
    return tuple(torch.tensor(a, device="cuda") for a in (qpos, qvel, ctrl))


def worker(lanes: int | None) -> dict:
    """Time the three builds of the checkout this process imports."""
    from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
    from ddiffpg_tpu_torch.physics import substep_cuda
    from ddiffpg_tpu_torch.physics.panda import build_panda_scene
    from ddiffpg_tpu_torch.physics.substep import SubstepConstants

    ant = AntMazeEnv(random_init=True, device="cpu").model
    cases = {"ant": (ant, ant_states(np.asarray(ant.init_qpos), 0))}
    for task in BUILDS[1:]:
        m, meta = build_panda_scene(task)
        cases[task] = (m, panda_states(m, meta, 1))
    consts = [SubstepConstants.from_model(m) for m, _ in cases.values()]
    kw = {} if lanes is None else {"lanes": lanes}
    with ThreadPoolExecutor(len(consts)) as pool:   # one nvcc each
        list(pool.map(lambda c: substep_cuda.build(c, **kw), consts))
    out = {}
    for (name, (m, args)), c in zip(cases.items(), consts):
        kern = substep_cuda.SubstepKernel(c, **kw)
        res = kern(*args)
        for _ in range(REPS):   # warm-up: the card idled during the builds
            kern(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            kern(*args)
        end.record()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in res)).hexdigest()[:16]
        out[name] = {"ms": start.elapsed_time(end) / REPS, "digest": digest,
                     "lanes": getattr(kern, "lanes", None)}
    return out


def run_in(checkout: Path, lanes: int | None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    cmd = [sys.executable, __file__, "--worker"]
    if lanes is not None:
        cmd += ["--lanes", str(lanes)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{checkout} (lanes {lanes}) failed:\n"
                           + res.stderr[-4000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", type=Path)
    ap.add_argument("--lanes", type=int, nargs="*", default=[None])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_substep: no CUDA card", file=sys.stderr)
        return 1
    if a.worker:
        print(json.dumps(worker(a.lanes[0] if a.lanes else None)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    variants = [(p.resolve(), None) for p in a.others] + [
        (HERE, n) for n in a.lanes]
    label = {v: f"{v[0]}" + ("" if v[1] is None else f" lanes={v[1]}")
             for v in variants}
    ms = {label[v]: {b: [] for b in BUILDS} for v in variants}
    digests = {b: set() for b in BUILDS}
    for r in range(a.rounds):
        for v in variants if r % 2 == 0 else variants[::-1]:
            got = run_in(*v)
            for b in BUILDS:
                ms[label[v]][b].append(got[b]["ms"])
                digests[b].add(got[b]["digest"])
            print(f"[round {r}] {label[v]}: " + ", ".join(
                f"{b} {got[b]['ms']:.4f} ms (lanes {got[b]['lanes']}, "
                f"output {got[b]['digest']})" for b in BUILDS)
                + f" [{smi}]", flush=True)
    print(json.dumps({"ms": ms, "bitwise_equal": {
        b: len(d) == 1 for b, d in digests.items()}, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
