"""Time the antmaze-v1 ant's CUDA substep kernel of several checkouts in
turns, on one card.

    python3 -m ddiffpg_tpu_torch.tools.time_substep DIR [DIR ...]

Each DIR is another checkout of this repository, for example the parent
commit unpacked with `git archive`. For each checkout, and for this one,
a process of its own (a process imports one copy of the package) builds and
loads that checkout's kernel, runs it on the same 4096 random ant states
(seed 0, drawn as `chip_smoke.py` draws them), and reports the mean time of
one launch of a control step (10 substeps) over 50 launches timed with CUDA
events after a warm-up, and a digest of its output. The checkouts run in
turns, the order reversed every round (A B C, C B A, ...), so drift on the
card shows. The last line is a JSON object with every time and whether all
outputs agree bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
B, REPS = 4096, 50


def ant_states(init_qpos: np.ndarray, seed: int):
    rng = np.random.RandomState(seed)
    qpos = np.tile(init_qpos[None], (B, 1)).astype(np.float32)
    qpos[:, :2] += rng.uniform(-1, 1, (B, 2))
    qpos[:, 2] = rng.uniform(0.3, 0.8, B)
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (B, 8))
    qvel = rng.uniform(-1, 1, (B, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    return tuple(torch.tensor(a, device="cuda") for a in (qpos, qvel, ctrl))


def worker() -> dict:
    """Time the kernel of the checkout this process imports."""
    from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
    from ddiffpg_tpu_torch.physics.substep_cuda import SubstepKernel

    model = AntMazeEnv(random_init=True, device="cpu").model
    kern = SubstepKernel(model)
    args = ant_states(np.asarray(model.init_qpos), 0)
    out = kern(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        kern(*args)
    end.record()
    torch.cuda.synchronize()
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]
    return {"ms": start.elapsed_time(end) / REPS, "digest": digest}


def run_in(checkout: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    res = subprocess.run([sys.executable, __file__, "--worker"],
                         cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_substep: no CUDA card", file=sys.stderr)
        return 1
    if a.worker:
        print(json.dumps(worker()))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    checkouts = [p.resolve() for p in a.others] + [HERE]
    ms = {str(p): [] for p in checkouts}
    digests = set()
    for r in range(a.rounds):
        for p in checkouts if r % 2 == 0 else checkouts[::-1]:
            got = run_in(p)
            ms[str(p)].append(got["ms"])
            digests.add(got["digest"])
            print(f"[round {r}] {p}: {got['ms']:.4f} ms per launch, output "
                  f"{got['digest']} [{smi}]", flush=True)
    print(json.dumps({"ms": ms, "bitwise_equal": len(digests) == 1,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
