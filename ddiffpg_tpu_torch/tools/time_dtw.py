"""Time the CUDA DTW kernel of several checkouts in turns on one card.

    python3 -m ddiffpg_tpu_torch.tools.time_dtw [DIR ...] [--rounds N]

Each DIR is another checkout of this repository, for example the parent
commit unpacked with `git archive`; this checkout runs beside them. Every
variant runs in a process of its own (a process imports one copy of the
package), which builds and loads that checkout's `csrc/dtw.cu` and times
it on two inputs, the same for every checkout (made here once and handed
to each process in a file under `build/`):

- `phase10a`: `chip_smoke.py`'s phase 10a, 4,104 pairs of antmaze-like
  tracks of 300-500 points (Dx 2), stacked to 500, with the edge pairs;
- `recluster_chunk`: one stock recluster chunk, 16,777 pairs
  (`DTW_CHUNK_CELLS // 500`) of 1,000 success tracks of 300-500 points on
  the two routes, in the order the ClusterManager lists new pairs.

Each reports the mean time of one launch over 20 launches timed with CUDA
events after 20 launches of warm-up, and a digest of its output. The
variants run in turns, the order reversed every round (A B, B A, ...), so
drift on the card shows. The last line is a JSON object with every time
and, per input, whether all outputs agree bit for bit.
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
REPS = 20
CASES = ("phase10a", "recluster_chunk")


def make_inputs(path: Path):
    """Write both inputs (CPU tensors) to `path`."""
    sys.path.insert(0, str(HERE))
    import chip_smoke

    cases = {"phase10a": chip_smoke.dtw_inputs(5, 640, chip_smoke.DTW_PAIRS,
                                               device="cpu")}
    rng = np.random.RandomState(7)
    n, L = 1000, 500
    lens = rng.randint(300, L + 1, n).astype(np.int32)
    stack = np.zeros((n, L, 2), np.float32)
    for k, m in enumerate(lens):
        stack[k, :m] = chip_smoke.route_track(rng, m, (4.0, -4.0)[k % 2])[:m]
    P = (1 << 23) // L
    a, b = np.triu_indices(n, 1)
    ia, ib = a[:P].astype(np.int32), b[:P].astype(np.int32)
    cases["recluster_chunk"] = tuple(torch.tensor(x) for x in (
        stack, stack, lens, lens, ia, ib))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(cases, path)


def worker(inputs: Path) -> dict:
    """Time the DTW kernel of the checkout this process imports."""
    from ddiffpg_tpu_torch.ops import dtw_cuda

    kern = dtw_cuda.get_kernel("cuda")
    cases = torch.load(inputs)
    out = {}
    for name in CASES:
        args = [t.cuda() for t in cases[name]]
        res = kern(*args)
        for _ in range(REPS):   # warm-up
            kern(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            kern(*args)
        end.record()
        torch.cuda.synchronize()
        digest = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]
        out[name] = {"ms": start.elapsed_time(end) / REPS, "digest": digest,
                     "pairs": int(args[4].numel())}
    return out


def run_in(checkout: Path, inputs: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    cmd = [sys.executable, __file__, "--worker", "--inputs", str(inputs)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{checkout} failed:\n" + res.stderr[-4000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--inputs", type=Path,
                    default=HERE / "build" / "time_dtw_inputs.pt")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_dtw: no CUDA card", file=sys.stderr)
        return 1
    if a.worker:
        print(json.dumps(worker(a.inputs)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    make_inputs(a.inputs)
    variants = [p.resolve() for p in a.others] + [HERE]
    ms = {str(v): {c: [] for c in CASES} for v in variants}
    digests = {c: set() for c in CASES}
    for r in range(a.rounds):
        for v in variants if r % 2 == 0 else variants[::-1]:
            got = run_in(v, a.inputs)
            for c in CASES:
                ms[str(v)][c].append(got[c]["ms"])
                digests[c].add(got[c]["digest"])
            print(f"[round {r}] {v}: " + ", ".join(
                f"{c} ({got[c]['pairs']} pairs) {got[c]['ms']:.4f} ms "
                f"(output {got[c]['digest']})" for c in CASES)
                + f" [{smi}]", flush=True)
    print(json.dumps({"ms": ms, "bitwise_equal": {
        c: len(d) == 1 for c, d in digests.items()}, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
