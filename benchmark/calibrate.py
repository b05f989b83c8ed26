#!/usr/bin/env python3
"""Readings from which the limits of `correct` are set, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        --seconds 3 [--candidates control half_batch]

For each seed: one run of the cell on the card as `run.py` makes it (a
short window), the program's gaps against the reference, and the gaps of
each candidate run in the program's place (`control`: the reference one
precision down; `half_batch`: a train cell's reference with that fault).
Prints one JSON line a seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--candidates", nargs="*", default=["control"])
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path[0] = str(ROOT)
    from benchmark.harness import caches
    caches.pin(ROOT)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import cell

    for seed in args.seeds:
        out = cell.run(args.workload, seed, args.seconds, False, "cuda",
                       candidates=args.candidates)
        res = out["result"]
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"], "failed": res["failed"],
                "program": {r["name"]: r["value"] for r in out["compared"]},
                **{c: {r["name"]: r["value"] for r in rows}
                   for c, rows in out["candidates"].items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
