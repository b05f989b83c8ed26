#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the NVIDIA card(s) of this
machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets the cell up from the seed (the
program's env and agent, weights made on the card, the cell's traffic),
warms up every shape the cell uses, measures for --seconds, checks what
the timed path produced against the plain reference under
`benchmark/reference/`, and prints on standard error the host's load and
clocks, the window's units and, last, the numbers compared beside their
limits, and as the last line of standard output one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device` (with --trace 1 also `busy_s` and `window_s`), with --trace 1
`breakdown`, and last `compared`. It exits non-zero and prints no result
when there is no CUDA card, or fewer than the cell asks for, when the
program cannot be imported, or when JAX, jaxlib, flax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else
    now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def host_state() -> str:
    """The host's load averages and its cores' clocks (min / mean / max
    MHz), as Linux reports them; empty where it does not."""
    try:
        load = " ".join(Path("/proc/loadavg").read_text().split()[:4])
        mhz = [float(line.split(":")[1]) for line in
               Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return ""
    clock = (f" cpu MHz {min(mhz):.0f} / {statistics.fmean(mhz):.0f} / "
             f"{max(mhz):.0f}") if mhz else ""
    return f"load {load}{clock}"


def main(argv=None) -> int:
    t_start = process_start()
    host_before = host_state()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import caches
    caches.pin(ROOT)
    import torch
    torch.set_num_threads(1)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl[0]["chips"]:
        print(f"{args.workload} needs {wl[0]['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness import cell

    try:
        out = cell.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start)
    except cell.BannedImport as e:
        print(f"loaded in the process that would print the result: {e}",
              file=sys.stderr)
        return 3
    w = out["record"]["window"]
    print(f"host: at the start {host_before}; at the end {host_state()}",
          file=sys.stderr)
    print(f"window: {w['units']} units in {w['seconds']:.3f} s; a unit's "
          f"host s min / median / max {min(w['unit_s']):.4f} / "
          f"{statistics.median(w['unit_s']):.4f} / {max(w['unit_s']):.4f}",
          file=sys.stderr)
    for r in out["compared"]:
        print(f"compared {r['name']} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
