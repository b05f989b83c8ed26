"""Rerun an archived JAX run with the port, and read the two eval curves.

    python -m ddiffpg_tpu_torch.tools.rerun_archive overrides \\
        runs_archive/dipo_v1_r5/config.json
    python -m ddiffpg_tpu_torch.tools.rerun_archive curve \\
        <run>/metrics.jsonl runs_archive/dipo_v1_r5/metrics.jsonl.gz

`overrides` prints the archive's `config.json` as the entry point's dotted
`key=value` overrides (`algo=<name>` first), leaving out `max_time`,
`device`, `logdir`, `run_name` and `use_wandb`. `curve` prints each eval of the port's run (env steps,
success rate, return) beside the archive's eval nearest in steps, then the
first success and the best rate of each, and the count, median, min and
max of each of the port run's `time/*` costs. Plain JSON only: no JAX
needed.
"""

from __future__ import annotations

import argparse
import gzip
import json
import statistics

DROP = ("max_time", "device", "logdir", "run_name", "use_wandb")


def flatten(cfg: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def overrides(config: dict) -> list:
    flat = flatten(config)
    args = [f"algo={flat.pop('algo.name').lower()}"]
    for k, v in flat.items():
        if k.split(".")[-1] in DROP or k in DROP:
            continue
        args.append(f"{k}={'null' if v is None else v}")
    return args


def evals(path: str) -> list:
    """(steps, success rate, return) of every eval record of a
    metrics.jsonl (gzipped when the name ends in .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    out = []
    with opener(path, "rt") as f:
        for line in f:
            r = json.loads(line)
            if "eval/success_rate" in r:
                out.append((int(r.get("step", r.get("global_steps", 0))),
                            float(r["eval/success_rate"]),
                            float(r["eval/return"])))
    return out


def costs(path: str) -> dict:
    """Every `time/*` value of a metrics.jsonl, by key."""
    out = {}
    with open(path) as f:
        for line in f:
            for k, v in json.loads(line).items():
                if k.startswith("time/"):
                    out.setdefault(k, []).append(float(v))
    return out


def summary(curve: list) -> str:
    hit = next((s for s, rate, _ in curve if rate > 0), None)
    best = max(curve, key=lambda e: e[1]) if curve else None
    return (f"{len(curve)} evals to {curve[-1][0] if curve else 0} steps; "
            f"first success {hit}; best {best[1] if best else None} at "
            f"{best[0] if best else None}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    o = sub.add_parser("overrides")
    o.add_argument("config")
    c = sub.add_parser("curve")
    c.add_argument("run")
    c.add_argument("archive")
    args = ap.parse_args(argv)
    if args.cmd == "overrides":
        with open(args.config) as f:
            print(" ".join(overrides(json.load(f))))
        return
    run, arch = evals(args.run), evals(args.archive)
    print("steps  port_success  port_return  archive_steps  "
          "archive_success  archive_return")
    for s, rate, ret in run:
        a = min(arch, key=lambda e: abs(e[0] - s)) if arch else (0, 0, 0)
        print(f"{s} {rate} {ret} {a[0]} {a[1]} {a[2]}")
    print(f"port: {summary(run)}")
    print(f"archive: {summary(arch)}")
    for k, v in sorted(costs(args.run).items()):
        print(f"{k}: n {len(v)}, median {statistics.median(v)}, min "
              f"{min(v)}, max {max(v)}")


if __name__ == "__main__":
    main()
