#!/usr/bin/env python
"""One-line status of a (possibly running) training run's metrics.jsonl.

Usage: python -m ddiffpg_tpu_torch.tools.run_status runs/antmaze_v2_r4b \
    [runs/...]

Copy of the root `tools/run_status.py`, for the port's runs (whose
metrics.jsonl has the same keys).

Prints the last train row's step/sps/coverage/num_groups and the last eval
row's overall + per-goal success, plus the latest recluster goal counts —
the exact signals that decide the antmaze-v2 far-goal outcome.
"""
import json
import sys
from pathlib import Path


def status(run_dir: Path) -> None:
    m = run_dir / "metrics.jsonl"
    if not m.exists():
        print(f"{run_dir.name}: no metrics yet")
        return
    last_train, last_eval = None, None
    evals = 0
    goal_keys = set()
    with open(m) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "eval/success_rate" in r:
                last_eval = r
                evals += 1
                goal_keys |= {k for k in r if k.startswith("eval/success_goal")}
            elif "train/return" in r:
                last_train = r
    out = [run_dir.name]
    if last_train:
        out.append(f"step={last_train['step']:,} wall={last_train['wall']:.0f}s")
        for k, lbl in (("train/state_coverage", "cov"),
                       ("train/num_groups", "G"),
                       ("train/p", "p"),
                       ("train/frontier_dist", "fdist"),
                       ("train/frontier_depth", "fdepth"),
                       ("train/env_steps_per_sec", "sps")):
            if k in last_train:
                v = last_train[k]
                out.append(f"{lbl}={v:,.3f}" if isinstance(v, float) else f"{lbl}={v}")
    if last_eval:
        out.append(f"| eval#{evals} succ={last_eval['eval/success_rate']:.2f}")
        for k in sorted(goal_keys):
            out.append(f"{k.split('/')[-1]}={last_eval.get(k, 0):.2f}")
    print(" ".join(out))


if __name__ == "__main__":
    for d in sys.argv[1:]:
        status(Path(d))
