"""Archive a finished training run's durable evidence into git.

Workspaces are wiped between rounds (only git-tracked files survive), so
every finished run's metrics must be committed or the learning evidence
evaporates. This copies the small, judge-relevant artifacts of
runs/<name>/ into runs_archive/<name>/:

  - metrics.jsonl  -> metrics.jsonl.gz   (the full training curve)
  - config.json    -> config.json        (exact reproduction recipe)
  - *.png          -> kept only for the final eval step (cluster/traj
                      plots; earlier cadence plots are dropped to keep
                      the repo small)

Checkpoints are NOT archived (tens of MB, and reproducible from the
config + seed).

Usage: python -m ddiffpg_tpu_torch.tools.archive_run runs/antmaze_v3_r3 \
    [more runs...]

Copy of the root `tools/archive_run.py`, for the port's runs (whose plots
have the same names). `REPO` is the repository's root, two levels above
this package's `tools/`; a caller that must not write into the repository
points it elsewhere.
"""
import gzip
import json
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def archive(run_dir: Path) -> Path:
    dst = REPO / "runs_archive" / run_dir.name
    dst.mkdir(parents=True, exist_ok=True)

    metrics = run_dir / "metrics.jsonl"
    if metrics.exists():
        with open(metrics, "rb") as f_in, \
                gzip.open(dst / "metrics.jsonl.gz", "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)

    cfg = run_dir / "config.json"
    if cfg.exists():
        shutil.copy(cfg, dst / "config.json")

    # keep only the latest-step instance of each plot family
    families = {}
    for png in run_dir.glob("*.png"):
        m = re.match(r"(.+?)_(\d+)\.png$", png.name)
        key, step = (m.group(1), int(m.group(2))) if m else (png.name, -1)
        if key not in families or step > families[key][0]:
            families[key] = (step, png)
    for _, png in families.values():
        shutil.copy(png, dst / png.name)

    # one-line summary for the archive index
    last = {}
    if metrics.exists():
        with open(metrics) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                last.update(row)
    summary = {k: v for k, v in last.items()
               if k.startswith("eval/") or k in ("step", "wall_s")}
    (dst / "final_metrics.json").write_text(
        json.dumps(summary, indent=1, sort_keys=True) + "\n")
    return dst


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        p = Path(arg)
        if not p.is_dir():
            print(f"skip {arg}: not a directory")
            continue
        out = archive(p)
        size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
        print(f"archived {p} -> {out} ({size/1e6:.2f} MB)")
