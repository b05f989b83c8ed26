"""One run of one cell.

The cell's entry in BENCHMARK.json names its configuration file; its
traffic file is `benchmark/traffic/<cell>.json`, whose `kind` names the
window driver `benchmark/drivers/<kind>.py`; each per-layer metric's
reader is `benchmark/metrics/<metric>.py`. A driver has `setup(ctx)`,
`window(ctx, st, seconds, meter)`, `probes(ctx, st)`, `unit(ctx, st)`,
`outputs(ctx, st)` and `check(ctx, outputs, candidate)`.

The order of a run: set-up (everything before the window, counted in
`setup_s` from the process's start); the window (in an untraced run of a
cell with an end-to-end metric of the device trace, each unit of work in
its own device-only profile: `trace.DeviceMeter`); with `trace`, the probes
and a profiled window of `profiled_units` units of work; the memory peak;
the program's state freed; the reference and the comparison.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark.harness import compare, trace as trace_mod
from benchmark.harness.seeds import sub_seed

ROOT = Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "ddiffpg_tpu")


@dataclass
class Ctx:
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device

    def sub(self, tag: str) -> int:
        return sub_seed(self.seed, tag)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(bench: dict, name: str, overrides: dict | None = None):
    """(workload entry, configuration file, traffic file) of cell `name`,
    with test overrides {"config": {...}, "traffic": {...}} merged in."""
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{name}.json").read_text())
    over = overrides or {}
    return (wl, merge(config, over.get("config", {})),
            merge(traffic, over.get("traffic", {})))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_loaded() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].split(",")[-1].strip() if out else None


class BannedImport(RuntimeError):
    pass


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        overrides: dict | None = None, candidates=()) -> dict:
    """One run of cell `name`. Returns {"result": the result line,
    "compared": the gaps, "candidates": {candidate: gaps}}."""
    t_start = time.time() if t_start is None else t_start
    bench = load_bench()
    wl, config, traffic = load_cell(bench, name, overrides)
    dev = torch.device(device)
    ctx = Ctx(bench, wl, config, traffic, int(seed), dev)
    drv = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()

    st = drv.setup(ctx)
    # an end-to-end metric of the device trace: the untraced run's window
    # is metered, one short device-only profile a unit of work
    meter = None
    if not trace and dev.type == "cuda" and any(
            m["source"] == "device_trace" for m in bench["end_to_end"]
            if applies(m, name)):
        meter = trace_mod.DeviceMeter(dev)
        meter.warm()
    # the set-up's garbage collected, its objects out of the collector's
    # way in the window
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    win = drv.window(ctx, st, seconds, meter)
    rec = {"config": config, "traffic": traffic, "window": win}
    if trace:
        rec.update(drv.probes(ctx, st))
        rec["profile"] = trace_mod.profiled(drv.unit(ctx, st),
                                            traffic["profiled_units"], dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = banned_loaded()
    if found:
        raise BannedImport(", ".join(found))

    out = drv.outputs(ctx, st)
    del st
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = drv.check(ctx, out, "program")
    extra = {c: drv.check(ctx, out, c) for c in candidates}

    e2e = {}
    for m in bench["end_to_end"]:
        if trace or not applies(m, name):
            continue          # a traced run prints its per-layer metrics
        v = setup_s if m["name"] == "setup_s" else win["e2e"].get(m["name"])
        if v is None and m["source"] == "device_trace" and dev.type != "cuda":
            continue          # no device to trace: the CPU tests
        if v is None:
            raise RuntimeError(f"the {traffic['kind']} driver gives no "
                               f"{m['name']}")
        e2e[m["name"]] = {"value": v, "unit": m["unit"]}
    metrics = e2e
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, name):
                v = reader(m["name"]).read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = compare.passed(compared) and win["failed"] == 0
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": wl["chips"] if dev.type == "cuda" else 0,
                  "memory_peak_bytes": int(peak),
                  "power_limit": power_limit() if dev.type == "cuda"
                  else None}
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_rec}
    if trace:
        prof = rec["profile"]
        device_rec["busy_s"] = prof["busy_s"]
        device_rec["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    found = banned_loaded()
    if found:
        raise BannedImport(", ".join(found))
    result["compared"] = {r["name"]: {"value": r["value"],
                                      "limit": r["limit"]}
                          for r in compared}
    return {"result": result, "compared": compared, "candidates": extra,
            "record": rec}
