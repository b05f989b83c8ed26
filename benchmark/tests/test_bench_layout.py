"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, driver and metric readers by name; names and
units keep to the contract's characters; run.py refuses a machine without
a card and a checkout without the program, printing no result."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_finds_its_files():
    from benchmark.harness import cell

    layers = {}
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").exists()
        assert hasattr(cell.reader(m["name"]), "read")
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        wl, config, traffic = cell.load_cell(BENCH, w["name"])
        assert (ROOT / "benchmark/drivers" / f"{traffic['kind']}.py").exists()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        metrics = [m for m in BENCH["per_layer"] if cell.applies(m, w["name"])]
        e2e = [m for m in BENCH["end_to_end"] if cell.applies(m, w["name"])]
        assert metrics and len(e2e) >= 2
        assert {m["moves"] for m in metrics} <= {m["name"] for m in e2e}


def test_readers_find_nothing_in_an_empty_record():
    from benchmark.harness import cell

    rec = {"window": {}, "config": {}, "traffic": {"num_envs": 1}}
    for m in BENCH["per_layer"]:
        assert cell.reader(m["name"]).read(rec) is None, m["name"]


def _run(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "4294967301",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
