"""The cell `ddiffpg-drawermulti-ee.collect` (PandaDrawerMulti-v3, the
`ee` control's DLS IK): on the CPU at tiny sizes the harness's whole run
agrees with the plain reference to the bit, and with the program's
`Arm.dls_ik` cut to 2 iterations it comes out not correct; the frozen IK
count in the configuration's file is counted again. On the card, at the
cell's own widths and env count (a shorter window), the program reads
within every limit while the 2-iteration fault and the control (the
reference one precision down: TF32 products, a bfloat16 physics state)
do not."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELL = "ddiffpg-drawermulti-ee.collect"
TINY = {"traffic": {"num_envs": 4, "steps_per_call": 2, "probe_calls": 1,
                    "checked_calls": 1, "warmup_calls": 0}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def two_ik_iterations(monkeypatch):
    from ddiffpg_tpu_torch.physics import panda

    dls_ik = panda.Arm.dls_ik

    def cut(self, qpos, target, iters=3, damping=0.05):
        return dls_ik(self, qpos, target, 2, damping)

    monkeypatch.setattr(panda.Arm, "dls_ik", cut)


def _tiny(seed=12345678901):
    from benchmark.harness import cell
    return cell.run(CELL, seed, 0.01, False, "cpu", overrides=TINY)


def _fails(rows) -> bool:
    return any(not r["value"] <= r["limit"] for r in rows)


def test_tiny_cell_matches_the_reference():
    out = _tiny()
    assert out["result"]["correct"]
    assert out["record"]["config"]["config"]["env"]["control_type"] == "ee"
    assert all(r["value"] == 0 for r in out["compared"]), out["compared"]


def test_tiny_cell_with_two_ik_iterations(two_ik_iterations):
    out = _tiny()
    rows = {r["name"]: r for r in out["compared"]}
    assert not out["result"]["correct"]
    assert rows["obs_gap"]["value"] > rows["obs_gap"]["limit"], rows


def test_ik_count_is_frozen():
    from benchmark.harness import ik_bound
    from benchmark.reference import follow

    f = json.loads((ROOT / "benchmark/configs/ddiffpg-drawermulti-ee.json")
                   .read_text())
    cfg = follow.config(f["config"], 1, 0)
    env = follow.make_env(cfg, 1, "cpu", 0).env
    assert env.control_type == "ee"
    assert ik_bound.count_ik_ops(env) == f["ik"]["ops_per_env"]
    assert ik_bound.count_ik_ops(env, B=16, seed=3) == f["ik"]["ops_per_env"]
    assert f["ik"]["nq"] == env.model.nq
    assert f["ik"]["iters"] == 3
    bound, by = ik_bound.bound_ms(f["ik"], 4096)
    assert by == "operations" and 0 < bound < 1e-2


@pytest.mark.cuda
def test_card_program_correct_control_not(card):
    from benchmark.harness import cell

    out = cell.run(CELL, 20251017, 2.0, False, "cuda",
                   candidates=("control",))
    assert out["result"]["correct"], out["compared"]
    assert _fails(out["candidates"]["control"]), out["candidates"]


@pytest.mark.cuda
def test_card_two_ik_iterations_not_correct(card, two_ik_iterations):
    from benchmark.harness import cell

    out = cell.run(CELL, 20251018, 2.0, False, "cuda")
    assert not out["result"]["correct"], out["compared"]
    assert _fails(out["compared"])
