"""On the card, at the cells' own widths and env counts (a shorter
window): the program reads within every limit, and the control (the
reference one precision down: TF32 products, a bfloat16 physics state)
and, in the train cell, the half-batch fault do not. `benchmark/
calibrate.py` reads the same over many seeds at the cells' own window."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fails(rows) -> bool:
    return any(not r["value"] <= r["limit"] for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name,candidates", [
    ("ddiffpg-antmaze-v1.collect", ("control",)),
    ("ddiffpg-drawermulti-joints.collect", ("control",)),
    ("ddiffpg-antmaze-v1.train", ("control", "half_batch"))])
def test_control_is_not_correct(card, name, candidates):
    from benchmark.harness import cell

    out = cell.run(name, 20251017, 2.0, False, "cuda",
                   candidates=candidates)
    assert out["result"]["correct"], out["compared"]
    for c in candidates:
        assert _fails(out["candidates"][c]), (c, out["candidates"][c])
