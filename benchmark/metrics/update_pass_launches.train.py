"""Kernel launch calls of the CUDA runtime an update pass: those made
inside the span `update_pass` in the span window
(`benchmark/harness/spans.py`), over the passes in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "update_pass", "launches")
