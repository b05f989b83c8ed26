"""Kernel launch calls a control step of the Panda end-effector state
(the span `ee_state`), in the span window (`benchmark/harness/spans.py`),
over the control steps (spans `collect_step`) in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "ee_state", "launches", "collect_step")
