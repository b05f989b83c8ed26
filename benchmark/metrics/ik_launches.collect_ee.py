"""Kernel launch calls a control step of the Panda `ee` control's IK (the
span `ik`), in the span window (`benchmark/harness/spans.py`), over the
control steps (spans `collect_step`) in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "ik", "launches", "collect_step")
