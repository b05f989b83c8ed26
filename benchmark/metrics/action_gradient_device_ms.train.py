"""Device ms of an update pass's action gradient: the union of the device
activities launched inside the span `action gradient` (the action
gradient on the updated critics and the target-action scatter), by
correlation id, in the span window (`benchmark/harness/spans.py`), over
the passes in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "action gradient", "device_s", scale=1e3)
