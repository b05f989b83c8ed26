"""Device ms an update pass: the union of the device activities launched
inside the span `update_pass` (`AgentDDiffPG.update_once`), found by
their launches' correlation ids in the span window
(`benchmark/harness/spans.py`), over the passes in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "update_pass", "device_s", scale=1e3)
