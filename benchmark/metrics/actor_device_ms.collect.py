"""Device ms a control step of the actor (the span `actor`,
`explore_actions`: the mode embedding, the K-step denoise, the
exploration noise), by correlation id, in the span window
(`benchmark/harness/spans.py`), over the control steps (spans
`collect_step`) in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "actor", "device_s", "collect_step", scale=1e3)
