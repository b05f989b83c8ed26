"""Host ms of an update pass's action gradient (`agents/base.py:
action_gradient` on `models/mlp.py:q_min`, with the target-action scatter):
the "action gradient" part of the passes timed after the window."""

import statistics


def read(rec):
    v = rec.get("host_ms", {}).get("action_gradient")
    return statistics.median(v) if v else None
