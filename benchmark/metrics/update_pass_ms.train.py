"""Host ms of one update pass (`AgentDDiffPG.update_once`): the median of
the passes timed after the window through its `mark` hook, a synchronize
at each part's end."""

import statistics


def read(rec):
    v = rec.get("host_ms", {}).get("update_pass")
    return statistics.median(v) if v else None
