"""Host ms of the actor (`agents/ddiffpg.py:explore_actions`: mode
embeddings, the K-step denoise, the exploration noise) a call, with a
synchronize around it: the median over the calls timed after the
window."""

import statistics


def read(rec):
    v = rec.get("host_ms", {}).get("actor")
    return statistics.median(v) if v else None
