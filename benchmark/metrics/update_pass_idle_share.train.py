"""The device's idle share while the host is inside an update pass, in %:
the idle time under the span `update_pass` over the span's host wall
time, in the span window (`benchmark/harness/spans.py`)."""

from benchmark.harness.spans import per


def read(rec):
    idle, wall = per(rec, "update_pass", "idle_s"), \
        per(rec, "update_pass", "wall_s")
    return 100.0 * idle / wall if idle is not None and wall else None
