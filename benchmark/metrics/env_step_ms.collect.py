"""Host ms of the env step (`env.step`: the substep kernel, reward, done,
auto-reset; on Panda the ee state through `physics/engine.py:Kinematics`)
a call, with a synchronize around it: the median over the calls timed
after the window."""

import statistics


def read(rec):
    v = rec.get("host_ms", {}).get("env_step")
    return statistics.median(v) if v else None
