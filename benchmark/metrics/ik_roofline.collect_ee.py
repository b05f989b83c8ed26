"""The IK's share of its roofline, in %: the frozen bound of one control
step's IK at the cell's env count (`benchmark/harness/ik_bound.py`, from
the configuration's `ik` count) over the device ms a control step of the
span `ik` in the span window (`ik_device_ms.collect_ee`'s reading)."""

from benchmark.harness.ik_bound import bound_ms
from benchmark.harness.spans import per


def read(rec):
    ms = per(rec, "ik", "device_s", "collect_step", scale=1e3)
    if not ms:
        return None
    bound, _ = bound_ms(rec["config"]["ik"], rec["traffic"]["num_envs"])
    return 100.0 * bound / ms
