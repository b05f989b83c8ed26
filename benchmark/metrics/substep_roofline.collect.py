"""The substep kernel's share of its roofline, in %: the frozen bound of
one launch at the cell's env count (`benchmark/harness/substep_bound.py`,
from the configuration's `substep` counts) over the kernel's device time a
launch in the profiled window (activities named `substep_kernel*`)."""

from benchmark.harness.substep_bound import bound_ms


def read(rec):
    k = [v for name, v in rec.get("profile", {}).get("kernels", {}).items()
         if name.startswith("substep_kernel")]
    secs, count = sum(v[0] for v in k), sum(v[1] for v in k)
    if not count or not secs:
        return None
    bound, _ = bound_ms(rec["config"]["substep"], rec["traffic"]["num_envs"])
    return 100.0 * bound / (secs / count * 1e3)
