"""The device's idle share of the profiled window, in %: 1 - the union of
the device activities' intervals (torch.profiler) over the window."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
