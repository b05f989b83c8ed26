"""The collect step's share of the card's float32 peak, in %: the actor's
K-step denoise FLOPs an env step (`benchmark/harness/flops.py`, from the
configuration's widths) times the window's env steps, over the window's
seconds, against 67 TFLOP/s."""

from benchmark.harness import flops
from benchmark.harness.peaks import PEAK_FP32_FLOPS


def read(rec):
    win = rec["window"]
    if not win.get("env_steps"):
        return None
    f = flops.act_flops(rec["config"]["widths"]) * win["env_steps"]
    return 100.0 * f / win["seconds"] / PEAK_FP32_FLOPS
