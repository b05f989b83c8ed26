"""The train step's share of the card's float32 peak, in %: the model
FLOPs of a training iteration at the cell's live groups
(`benchmark/harness/flops.py`, from the configuration's widths) times the
window's iterations, over the window's seconds, against 67 TFLOP/s."""

from benchmark.harness import flops
from benchmark.harness.peaks import PEAK_FP32_FLOPS


def read(rec):
    win, cfg = rec["window"], rec["config"]
    if not win.get("units") or "groups" not in rec:
        return None
    f = flops.train_iter_flops(cfg["widths"], cfg["config"],
                               rec["traffic"]["num_envs"], rec["groups"])
    return 100.0 * f * win["units"] / win["seconds"] / PEAK_FP32_FLOPS
