"""The port's layer spans, read in a profiled window of their own.

`window(rec)`, which the span readers call first, makes the window once a
traced run and keeps it in `rec["spans"]`: the run's own state is freed
by the time the readers run, so `span_window` sets the cell's driver up
afresh from the record's configuration and traffic (seed `SEED`: the
run's is not in the record), then `profiled_spans(fn, n, device)` runs
the driver's unit
of work `traffic["profiled_units"]` times under a torch.profiler session
(CPU and CUDA activities) with the port's spans
(`ddiffpg_tpu_torch/utils/trace.py`, ranges named `ddiffpg/<span>`)
enabled, and disabled again in a `finally`; it prints `idle_spans` on
standard error. The run's own windows never enable the spans. `reduce`
turns the trace into, for each span name:
  n         its instances in the window
  wall_s    host seconds inside them
  device_s  the union of the device activities (kernels, copies, sets)
            launched inside them: an activity is found by its runtime
            call's correlation id, not by time overlap, so work that runs
            after its span has closed still counts to it; an activity the
            runtime recorded no call for (cuBLAS launches its CUTLASS
            kernels through the driver) by the host op it is linked to
  launches  kernel launch calls of the CUDA runtime, and the activities
            found through their host op (one launch each)
  syncs     blocking runtime calls (`SYNCS`), and `sync_s` their host
            seconds
  idle_s    the device's idle seconds while the host was inside them
A runtime call counts to every span open around it, by host time (on
any host thread: the autograd engine launches the backward ops from a
thread of its own). `idle_spans`: the window's idle gaps grouped by the
innermost span at each gap's middle ("no span" outside every span), the
ten largest, [name, seconds]. `unattributed` counts the device activities
whose launch was not found. The spans' mirrors on the device timeline
(`gpu_user_annotation`, named as the span) are not device work and are
left out.

`window` gives None where the run's profiled window saw no device (a CPU
run) and for a program without the spans module (a checkout before it):
the readers then find nothing. The trace stays in memory. The readers'
shared arithmetic is `per`.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import re
import sys
import time
from typing import NamedTuple

import torch

from benchmark.harness.trace import WINDOW

PREFIX = "ddiffpg/"              # the port's `utils/trace.py:PREFIX`
SEED = 271828182845
NO_SPAN = "no span"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
LAUNCH = re.compile(r"^cuda(Launch\w*|GraphLaunch)$")


class Ev(NamedTuple):
    """One event of the trace: `device` on the device's timeline, else on
    the host's; `corr` the CUPTI correlation id that ties a runtime call to
    the device activity it launched (a host op has an id of its own, which
    may repeat one of those); `link` a device activity's host op."""
    name: str
    device: bool
    start: int          # ns
    end: int            # ns
    corr: int = 0
    link: int = 0


def _runtime(e: Ev) -> bool:
    return not e.device and e.name.startswith("cuda")


def _mirror(e: Ev) -> bool:
    return e.device and (e.name.startswith(PREFIX) or e.name == WINDOW)


def events(kineto_events) -> list:
    """The events `reduce` reads, from the profiler's Kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    return [Ev(k.name(), k.device_type() == cuda, k.start_ns(),
               k.start_ns() + k.duration_ns(), k.correlation_id(),
               k.linked_correlation_id()) for k in kineto_events]


def window(rec: dict) -> dict | None:
    if "spans" not in rec:
        rec["spans"] = _window(rec)
    return rec["spans"]


def _window(rec: dict) -> dict | None:
    prof = rec.get("profile")
    if not prof or not prof["busy_s"]:
        return None              # no device in the run
    if importlib.util.find_spec("ddiffpg_tpu_torch.utils.trace") is None:
        return None              # a program without the spans
    out = span_window(rec["config"], rec["traffic"], torch.device("cuda"))
    print(f"idle_spans: {json.dumps(out['idle_spans'])}; "
          f"{out['unattributed']} device activities with no launch found",
          file=sys.stderr)
    return out


def span_window(config: dict, traffic: dict, device: torch.device) -> dict:
    """The cell of `config` and `traffic` set up afresh on `device`, then
    its span window."""
    from benchmark.harness import cell

    ctx = cell.Ctx(cell.load_bench(), {}, config, traffic, SEED, device)
    drv = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    st = drv.setup(ctx)
    try:
        return profiled_spans(drv.unit(ctx, st), traffic["profiled_units"],
                              device)
    finally:
        del st
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def profiled_spans(fn, n: int, device: torch.device) -> dict:
    from ddiffpg_tpu_torch.utils import trace

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    sync()
    trace.enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(n):
                    fn()
                sync()
    finally:
        trace.enable(False)
    t0 = time.perf_counter()
    out = reduce(events(prof.profiler.kineto_results.events()))
    out["reduce_s"] = time.perf_counter() - t0
    return out


def _merge(iv: list) -> list:
    """Intervals [(start, end)] merged where they overlap, in order."""
    merged = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(evs: list) -> dict:
    win = [e for e in evs if e.name == WINDOW and not e.device]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0].start, win[0].end
    spans = sorted((e for e in evs if not e.device
                    and e.name.startswith(PREFIX)),
                   key=lambda e: (e.start, -e.end))
    parent, stack = [], []
    for i, sp in enumerate(spans):
        while stack and spans[stack[-1]].end < sp.end:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [sp.start for sp in spans]

    def chain(t):
        """The spans open at host time t, innermost first."""
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and spans[j].end < t:
            j = parent[j]
        out = []
        while j >= 0:
            out.append(j)
            j = parent[j]
        return out

    m = len(spans)
    launches, syncs, sync_ns = [0] * m, [0] * m, [0] * m
    dev_iv = [[] for _ in range(m)]
    launched_at = {}             # correlation id -> its call's start
    op_at = {}                   # a host op's id -> its start
    for e in evs:
        if e.device:
            continue
        if not _runtime(e):
            op_at[e.corr] = e.start
            continue
        launched_at[e.corr] = e.start
        is_launch = bool(LAUNCH.match(e.name))
        is_sync = e.name in SYNCS
        for j in chain(e.start):
            launches[j] += is_launch
            syncs[j] += is_sync
            sync_ns[j] += (e.end - e.start) if is_sync else 0

    busy_iv, unattributed = [], 0
    for e in evs:
        if not e.device or _mirror(e):
            continue
        if e.end > w0 and e.start < w1:
            busy_iv.append((max(e.start, w0), min(e.end, w1)))
        t = launched_at.get(e.corr)
        by_op = t is None
        if by_op:
            t = op_at.get(e.link)
        if t is None:
            unattributed += 1
            continue
        for j in chain(t):
            dev_iv[j].append((e.start, e.end))
            launches[j] += by_op

    # the device's busy intervals merged, with the busy time before each
    merged = _merge(busy_iv)
    m_starts = [s for s, _ in merged]
    before = [0]
    for s, e in merged:
        before.append(before[-1] + e - s)

    def busy_to(t):
        i = bisect.bisect_right(m_starts, t)
        if i == 0:
            return 0
        s, e = merged[i - 1]
        return before[i - 1] + min(t, e) - s

    by = {}
    for j, sp in enumerate(spans):
        r = by.setdefault(sp.name[len(PREFIX):], {
            "n": 0, "wall_s": 0.0, "device_s": 0.0, "launches": 0,
            "syncs": 0, "sync_s": 0.0, "idle_s": 0.0})
        wall = sp.end - sp.start
        r["n"] += 1
        r["wall_s"] += wall / 1e9
        r["device_s"] += sum(e - s for s, e in _merge(dev_iv[j])) / 1e9
        r["launches"] += launches[j]
        r["syncs"] += syncs[j]
        r["sync_s"] += sync_ns[j] / 1e9
        r["idle_s"] += (wall - (busy_to(sp.end) - busy_to(sp.start))) / 1e9

    idle, last = {}, w0
    for s, e in merged + [[w1, w1]]:
        if s > last:
            c = chain((last + s) / 2)
            name = spans[c[0]].name[len(PREFIX):] if c else NO_SPAN
            idle[name] = idle.get(name, 0.0) + (s - last) / 1e9
        last = max(last, e)
    return {"spans": by,
            "idle_spans": sorted(([k, v] for k, v in idle.items()),
                                 key=lambda kv: -kv[1])[:10],
            "window_s": (w1 - w0) / 1e9, "busy_s": before[-1] / 1e9,
            "unattributed": unattributed}


def per(rec: dict, span: str, key: str, per_span: str | None = None,
        scale: float = 1.0):
    """A reader's number from the span window (`window`): `key` of span
    `span` over the instances of `per_span` (default `span` itself), times
    `scale`; None where there is no window or it holds no such span."""
    by = (window(rec) or {}).get("spans", {})
    s, d = by.get(span), by.get(per_span or span)
    if not s or not d or not d["n"]:
        return None
    return scale * s[key] / d["n"]
