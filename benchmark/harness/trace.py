"""The device trace of a traced run, reduced to the numbers the per-layer
readers and the result line take.

`profiled(fn, n)` runs fn() n times under torch.profiler (CPU and CUDA
activities), inside a record_function range that marks the window, and
returns:
  window_s   the window's length on the host clock of the trace
  busy_s     the union of the device activities' intervals in the window
  kernels    {name: [seconds, count]} of the device activities
  device_ops the ten device activities that took most time, [name, s]
  idle_gaps  the device's idle time in the window, grouped by the
             innermost host operation running at each gap's middle (an
             aten op, else a runtime call, else "host"; gaps under 5 us
             together), the ten largest
The trace stays in memory; nothing is written to disk.

`DeviceMeter` sums the device's busy time over a whole window, one short
profiler session (device activities only) a unit of work.
"""

from __future__ import annotations

import bisect
import time

import torch

WINDOW = "bench_window"
SHORT_US = 5.0
SHORT = "gaps under 5 us"
NAME_LEN = 120               # names in the breakdown are cut to this


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def profiled(fn, n: int, device: torch.device) -> dict:
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(n):
                fn()
            sync()
    t0 = time.perf_counter()
    out = reduce(prof.events())
    out["reduce_s"] = time.perf_counter() - t0
    return out


class DeviceMeter:
    """The device's busy seconds over the work run inside `with meter:`
    blocks: each block is one torch.profiler session with the CUDA
    activities alone (no host ranges), the block's work synchronized
    before it stops; the union of the device activities' intervals of
    every block is summed into `busy_s`. Sessions are short (one unit of
    work) so the profiler's buffers never fill. `warm()` runs the
    profiler's first, slow start-up in set-up."""

    def __init__(self, device: torch.device):
        self.device = device
        self.busy_s = 0.0
        self.activities = 0
        self._prof = None

    def warm(self):
        with self:
            torch.zeros(1, device=self.device).add_(1)
        self.busy_s, self.activities = 0.0, 0

    def __enter__(self):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        spans = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s = e.start_ns()
                spans.append((s, s + e.duration_ns()))
        self._prof = None
        spans.sort()
        busy, cur_s, cur_e = 0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s += busy / 1e9
        self.activities += len(spans)
        return False


def reduce(events) -> dict:
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    kernels = {}
    for e in events:
        tr = e.time_range
        if _is_device(e):
            # the window's own range is mirrored on the device timeline
            if e.name == WINDOW or tr.end <= w0 or tr.start >= w1:
                continue
            dev.append((max(tr.start, w0), min(tr.end, w1)))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (tr.end - tr.start) / 1e6
            k[1] += 1
        elif e.name != WINDOW and tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last = w0
    for s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = max(last, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last:
        gaps.append((last, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_US:
            idle[SHORT] = idle.get(SHORT, 0.0) + (g1 - g0) / 1e6
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name, best = "host", None
        # the latest-starting range that still covers the middle is the
        # innermost (ranges of one thread nest); prefer aten ops
        for j in range(i, max(i - 400, -1), -1):
            s, e, nm = host[j]
            if e >= mid:
                rank = 0 if nm.startswith("aten::") else 1
                if best is None or rank < best:
                    name, best = nm, rank
                    if rank == 0:
                        break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernels": {k: v for k, v in kernels.items()},
            "device_ops": [[k[:NAME_LEN], v[0]] for k, v in top[:10]],
            "idle_gaps": sorted(([k[:NAME_LEN], v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10],
            "device_activities": len(dev)}
