"""The span window's reduction (`benchmark/harness/spans.py`) on
hand-built traces: device work found by its launch's correlation id (a
kernel that runs after its span has closed included) or, with no runtime
call recorded, by its host op, blocking calls and
their seconds, device time as a union, the spans' device mirrors left
out, idle gaps by the innermost span; the readers on such a record; the
events of a CPU profiler session over the port's spans; the span window
of a tiny train and Panda cell set up afresh on the CPU; and a CPU traced
run, which reads its old metrics and none of the span window's (no
card)."""

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.spans import PREFIX, Ev, events, reduce, span_window
from benchmark.harness.trace import WINDOW
from benchmark.tests import tiny

US = 1000          # ns


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def host(name, s, e, corr=0):
    return Ev(name, False, s * US, e * US, corr)


def span(name, s, e):
    return Ev(PREFIX + name, False, s * US, e * US)


def dev(name, s, e, corr, link=0):
    return Ev(name, True, s * US, e * US, corr, link)


def trace():
    """A window of 0-100 us: `update_pass` 10-60 with `sample` 10-30 and
    `action gradient` 30-60 inside, then `replay_add` 70-90."""
    return [
        host(WINDOW, 0, 100),
        span("update_pass", 10, 60), span("sample", 10, 30),
        span("action gradient", 30, 60), span("replay_add", 70, 90),
        # sample: two launches, the second kernel overlapping the first,
        # and an op whose kernel the runtime recorded no call for (its id
        # repeats a runtime call's of another span)
        host("cudaLaunchKernel", 12, 13, corr=1),
        host("cudaLaunchKernel", 14, 15, corr=2),
        dev("k1", 13, 20, 1), dev("k2", 18, 24, 2),
        host("aten::mm", 25, 27, corr=8),
        dev("cutlass_sgemm", 26, 28, 40, link=8),
        # action gradient: a launch whose kernel runs after the span ends
        # (and after replay_add has begun), and a sync of 4 us
        host("cudaLaunchKernelExC", 40, 41, corr=3),
        host("cudaStreamSynchronize", 50, 54, corr=5),
        dev("k3", 62, 75, 3),
        # replay_add: a copy, a synchronous memcpy of 6 us, a memset
        host("cudaMemcpyAsync", 72, 73, corr=6),
        host("cudaMemcpy", 74, 80, corr=7),
        host("cudaMemsetAsync", 81, 82, corr=8),
        dev("Memcpy DtoH", 76, 79, 6), dev("Memset", 83, 84, 8),
        # the spans' mirrors on the device timeline (their ids may repeat
        # a launch's), and a launch from outside any span
        dev(PREFIX + "update_pass", 10, 75, 3),
        dev(PREFIX + "sample", 13, 24, 1),
        host("cudaLaunchKernel", 92, 93, corr=9), dev("k4", 93, 95, 9),
    ]


@pytest.fixture(scope="module")
def red():
    return reduce(trace())


def test_device_work_follows_its_launch(red):
    s = red["spans"]
    assert s["sample"]["device_s"] == pytest.approx(13e-6)  # 13-24, 26-28
    # k3 ran 62-75, after its span closed at 60: still the action
    # gradient's and the pass's, not replay_add's
    assert s["action gradient"]["device_s"] == pytest.approx(13e-6)
    assert s["update_pass"]["device_s"] == pytest.approx(26e-6)
    assert s["replay_add"]["device_s"] == pytest.approx(4e-6)
    assert red["unattributed"] == 0


def test_launches_and_syncs(red):
    s = red["spans"]
    assert s["sample"]["launches"] == 3     # one through its host op
    assert s["action gradient"]["launches"] == 1
    assert s["update_pass"]["launches"] == 4
    assert s["replay_add"]["launches"] == 0         # copies, sets
    assert s["action gradient"]["syncs"] == 1
    assert s["action gradient"]["sync_s"] == pytest.approx(4e-6)
    assert s["update_pass"]["syncs"] == 1
    assert s["replay_add"]["syncs"] == 1
    assert s["replay_add"]["sync_s"] == pytest.approx(6e-6)
    assert s["sample"]["syncs"] == 0


def test_busy_idle_and_mirrors(red):
    # busy 13-24, 26-28, 62-75, 76-79, 83-84, 93-95: 11 + 2 + 13 + 3 + 1
    # + 2 us, the mirrors (10-75, 13-24) not counted
    assert red["busy_s"] == pytest.approx(32e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    s = red["spans"]
    assert s["update_pass"]["n"] == 1
    assert s["update_pass"]["wall_s"] == pytest.approx(50e-6)
    assert s["update_pass"]["idle_s"] == pytest.approx(37e-6)  # 50 - 13
    # 70-90 less 70-75, 76-79, 83-84
    assert s["replay_add"]["idle_s"] == pytest.approx(11e-6)


def test_idle_gaps_by_innermost_span(red):
    idle = dict(red["idle_spans"])
    # gaps: 0-13 (middle 6.5: none), 24-26 (sample), 28-62 (45: action
    # gradient), 75-76, 79-83, 84-93 (replay_add), 95-100 (none)
    assert idle["no span"] == pytest.approx(18e-6)
    assert idle["sample"] == pytest.approx(2e-6)
    assert idle["action gradient"] == pytest.approx(34e-6)
    assert idle["replay_add"] == pytest.approx(14e-6)
    assert "update_pass" not in idle
    assert sum(idle.values()) == pytest.approx(68e-6)


def test_readers(red):
    rec = {"spans": red}
    got = {m: cell.reader(m).read(rec) for m in (
        "update_pass_device_ms.train", "update_pass_launches.train",
        "update_pass_syncs.train", "update_pass_idle_share.train",
        "action_gradient_device_ms.train")}
    assert got == pytest.approx({
        "update_pass_device_ms.train": 26e-3,
        "update_pass_launches.train": 4,
        "update_pass_syncs.train": 1,
        "update_pass_idle_share.train": 74.0,
        "action_gradient_device_ms.train": 13e-3})
    # no env_step, collect_step or ee_state span in this trace
    for m in ("replay_add_wait_ms.train", "actor_device_ms.collect",
              "ee_state_device_ms.collect_device",
              "ee_state_launches.collect_device"):
        assert cell.reader(m).read(rec) is None, m


def test_events_of_a_cpu_profile():
    """On the CPU the session holds the window, the spans and the ops (no
    device activity, no runtime call); its reduction counts the spans."""
    from ddiffpg_tpu_torch.utils import trace as port_trace

    port_trace.enable(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(2):
                    with port_trace.span("outer"), port_trace.span("inner"):
                        torch.ones(4).add_(1)
    finally:
        port_trace.enable(False)
    evs = events(prof.profiler.kineto_results.events())
    assert {WINDOW, PREFIX + "outer", PREFIX + "inner",
            "aten::add_"} <= {e.name for e in evs}
    assert not any(e.device for e in evs)
    red = reduce(evs)
    assert red["spans"]["outer"]["n"] == red["spans"]["inner"]["n"] == 2
    assert red["spans"]["inner"]["device_s"] == 0.0
    assert red["busy_s"] == 0.0
    assert red["idle_spans"][0][1] == pytest.approx(red["window_s"])


@pytest.mark.parametrize("name,kids", [
    ("ddiffpg-antmaze-v1.train", {"train_step": 1, "env_step": 1,
                                  "replay_add": 1, "update_pass": 2,
                                  "action gradient": 2}),
    ("ddiffpg-drawermulti-joints.collect", {"collect_step": 2, "actor": 2,
                                            "env": 2, "ee_state": 2})],
    ids=["train", "panda"])
def test_span_window_of_a_tiny_cell_on_the_cpu(name, kids):
    """`profiled_units` units of the cell's driver with the spans on; the
    spans off again after."""
    from ddiffpg_tpu_torch.utils import trace as port_trace

    _, config, traffic = cell.load_cell(cell.load_bench(), name,
                                        tiny.SIZES[name])
    out = span_window(config, traffic, torch.device("cpu"))
    assert not port_trace.enabled()
    assert {k: out["spans"][k]["n"] for k in kids} == kids
    assert out["busy_s"] == 0.0 and out["unattributed"] == 0


def test_cpu_traced_run_reads_no_span_metric():
    out = tiny.run("ddiffpg-antmaze-v1.train", trace=True)
    m = out["result"]["metrics"]
    assert {"update_pass_ms.train", "action_gradient_ms.train",
            "mfu.train"} <= set(m)
    assert out["record"]["spans"] is None
    span_metrics = {x["name"] for x in cell.load_bench()["per_layer"]
                    if x["source"] == "program_span"
                    and "harness.spans" in (cell.ROOT / "benchmark/metrics"
                                            / f"{x['name']}.py").read_text()}
    assert len(span_metrics) == 9 and not span_metrics & set(m)
