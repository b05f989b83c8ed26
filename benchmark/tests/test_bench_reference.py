"""The plain reference against the port at tiny sizes on the CPU, where
both step the plain substep: every gap reads 0, and a traced run reads
its per-layer metrics."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(tiny.SIZES))
def test_reference_follows_the_port_on_the_cpu(name):
    out = tiny.run(name)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(r["value"] == 0.0 for r in out["compared"]), out["compared"]
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) >= {"setup_s"}


def test_traced_train_run_reads_its_layers():
    out = tiny.run("ddiffpg-antmaze-v1.train", trace=True)
    m = out["result"]["metrics"]
    assert {"update_pass_ms.train", "action_gradient_ms.train",
            "mfu.train"} <= set(m)
    # no device in the trace: no idle share, no roofline
    assert "device_idle_share.train" not in m
    assert out["record"]["host_ms"]["update_pass"]


def test_reference_moves_every_trained_leaf():
    """The train comparison leaves out only leaves the reference does not
    move by a gradient (the RND target net)."""
    from benchmark.drivers import train
    from benchmark.harness import cell

    bench = cell.load_bench()
    wl, config, traffic = cell.load_cell(bench, "ddiffpg-antmaze-v1.train",
                                         tiny.TRAIN)
    ctx = cell.Ctx(bench, wl, config, traffic, 7, torch.device("cpu"))
    st = train.setup(ctx)
    out = train.outputs(ctx, st)
    train.check(ctx, out)
    m = out["reference"]["moments"]
    med = sorted(m.values())[len(m) // 2]
    still = {k for k, v in m.items() if v < 1e-3 * med}
    assert still == {k for k in m if k.startswith("rnd.tgt.")}
