"""The device meter behind the end-to-end metrics of the device trace: on
the card it counts every unit's device work once, and no idle time."""

import time

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_meter_sums_each_units_device_time(card):
    from benchmark.harness.trace import DeviceMeter

    x = torch.randn(2048, 2048, device=card)
    meter = DeviceMeter(card)
    meter.warm()
    assert meter.busy_s == 0.0 and meter.activities == 0

    def unit(k):
        with meter:
            for _ in range(k):
                torch.mm(x, x)
            time.sleep(0.05)              # idle, host side

    unit(4)
    one, acts = meter.busy_s, meter.activities
    assert 0.0 < one < 0.05 and acts >= 4
    unit(8)
    two = meter.busy_s - one
    # twice the work reads about twice the time; the sleeps read nothing
    assert 1.6 < two / one < 2.4
    assert meter.activities >= 3 * acts - 1
