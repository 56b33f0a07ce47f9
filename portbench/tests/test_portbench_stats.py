"""Rates and tails are taken over every sample of the window."""

import pytest

from portbench.stats import percentile, rate


def test_p95_interpolates_over_all_samples():
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert percentile([7.0], 95) == 7.0


def test_one_stall_moves_the_tail_only_past_the_share():
    steady = [10.0] * 99
    assert percentile(steady + [500.0], 95) == pytest.approx(10.0)
    assert percentile([10.0] * 94 + [500.0] * 6, 95) == pytest.approx(500.0)


def test_rate_is_all_work_over_the_whole_window():
    # ten calls of 128 cases x 20 frames in 0.25 s, whatever each took
    assert rate(10 * 128 * 20, 0.25) == 102_400
    with pytest.raises(ValueError):
        rate(1, 0)


def test_idle_share_scales_traced_device_time_to_the_untraced_window():
    from types import SimpleNamespace

    from portbench.metrics import share

    run = SimpleNamespace(trace=SimpleNamespace(busy_s=6.0),
                          traced=SimpleNamespace(work=dict(calls=300)),
                          main=SimpleNamespace(work=dict(calls=900), seconds=20.0))
    # 20 ms of device time a call, 900 calls in 20 s: 18 s busy, 10 % idle
    assert share.idle_share(run, "calls") == pytest.approx(10.0)
    run.trace.busy_s = 0.0
    assert share.idle_share(run, "calls") is None
