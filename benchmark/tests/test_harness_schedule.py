"""The open loop's due-time accounting on a fake clock."""

import numpy as np
import pytest

from benchmark.harness.stream import OpenLoop


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-7  # reading the clock takes a little time, so spins end
        return self.t

    def sleep(self, s):
        self.t += s


def drive(durations, period):
    clock = FakeClock()

    def call(k):
        clock.t += durations[k]

    return OpenLoop(period, clock=clock, sleep=clock.sleep, spin_s=1e-4).run(call, len(durations))


def test_on_time_calls_wait_for_their_due_time():
    out = drive([1e-3] * 10, 3e-3)
    assert np.allclose(out["latency"], 1e-3, atol=1e-5)
    assert np.all(out["lateness"] < 1e-5)


def test_a_stall_delays_the_calls_behind_it():
    d = [1e-3] * 10
    d[2] = 10e-3  # one call overruns three periods
    out = drive(d, 3e-3)
    lat = out["latency"]
    assert lat[2] == pytest.approx(10e-3, abs=1e-5)
    # call 3 was due at 9 ms and starts when call 2 ends, at 16 ms
    assert out["lateness"][3] == pytest.approx(7e-3, abs=1e-5)
    assert lat[3] == pytest.approx(8e-3, abs=1e-5)
    assert lat[4] == pytest.approx(6e-3, abs=1e-5)
    assert lat[5] == pytest.approx(4e-3, abs=1e-5)
    assert lat[6] == pytest.approx(2e-3, abs=1e-5)
    assert lat[7] == pytest.approx(1e-3, abs=1e-5)  # caught up


def test_p99_counts_the_backlog():
    d = [0.5e-3] * 1000
    d[100] = 50e-3
    lat = drive(d, 2.9e-3)["latency"]
    assert np.percentile(lat, 50) == pytest.approx(0.5e-3, abs=1e-5)
    assert (lat > 5e-3).sum() >= 15
