"""What the per-layer metrics' readers (`benchmark/metrics/<name>.py`)
read from a run's observations; each returns None where the run has
nothing of the kind to read."""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np


def _trace(run, unit: str):
    return run.obs.get("trace") if run.obs.get("unit") == unit else None


def idle_share(run, unit: str = "step") -> Optional[float]:
    """% of the profiled span with no kernel or copy on the device."""
    trace = _trace(run, unit)
    return None if trace is None else 100.0 * (1.0 - trace.busy_s / trace.window_s)


def launches(run, unit: str) -> Optional[float]:
    """Host CUDA runtime calls that put work on the device, per step or call."""
    trace = _trace(run, unit)
    return None if trace is None or trace.launches == 0 else trace.launches / trace.n_units


def device_ms(run, unit: str) -> Optional[float]:
    """Merged device-busy ms per step or call."""
    trace = _trace(run, unit)
    return None if trace is None or trace.busy_s <= 0 else 1e3 * trace.busy_s / trace.n_units


def step_mfu(run) -> Optional[float]:
    """% of the chip's peak: the step's least time over the mean window step."""
    least, steps = run.obs.get("step_least_s"), run.obs.get("step_s")
    if run.obs.get("unit") != "step" or not least or not steps:
        return None
    return 100.0 * least / statistics.fmean(steps)


def roofline(run, probe: str) -> Optional[float]:
    """% of a layer's least time over its CUDA-event time at the cell's shapes."""
    found = run.obs.get("probes", {}).get(probe)
    if found is None:
        return None
    fn, least_s = found
    return 100.0 * least_s / run.obs["time_probe"](fn)


def latency_ms(run, q: float) -> Optional[float]:
    """The q-th percentile of the window's call latencies."""
    lat = run.obs.get("latency_s")
    if run.obs.get("unit") != "buffer" or lat is None or len(lat) == 0:
        return None
    return 1e3 * float(np.percentile(lat, q))
