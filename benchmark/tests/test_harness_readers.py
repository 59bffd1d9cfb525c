"""Each cell's traced run reads exactly the per-layer metrics BENCHMARK.json
gives it, from the observations its driver leaves; a reader with nothing
to read leaves its metric out."""

import numpy as np
import pytest

from benchmark.harness.common import load_manifest, make_run
from benchmark.harness.trace import Trace

MAN = load_manifest()


def _observe(run):
    trace = Trace(window_s=0.5, busy_s=0.4, launches=1200, n_units=2)
    if run.traffic["kind"] == "stream":
        run.obs.update(unit="buffer", trace=trace, latency_s=np.full(100, 1e-3))
    else:
        run.obs.update(unit="step", trace=trace, step_s=[0.2, 0.2], step_least_s=0.02,
                       time_probe=lambda fn: 0.01,
                       probes={"render": (None, 1e-4), "trunk": (None, 1e-3), "lstm_chunk": (None, 1e-4)}
                       if "tbptt" not in run.traffic["kind"] else {"lstm_chunk": (None, 1e-4)})


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_reads_its_metrics(cell):
    run = make_run(cell, 1, 1.0, True, device="cpu")
    _observe(run)
    got = run.read_layers()
    wanted = {m["name"] for m in MAN["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(got) == wanted
    for name, value in got.items():
        assert np.isfinite(value) and value > 0
        if name.startswith("idle_share"):
            assert value == pytest.approx(20.0)
        if name.startswith("launches"):
            assert value == 600.0


def test_nothing_to_read():
    run = make_run(MAN["workloads"][0]["name"], 1, 1.0, True, device="cpu")
    assert run.read_layers() == {}
