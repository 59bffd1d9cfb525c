"""The readers of the program's spans (`benchmark/metrics/<name>.py`, source
`program_span`): nothing to read gives None, a program without spans
gives None, and a hand-built store gives the value each reader defines.
Also: the trace reader (`harness/trace.py::summarize`, as it is) labels an
idle gap that begins inside a span by that span or an op inside it."""

import json
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.common import load_manifest, load_reader, make_run
from benchmark.harness.trace import summarize
from mod_extraction_tpu_torch.utils import spans

MAN = load_manifest()
SPAN_METRICS = {m["name"]: m for m in MAN["per_layer"] if m["source"] == "program_span"}
# per cell: the store it leaves and what each of its readers reads from it
EXPECTED = {
    "render_ms.stage1": 4.5, "extractor_ms.stage1": 133.0, "condition_ms.tbptt": 6.5,
    "chunk_device_ms.tbptt": 4.0, "chunk_host_ms.tbptt": 2.0,
    "buffer_input_ms": 0.2, "buffer_run_ms": 0.5, "buffer_output_ms": 0.1,
}


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def _store(tree):
    """Spans recorded under the CPU profiler from `tree`, a list of
    (name, children, host ms, device ms), their host and device ms then
    set by hand."""

    def enter(nodes):
        for name, kids, _, _ in nodes:
            with spans.span(name):
                enter(kids)

    with profile(activities=[ProfilerActivity.CPU]):
        enter(tree)
    flat, at = [], [0]

    def walk(nodes):
        for _, kids, host, dev in nodes:
            flat.append((host, dev))
            walk(kids)

    walk(tree)
    for r, (host, dev) in zip(spans.records(), flat):
        r.start_ns, r.end_ns, r.device_ms = at[0], at[0] + int(host * 1e6), dev
        at[0] += 1


def _leaf(name, host=1.0, dev=1.0):
    return (name, [], host, dev)


STAGE1 = [("lfo.step", [_leaf("render", dev=4.0), _leaf("lfo.forward", dev=50.0),
                        _leaf("lfo.backward", dev=80.0), _leaf("lfo.update", dev=10.0)], 200.0, 150.0),
          ("lfo.step", [_leaf("render", dev=5.0), _leaf("lfo.forward", dev=52.0),
                        _leaf("lfo.backward", dev=84.0), _leaf("lfo.update", dev=10.0)], 200.0, 150.0)]


def _chunk(dev, host):
    kids = [_leaf("tbptt.forward"), _leaf("tbptt.backward"), _leaf("tbptt.update")]
    return ("tbptt.chunk", kids, host, dev)


TBPTT = [("tbptt.step", [_leaf("render", dev=1.0), _leaf("tbptt.condition", dev=5.0), _leaf("tbptt.warmup"),
                         _chunk(3.0, 2.0), _chunk(4.0, 2.0), _chunk(5.0, 6.0), _leaf("tbptt.metrics")],
          20.0, 20.0),
         ("tbptt.step", [_leaf("render", dev=1.0), _leaf("tbptt.condition", dev=6.0), _leaf("tbptt.warmup"),
                         _leaf("tbptt.metrics")], 10.0, 10.0)]


def _call(i, o, r):
    return ("processor.call", [_leaf("processor.input", i), _leaf("processor.run", r),
                               _leaf("processor.output", o)], 1.0, 0.1)


STREAM = [_call(0.1, 0.1, 0.5), _call(0.2, 0.05, 0.4), _call(0.3, 0.2, 0.9)]
STORES = {"pipeline_h64.extractor_train": STAGE1, "pipeline_h160.tbptt_chorus": TBPTT,
          "pipeline_h160.stream128": STREAM}


def test_every_span_metric_is_expected():
    assert set(SPAN_METRICS) == set(EXPECTED)
    for m in SPAN_METRICS.values():
        assert m["unit"] == "ms" and m["better"] == "lower" and len(m["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_to_read(name):
    assert load_reader(name).read(make_run(SPAN_METRICS[name]["workloads"][0], 1, 1.0, True, device="cpu")) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_program_without_spans(name, monkeypatch):
    """A program older than its spans module runs these readers too."""
    monkeypatch.setitem(sys.modules, "mod_extraction_tpu_torch.utils.spans", None)
    monkeypatch.delattr(sys.modules["mod_extraction_tpu_torch.utils"], "spans", raising=False)
    assert load_reader(name).read(make_run(SPAN_METRICS[name]["workloads"][0], 1, 1.0, True, device="cpu")) is None


@pytest.mark.parametrize("cell", sorted(STORES))
def test_reads_a_hand_built_store(cell):
    _store(STORES[cell])
    run = make_run(cell, 1, 1.0, True, device="cpu")
    mine = {n for n, m in SPAN_METRICS.items() if cell in m["workloads"]}
    assert mine
    for name in mine:
        assert load_reader(name).read(run) == pytest.approx(EXPECTED[name]), name
    others = set(EXPECTED) - mine  # the other cells' readers find none of their spans here
    assert all(load_reader(n).read(run) is None for n in others)


def test_idle_gap_inside_a_span_is_labelled_by_it(tmp_path):
    """Device work that ends while the host sleeps inside `tbptt.forward`
    leaves a gap that the unchanged trace reader labels by the span; with
    the span's annotations taken out, the same gap has no host op."""

    def step():
        with spans.span("tbptt.chunk"):
            torch.ones(64).sum()
            with spans.span("tbptt.forward"):
                marks.append(time.time_ns())
                time.sleep(0.005)
                marks.append(time.time_ns())

    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = trace["traceEvents"]
    t0, t1 = (m / 1e3 - base_us for m in marks)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    lo = min(float(e["ts"]) for e in xs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    kernels = [{"ph": "X", "cat": "kernel", "name": "k(float*)", "ts": lo, "dur": (t0 + t1) / 2 - lo},
               {"ph": "X", "cat": "kernel", "name": "k(float*)", "ts": hi + 1.0, "dur": 10.0}]
    window_s = (hi + 11.0 - lo) / 1e6
    labelled = summarize(events + kernels, window_s, 1).idle_gaps
    assert labelled[0][0] == "tbptt.forward"
    bare = [e for e in events if e.get("cat") != "user_annotation"]
    assert summarize(bare + kernels, window_s, 1).idle_gaps[0][0] == "no host op"
