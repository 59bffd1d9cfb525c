"""The port's spans (`utils/spans.py`) on the CPU: nothing happens with the
profiler off; under `torch.profiler.profile` the spans nest, lie in the
Chrome trace as user annotations, and sit at the layer boundaries of the stage-1 step, the
TBPTT step and the processor call.  Also `utils/timing.py::device_busy`,
which merges overlapping device work."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mod_extraction_tpu_torch.data.synthetic import (
    batch_to_torch,
    flanger_max_delay_samples,
    make_interwoven_batch,
    make_synthetic_batch,
)
from mod_extraction_tpu_torch.export.streaming import StreamingEffectModel
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask
from mod_extraction_tpu_torch.utils import spans
from mod_extraction_tpu_torch.utils.timing import device_busy, merged_length


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _children(rec, recs):
    return [r for r in recs if r.parent is rec]


class _FakeEvent:
    """A CUDA timing event stand-in: `elapsed_time` is 2 ms."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        pass

    def elapsed_time(self, other):
        return 2.0


@pytest.fixture
def counted(monkeypatch):
    """`record_function` and the CUDA events counted, with a card that
    seems initialised."""
    calls = {"record_function": 0}
    real = torch.profiler.record_function

    def record_function(name):
        calls["record_function"] += 1
        return real(name)

    _FakeEvent.made = 0
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(spans, "_current_stream", lambda: None)
    return calls


def _nest():
    with spans.span("outer"):
        with spans.span("inner"):
            time.sleep(0.002)
        with spans.span("inner", device=False):
            time.sleep(0.002)
        time.sleep(0.002)


def test_profiler_off_records_nothing(counted):
    assert spans.span("a") is spans.span("b", device=False)  # one shared no-op
    _nest()
    assert counted["record_function"] == 0 and _FakeEvent.made == 0
    assert spans.records() == [] and spans.summary() == {}


def test_profiler_on_records_ranges_and_events(counted):
    _profiled(_nest)
    recs = spans.records()
    assert counted["record_function"] == 3 and _FakeEvent.made == 4  # none for `device=False`
    assert [r.device_ms for r in recs] == [2.0, 2.0, None]
    assert spans.summary()["outer"]["device_ms"] == 2.0
    assert spans.summary()["inner"]["device_ms"] is None  # one of the two has no device time


def test_records_nest_with_parent_and_self_time():
    _profiled(_nest)
    outer, a, b = spans.records()
    assert [r.name for r in (outer, a, b)] == ["outer", "inner", "inner"]
    assert outer.parent is None and a.parent is outer and b.parent is outer
    assert outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= outer.end_ns
    s = spans.summary()
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["inner"]["host_ms"] == pytest.approx(a.host_ms + b.host_ms)
    assert s["outer"]["self_host_ms"] == pytest.approx(outer.host_ms - a.host_ms - b.host_ms)
    assert 1.5 < s["outer"]["self_host_ms"] < outer.host_ms - 3.0
    assert s["inner"]["device_ms"] is None and s["inner"]["device_ms_median"] is None  # no card
    assert spans.per_unit("outer", ("inner",)) == [None]  # no device time off the card
    a.device_ms, b.device_ms = 1.0, 2.5
    assert spans.per_unit("outer", ("inner",)) == [3.5] and spans.per_unit("inner", ("inner",)) == [1.0, 2.5]
    with spans.span("after"):  # the profiler is off again
        pass
    assert len(spans.records()) == 3


def test_spans_lie_in_the_chrome_trace(tmp_path):
    prof, _ = _profiled(_nest)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ann = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in ann} >= {"outer", "inner"}
    for r in spans.records():  # its recorded start lies inside an annotation of its name
        start_us = r.start_ns / 1e3 - base_us
        assert any(e["ts"] <= start_us <= e["ts"] + e["dur"] for e in ann if e["name"] == r.name), r.name


def test_tbptt_step_spans():
    sr, n, chunk = 8000.0, 8000, 512
    task = TBPTTEffectModelingTask(
        LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=8, latent_dim=1),
        RenderConfig(sr=sr, n_samples=n, effects=(2,), max_delay_samples=89),
        warmup_n_samples=chunk, step_n_samples=chunk, device="cpu",
    )
    batch = batch_to_torch(make_synthetic_batch(3, 4, n, sr, "flanger"), "cpu")
    task.train_step(batch)  # a step off the profiler counts, and records nothing
    assert spans.records() == []
    _profiled(lambda: task.train_step(batch))
    recs = spans.records()
    (step,) = [r for r in recs if r.name == "tbptt.step"]
    assert step.parent is None
    kids = _children(step, recs)
    n_chunks = task.updates_per_batch
    assert [r.name for r in kids] == (["render", "tbptt.condition", "tbptt.warmup"]
                                      + ["tbptt.chunk"] * n_chunks + ["tbptt.metrics"])
    for c in (r for r in kids if r.name == "tbptt.chunk"):
        assert [r.name for r in _children(c, recs)] == ["tbptt.forward", "tbptt.backward", "tbptt.update"]
    assert sum(r.host_ms for r in kids) <= step.host_ms
    assert spans.summary()["tbptt.chunk"]["count"] == n_chunks


def _lfo_task(**opts):
    sr, n = 44100.0, 4410
    model = Spectral2DCNN(in_ch=2, n_samples=n, sr=sr, n_fft=1024, hop_len=256, n_mels=32,
                          kernel_size=(5, 13), out_channels=(4, 4), temp_dilations=(1, 2), pool_size=(2, 1))
    render = RenderConfig(sr=sr, n_samples=n, effects=(2, 3),
                          max_delay_samples=flanger_max_delay_samples(30.0, 10.0, sr))
    task = LFOExtractionTask(model, render, device="cpu", **opts)
    return task, batch_to_torch(make_interwoven_batch(3, 6, n, sr), "cpu")


@pytest.mark.parametrize("sub", [None, 2])
def test_lfo_step_spans(sub):
    task, batch = _lfo_task(sub_batch_size=sub)
    _profiled(lambda: task.train_step(batch))
    recs = spans.records()
    (step,) = [r for r in recs if r.name == "lfo.step"]
    kids = _children(step, recs)
    phases = ["render", "lfo.forward", "lfo.backward"]
    assert [r.name for r in kids] == phases * (1 if sub is None else 3) + ["lfo.update"]
    assert [r for r in recs if r.parent is None] == [step]  # every span of the step nests under it


def test_process_np_spans(counted):
    """The call's spans are timed on the host alone: no CUDA events."""
    sm = StreamingEffectModel(LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=8, latent_dim=1), device="cpu")
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 256)).astype(np.float32)
    state = sm.init_state()
    _, state = sm.process_np(state, x[:, :128])  # call 1, off the profiler
    _profiled(lambda: [sm.process_np(state, x[:, 128:]) for _ in range(2)])
    recs = spans.records()
    calls = [r for r in recs if r.name == "processor.call"]
    assert len(calls) == 2 and all(c.parent is None for c in calls)
    assert counted["record_function"] == 8 and _FakeEvent.made == 0
    assert all(r.device_ms is None for r in recs)
    for c in calls:
        assert [r.name for r in _children(c, recs)] == ["processor.input", "processor.run", "processor.output"]
    assert spans.summary()["processor.run"]["count"] == 2


def _event(kind, start, end, name="k"):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA if kind != "cpu" else
                           torch.autograd.DeviceType.CPU, is_user_annotation=kind == "annotation",
                           key=name, name=name, time_range=SimpleNamespace(start=start, end=end),
                           self_device_time_total=end - start)


def test_device_busy_merges_overlapping_work():
    """A side stream's copy under a kernel counts once; a span's device
    annotation, an optimizer's range and host ops count not at all."""
    events = [_event("kernel", 0, 1000), _event("kernel", 500, 1500, "copy"), _event("kernel", 3000, 4000),
              _event("annotation", 0, 5000, "tbptt.chunk"), _event("kernel", 0, 5000, "Optimizer.step#AdamW"),
              _event("cpu", 0, 9000, "aten::mm")]
    prof = SimpleNamespace(events=lambda: events, key_averages=lambda: events)
    busy_ms, by_name = device_busy(prof)
    assert busy_ms == pytest.approx(2.5)
    assert [e.key for e in by_name] == ["k", "copy", "k"]
    assert merged_length([(0, 2), (1, 3), (5, 6)]) == 3 + 1 and merged_length([]) == 0
