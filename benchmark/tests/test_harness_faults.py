"""A run, its look for a card skipped, at a small size on the CPU: sound,
it comes out correct; with the timed path broken underneath, not.  The
faults: a step that leaves the state unchanged (train: no update; stream:
the state not carried), half of each batch left out with the mean taken
over the rest, and an answer altered where it is produced (stream).  The
trunk convs run in float32 here, so sound runs read at rounding level."""

import pytest
import torch

from benchmark.harness import stream, train
from benchmark.harness.common import all_within, judge
from benchmark.tests.small import small_run

TRAIN = ["pipeline_h64.extractor_train", "pipeline_h160.tbptt_chorus"]


def _correct(run, driver):
    out = driver.run(run)
    return all_within(judge(out["values"], run.limits)) and out["failed"] == 0


def _half(batch):
    return {k: (_half(v) if isinstance(v, dict) else v[::2]) for k, v in batch.items()}


def _task_class(workload):
    if "extractor" in workload:
        from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask

        return LFOExtractionTask
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    return TBPTTEffectModelingTask


@pytest.mark.parametrize("workload", TRAIN)
def test_train_sound(workload):
    assert _correct(small_run(workload, float32=True), train)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_state_unchanged(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    assert not _correct(small_run(workload, float32=True), train)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_half_batch(workload, monkeypatch):
    cls = _task_class(workload)
    step = cls.train_step
    monkeypatch.setattr(cls, "train_step", lambda self, batch, *a, **k: step(self, _half(batch), *a, **k))
    assert not _correct(small_run(workload, float32=True), train)


def _patch_process(monkeypatch, change):
    from mod_extraction_tpu_torch.export.streaming import CompiledStreamingProcessor

    process = CompiledStreamingProcessor.process
    calls = {"n": 0}

    def patched(self, state, x, *knobs):
        y, new = process(self, state, x, *knobs)
        calls["n"] += 1
        return change(calls["n"], state, y, new)

    monkeypatch.setattr(CompiledStreamingProcessor, "process", patched)


def test_stream_sound():
    assert _correct(small_run("pipeline_h160.stream128", seconds=0.1), stream)


def test_stream_state_unchanged(monkeypatch):
    _patch_process(monkeypatch, lambda n, state, y, new: (y, state))
    assert not _correct(small_run("pipeline_h160.stream128", seconds=0.1), stream)


def test_stream_answer_altered(monkeypatch):
    def change(n, state, y, new):
        return (y + 1e-3 if n == 10 else y), new

    _patch_process(monkeypatch, change)
    assert not _correct(small_run("pipeline_h160.stream128", seconds=0.1), stream)
