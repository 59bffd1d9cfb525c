"""The reader of `replay_share` (`benchmark/metrics/replay_share.py`):
None with nothing to read, with a program that has no spans module, and
with a program whose calls have no `processor.replay` spans (one that
never replays, as before the processor's CUDA graphs); else the traced
calls' `processor.replay` spans over their `processor.call` spans, x 100."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.common import load_manifest, load_reader, make_run
from mod_extraction_tpu_torch.utils import spans

CELL = "pipeline_h160.stream128"


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def _read():
    return load_reader("replay_share").read(make_run(CELL, 1, 1.0, True, device="cpu"))


def _calls(replayed):
    """One `processor.call` a flag, with a `processor.replay` inside
    `processor.run` where the flag is set, recorded under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        for r in replayed:
            with spans.span("processor.call", device=False):
                with spans.span("processor.input", device=False):
                    pass
                with spans.span("processor.run", device=False):
                    if r:
                        with spans.span("processor.replay", device=False):
                            pass
                with spans.span("processor.output", device=False):
                    pass


def test_declared_for_the_stream_cell():
    (m,) = [m for m in load_manifest()["per_layer"] if m["name"] == "replay_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "%", "higher", "program_span", "serving processor", "buffer_p99_ms", [CELL])


def test_nothing_to_read():
    assert _read() is None


def test_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "mod_extraction_tpu_torch.utils.spans", None)
    monkeypatch.delattr(sys.modules["mod_extraction_tpu_torch.utils"], "spans", raising=False)
    assert _read() is None


def test_calls_that_never_replay():
    _calls([False, False])
    assert _read() is None


@pytest.mark.parametrize("replayed, share", [([True, False, True], 200 / 3), ([True] * 4, 100.0),
                                             ([False, False, False, True], 25.0)])
def test_share_of_replayed_calls(replayed, share):
    _calls(replayed)
    assert _read() == pytest.approx(share)
