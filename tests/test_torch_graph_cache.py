"""The CUDA-graph cache both replayed paths share (`utils/graphs.py`), on
the CPU, at each owner's bound (the TBPTT task's 4 chunk shapes, the
plugin processor's 8 buffer shapes): its least-recently-used order; its
rule on a stand-in card, whose CUDA calls log what they would do (a key's
first use eager, the cache's very first on its side stream between the
current stream's work, its second captured on that stream and replayed,
every later one replayed; a key used once never captured; the spans); the
synchronize
before a captured entry is dropped, evicted or cleared, and none for an
entry never captured; and the CPU, where every use runs eagerly.  Torch
only; a few seconds."""

import pytest
import torch

from mod_extraction_tpu_torch.export.streaming import (
    CompiledStreamingProcessor,
    StreamingEffectModel,
    serialize_streaming_processor,
)
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask
from mod_extraction_tpu_torch.utils import spans
from mod_extraction_tpu_torch.utils.graphs import GraphCache

BOUNDS = {"tbptt": 4, "plugin": 8}
CARD = torch.device("cuda")


@pytest.fixture(scope="module")
def owner_caches():
    """The graph caches of a TBPTT task and of a loaded processor, on the CPU."""
    model = LSTMEffectModel(n_hidden=8, generator=torch.Generator().manual_seed(5))
    task = TBPTTEffectModelingTask(model, RenderConfig(sr=8000.0, n_samples=4000, effects=(2,)), device="cpu")
    art = serialize_streaming_processor(StreamingEffectModel(model, device="cpu"))
    proc = CompiledStreamingProcessor(art, n_channels=2, n_hidden=8, device="cpu")
    return {"tbptt": task.graphs, "plugin": proc.graphs}


@pytest.fixture(params=list(BOUNDS))
def size(request, owner_caches):
    """An owner's bound, as its cache holds it."""
    cache = owner_caches[request.param]
    assert cache.size == BOUNDS[request.param] and cache.device.type == "cpu"
    return cache.size


class FakeGraph:
    """A graph that logs its replays and its release."""

    log: list = []

    def replay(self):
        self.log.append("replay")

    def __del__(self):
        self.log.append("graph freed")


class _Context:
    def __init__(self, log, enter, leave):
        self.log, self.enter, self.leave = log, enter, leave

    def __enter__(self):
        self.log.append(self.enter)

    def __exit__(self, *exc):
        self.log.append(self.leave)
        return False


class FakeStream:
    """A stream that logs its waits: `made` on the cache's device, or the
    current stream."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append(f"{self.name} waits {other.name}")


@pytest.fixture
def card(monkeypatch):
    """Stand-ins for the CUDA calls the cache makes on a card; returns
    their log."""
    log = []
    monkeypatch.setattr(FakeGraph, "log", log)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)

    def stream(device):
        assert device == CARD
        log.append("side stream made")
        return FakeStream("side", log)

    def graph(g, stream, capture_error_mode):
        assert isinstance(g, FakeGraph) and stream.name == "side" and capture_error_mode == "thread_local"
        return _Context(log, "capture on side", "captured")

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream("current", log))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Context(log, f"on {s.name}", f"off {s.name}"))
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: log.append(f"synchronize {device}"))
    return log


def use(cache, key, log):
    """One use of `key` whose body logs itself and returns a new object."""
    e = cache.entry(key, lambda: f"buffers {key}")
    assert e.buffers == f"buffers {key}"
    return cache.run(e, lambda: log.append(f"body {key}") or object())


def test_seen_shapes_are_bounded(size):
    """The last `size` keys are kept, least recently used out: a key's
    entry is found again if fewer than `size` others came between, and is
    made anew otherwise."""
    cache, made = GraphCache(size, torch.device("cpu"), "t.capture"), []
    for k in (64, 64, 65):
        cache.entry(k, lambda k=k: made.append(k))
    assert made == [64, 65]
    for n in range(100, 100 + size - 2):
        cache.entry(n, lambda: None)
    cache.entry(64, lambda: made.append(64))  # size - 1 others since its last use: kept
    cache.entry(200, lambda: None)
    cache.entry(65, lambda: made.append(65))  # size others since: made anew
    assert made == [64, 65, 65]
    assert len(cache.keys()) == size and cache.keys()[-3:] == [64, 200, 65]
    assert cache.captured() == []


def test_first_use_eager_then_captured_then_replayed(card, size):
    """On a card: the cache's first use makes its side stream and runs the
    body there eagerly, after the current stream's work and before what
    follows, returning its result; the second use captures the body on the
    side stream (spanned `t.capture`) and replays it; later uses replay
    only (spanned `t.replay`), each returning the captured output.  Another
    key's first use runs eagerly on the current stream.  A key used once
    holds no graph."""
    cache = GraphCache(size, CARD, "t.capture", "t.replay")
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        first = use(cache, "a", card)
        assert card == ["side stream made", "side waits current", "on side", "body a", "off side",
                        "current waits side"]
        assert first is not None and cache.captured() == []
        card.clear()
        second = use(cache, "a", card)
        assert card == ["capture on side", "body a", "captured", "replay"] and cache.captured() == ["a"]
        card.clear()
        assert [use(cache, "a", card) for _ in range(3)] == [second] * 3
        assert card == ["replay"] * 3
        card.clear()
        use(cache, "b", card)
        assert card == ["body b"]
        card.clear()
        use(cache, "b", card)
        assert card == ["capture on side", "body b", "captured", "replay"]
    found = spans.summary()
    spans.clear()
    assert found["t.capture"]["count"] == 2 and found["t.replay"]["count"] == 5
    assert cache.keys() == ["a", "b"] and cache.captured() == ["a", "b"]


def test_no_replay_span_without_its_name(card):
    """The TBPTT form: captures spanned, replays not."""
    cache = GraphCache(4, CARD, "t.capture")
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            use(cache, "a", card)
    found = spans.summary()
    spans.clear()
    assert card.count("replay") == 3 and found["t.capture"]["count"] == 1 and "t.replay" not in found


def test_captured_entries_are_dropped_after_a_synchronize(card, size):
    """Evicting an entry never captured synchronizes nothing; evicting a
    captured one synchronizes before its graph is released; `clear`
    synchronizes once before releasing every graph, and not at all when
    nothing is captured."""
    cache = GraphCache(size, CARD, "t.capture")
    use(cache, 0, card)
    for k in range(1, size):
        use(cache, k, card)
        use(cache, k, card)
    card.clear()
    use(cache, size, card)  # key 0, used once, out
    assert "synchronize cuda" not in card and cache.keys() == list(range(1, size + 1))
    card.clear()
    cache.entry(size + 1, lambda: None)  # key 1, captured, out
    assert card == ["synchronize cuda", "graph freed"]
    card.clear()
    cache.clear()
    assert card == ["synchronize cuda"] + ["graph freed"] * (size - 2) and cache.keys() == []
    card.clear()
    use(cache, "x", card)
    card.clear()
    cache.clear()
    assert card == []


def test_cpu_runs_every_use_eagerly(size):
    """On the CPU every use runs the body and returns its own result;
    nothing is captured and no stream is made."""
    cache, log = GraphCache(size, torch.device("cpu"), "t.capture"), []
    outs = [use(cache, k, log) for k in (1, 1, 1, 2)]
    assert log == ["body 1"] * 3 + ["body 2"] and len({id(o) for o in outs}) == 4
    assert cache.captured() == [] and cache.keys() == [1, 2]
