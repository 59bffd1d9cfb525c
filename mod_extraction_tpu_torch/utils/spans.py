"""Spans at the layer boundaries of the port's hot paths: the stage-1 step
(`train/lfo_task.py`), the TBPTT step (`train/tbptt_task.py`), the render
they share (`train/render.py`) and the plugin's processor call
(`export/streaming.py`).

    with span("tbptt.chunk"):
        ...

The torch profiler is the switch.  With it off, `span` returns one shared
no-op context: the cost is the profiler's enabled check and a `with`.
With it on (the benchmark's `--trace 1` span, the Trainer's profile
window, any `torch.profiler.profile` of the caller), a span

* opens `torch.profiler.record_function(name)`, so it lies in the Chrome
  trace beside the kernels and copies it issued;
* records its host start and end on the profiler's clock (`time.time_ns`:
  the trace's `ts` is it, in microseconds, less the trace's
  `baseTimeNanoseconds`);
* on a CUDA device (unless `device=False`), records a pair of timing
  events on the current stream: the span's interval on the device's clock,
  from when the device reaches the span's first work to when it finishes
  its last.  The device's waits inside it count, so a span the host issues
  slower than the device runs it reads the host's pace, not its kernels'
  time; under the profiler the host is slower than untraced;
* records the span it opened inside.

Records stay in memory (the last `MAX_RECORDS`); the device times are read
after one synchronize, when first asked for.  `summary()` gives per name
the count, host and device ms (totals and medians) and self host ms (the
span less its children); `per_unit` sums chosen spans per step or call,
as the benchmark's per-layer readers take them; `clear()` empties the
store."""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import torch

MAX_RECORDS = 1 << 15
_NOOP = nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class Record:
    """One span: its name, the span it opened inside, its host interval (ns
    on the profiler's clock) and, on a CUDA device, its pair of events until
    they are read into `device_ms`."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events", "device_ms")

    def __init__(self, name: str, parent: Optional["Record"]) -> None:
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = 0
        self.events = None
        self.device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_records: deque = deque(maxlen=MAX_RECORDS)
_open = threading.local()
_streams: Dict[tuple, object] = {}


def _current_stream():
    """The current CUDA stream's object, cached by its identity:
    `torch.cuda.current_stream()` builds a new one at each call, which
    costs more than the event it serves (8 µs a call on an H100 host,
    torch 2.11)."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream()
    return stream


class _Span:
    __slots__ = ("rec", "rf", "device")

    def __init__(self, name: str, device: bool) -> None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.rec = Record(name, stack[-1] if stack else None)
        self.rf = torch.profiler.record_function(name)
        self.device = device

    def __enter__(self):
        rec = self.rec
        self.rf.__enter__()
        _open.stack.append(rec)
        _records.append(rec)
        if self.device and torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record(_current_stream())
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record(_current_stream())
        _open.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, device: bool = True):
    """A context over one layer's work: recorded while the torch profiler
    is on, the shared no-op otherwise.  `device=False` times it on the host
    alone, without the CUDA events."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name, device)


def clear() -> None:
    _records.clear()


def records() -> List[Record]:
    """The closed spans in the order they opened, device times read."""
    done = [r for r in _records if r.end_ns]
    pending = [r for r in done if r.events is not None and r.device_ms is None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return done


def per_unit(unit_name: str, names: Sequence[str]) -> List[Optional[float]]:
    """For each span named `unit_name` (a step or a call), the sum of the
    device ms of the spans named in `names` inside it: itself where it is
    named, else its descendants whose nearest `unit_name` ancestor it is.
    A sum over a span with no device time is None."""
    recs = records()
    units = [r for r in recs if r.name == unit_name]
    at = {id(r): i for i, r in enumerate(units)}
    sums: List[Optional[float]] = [0.0] * len(units)
    for r in recs:
        if r.name not in names:
            continue
        top = r
        while top is not None and top.name != unit_name:
            top = top.parent
        if top is None:
            continue
        i, value = at[id(top)], r.device_ms
        sums[i] = None if value is None or sums[i] is None else sums[i] + value
    return sums


def summary() -> Dict[str, Dict]:
    """Per span name: its count, host ms (total, median), device ms (total,
    median; None off the card) and self host ms (total: the spans less the
    host time of the spans opened inside them)."""
    recs = records()
    inner: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None:
            inner[id(r.parent)] = inner.get(id(r.parent), 0.0) + r.host_ms
    by_name: Dict[str, List[Record]] = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    out = {}
    for name, rs in by_name.items():
        host = [r.host_ms for r in rs]
        dev = [r.device_ms for r in rs]
        has_dev = all(d is not None for d in dev)
        out[name] = {
            "count": len(rs),
            "host_ms": sum(host),
            "host_ms_median": statistics.median(host),
            "device_ms": sum(dev) if has_dev else None,
            "device_ms_median": statistics.median(dev) if has_dev else None,
            "self_host_ms": sum(r.host_ms - inner.get(id(r), 0.0) for r in rs),
        }
    return out
