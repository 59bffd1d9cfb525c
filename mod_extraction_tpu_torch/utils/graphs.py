"""The port's one CUDA-graph rule, for the TBPTT chunk update
(`train/tbptt_task.py`) and the plugin call (`export/streaming.py`).  A
`GraphCache` keeps its owner's static buffers for the `size` shape keys
used last.  `run` does a key's first use eagerly: the cache's very first
on its own side stream, made then on its device and ordered between the
current stream's work, so that what a library makes once a stream
(cuBLAS's workspace) lies outside every graph's pool; any other on the
current stream.  It captures a key's second use on the side stream (a
private pool, `capture_error_mode="thread_local"`) and replays it, and
replays every later use, returning the capture's outputs.  A captured
entry is dropped (evicted, `clear`) only after a synchronize.  The CPU
runs every use eagerly."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable, List, Optional

import torch

from mod_extraction_tpu_torch.utils.spans import span


class Entry:
    """A key's owner buffers, whether its eager first use ran, its graph and
    the outputs the capture returned."""

    def __init__(self, buffers: Any) -> None:
        self.buffers = buffers
        self.ran = False
        self.graph = None
        self.out = None


class GraphCache:
    """Up to `size` keys' entries on `device`; captures spanned
    `capture_span` and replays `replay_span` (none if None), on the host
    alone."""

    def __init__(self, size: int, device: torch.device, capture_span: str, replay_span: Optional[str] = None):
        self.size = size
        self.device = device
        self.capture_span = capture_span
        self.replay_span = replay_span
        self._entries: OrderedDict = OrderedDict()
        self._stream = None

    def entry(self, key: Hashable, make: Callable[[], Any]) -> Entry:
        """The key's entry, now the last used; made around `make()` if not kept."""
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
            return e
        e = self._entries[key] = Entry(make())
        if len(self._entries) > self.size:
            _, old = self._entries.popitem(last=False)
            if old.graph is not None:  # freed once the device is done with it
                torch.cuda.synchronize(self.device)
        return e

    def run(self, e: Entry, body: Callable[[], Any]) -> Any:
        """One use of the entry, by the rule above; the body's result."""
        if e.graph is None:
            if self.device.type != "cuda":
                return body()
            if not e.ran:
                e.ran = True
                if self._stream is not None:
                    return body()
                self._stream = torch.cuda.Stream(self.device)
                current = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(current)
                with torch.cuda.stream(self._stream):
                    out = body()
                current.wait_stream(self._stream)
                return out
            with span(self.capture_span, device=False):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                    e.out = body()
                e.graph = graph
        with span(self.replay_span, device=False):
            e.graph.replay()
        return e.out

    def clear(self) -> None:
        if self.captured():
            torch.cuda.synchronize(self.device)
        self._entries.clear()

    def keys(self) -> List[Hashable]:
        """The kept keys, least recently used first."""
        return list(self._entries)

    def captured(self) -> List[Hashable]:
        """The kept keys holding a graph, least recently used first."""
        return [k for k, e in self._entries.items() if e.graph is not None]
