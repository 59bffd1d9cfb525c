"""torch.profiler over a span of whole steps or calls, read from its
Chrome trace: the device's busy time with overlapping kernels and copies
merged (not summed), the host's CUDA runtime calls that launch work, the
device operations that took most time, and the longest idle gaps by the
host operation running when each began."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
CPU_CATS = ("cpu_op", "user_annotation")
# host calls that put work on the device: kernels, graphs, async copies, memsets
LAUNCH_NAMES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
    "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
    "cuMemcpyDtoHAsync_v2", "cudaMemsetAsync", "cuMemsetD8Async", "cuMemsetD32Async",
))


@dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    n_units: int
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def short_name(name: str) -> str:
    """A kernel's name without its return type, parameters and the
    library's namespaces, cut to 80 characters:
    `lstm_bwd_walk_fast_kernel<64>` from its full signature."""
    s = re.sub(r"at::native::|\(anonymous namespace\)::|at::cuda::", "",
               name[5:] if name.startswith("void ") else name)
    depth = 0
    for i, ch in enumerate(s):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    return s[:80].strip()


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[dict], window_s: float, n_units: int, top: int = 10) -> Trace:
    """A Trace from Chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    cpu = [e for e in xs if e.get("cat") in CPU_CATS]
    merged = merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name: dict = {}
    for e in dev:
        n = short_name(e["name"])
        by_name[n] = by_name.get(n, 0.0) + float(e["dur"]) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    starts = [float(e["ts"]) for e in host + cpu + dev]
    t_lo = min(starts) if starts else 0.0
    t_hi = t_lo + window_s * 1e6
    edges = [t_lo] + [x for se in merged for x in se] + [t_hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle = []
    for length, at in gaps:
        inner = [e for e in cpu if float(e["ts"]) <= at < float(e["ts"]) + float(e["dur"])]
        label = min(inner, key=lambda e: float(e["dur"]))["name"] if inner else "no host op"
        idle.append((label, length / 1e6))
    launches = sum(1 for e in host if e.get("name") in LAUNCH_NAMES)
    return Trace(window_s, min(busy_us / 1e6, window_s), launches, n_units, ops, idle)


def profile_span(fn: Callable[[], int]) -> Trace:
    """Profile `fn()` (which returns the steps or calls it ran) between two
    synchronisations; the trace goes through a file in TMPDIR, deleted once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, wall, n)
