"""Timing helpers for the port's benches on the card: the card's name and
power limit, CUDA-event and profiler times, and the busy share of a step.

Used by `chip_smoke.py`, `bench_torch.py` and `scripts/bench_torch_*.py`;
every function but `card_line` and `kernel_short_name` needs a CUDA device.
"""

from __future__ import annotations

import re
import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_median(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over `batches` of the mean ms of `reps` calls, after a warm-up
    call: a library call's first batches read high on some runs."""
    fn()
    return float(np.median([cuda_ms(fn, reps) for _ in range(batches)]))


def cuda_ms_fenced(fn, reps: int = 20, spin_cycles: int = 1_000_000) -> float:
    """Median ms of one call of `fn` between CUDA events, each call queued
    behind a spin of `spin_cycles` on the card (about 0.5 ms), so that the
    events time the card's work and not the host's cost of issuing it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_queued(fn, reps: int, spin_ms: float) -> float:
    """Mean ms a call over `reps` calls between CUDA events, all issued while
    the card spins for about `spin_ms` first: once the host has queued them
    the card runs them back to back, so the events time the card alone,
    the gaps between its launches included."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_ms * 2e6))  # about 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_short_name(key: str) -> str:
    """`lstm_bwd_walk_fast_kernel<64>` from the profiler's full signature."""
    m = re.search(r"(\w+)(<[^>(]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


def device_kernels(fn, reps: int) -> dict:
    """torch.profiler over `reps` calls of `fn` after a warm-up call: for
    each kernel name, (its device ms in all, the launches recorded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = kernel_short_name(e.key)
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return out


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device ms per call of `fn`, by kernel name (torch.profiler)."""
    return {name: ms / reps for name, (ms, _) in device_kernels(fn, reps).items()}


def device_ms_per_launch(fn, reps: int) -> dict:
    """Device ms of one launch of each kernel that `fn` launches, the mean
    over the launches the profiler recorded: unlike `device_ms_by_kernel`,
    a launch the profiler missed does not lower it (runs on the H100 have
    recorded 7-8 of 10 calls' kernels)."""
    return {name: ms / n for name, (ms, n) in device_kernels(fn, reps).items()}


def profile_step(step) -> tuple:
    """torch.profiler over one `step()`: (wall ms, device-busy ms, the
    device events by name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events = device_busy(prof)
    return wall_ms, busy_ms, events


def _device_work(e) -> bool:
    """A kernel, copy or memset on the device: not a range (a span, or one
    the optimizer opens, "Optimizer.step#..."), which the profiler lists a
    second time on the device with the time of the work inside it."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer."))


def merged_length(intervals) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_busy(prof) -> tuple:
    """(device-busy ms, the device events by name) of a finished
    torch.profiler run: the time in which a kernel or copy ran, with
    overlapping work (a side stream's copies beside the compute stream's
    kernels) merged, not summed; the events by name with their self device
    times (ranges left out)."""
    busy_us = merged_length((e.time_range.start, e.time_range.end) for e in prof.events() if _device_work(e))
    events = [e for e in prof.key_averages() if _device_work(e) and e.self_device_time_total > 0]
    return busy_us / 1e3, events
