"""Streaming (serving) benchmark of the PyTorch port on one NVIDIA GPU: the
real-time factor of the exported LSTM effect processor (the counterpart of
`scripts/bench_streaming.py`; native 44.1 kHz, any buffer size).

Per buffer size, over `--seconds` of audio on `--channels` channels:

* `rtf_per_call`: one `process_np` per buffer, numpy in and out, the state
  carried on the card, as a plugin host drives a processor;
* `rtf_sustained`: the buffers chained on the card by a Python loop of
  `process` calls (tensors in and out, no copy to the host) with one
  `torch.cuda.synchronize()` at the end, for offline rendering;
* `rtf_artifact_per_call`: as `rtf_per_call`, through the `torch.export`
  artifact reloaded from its bytes (`CompiledStreamingProcessor`);
* K3 alone at the buffer's shape (channels x buffer), called as the
  processor calls it, 50 calls a reading:
  - `k3_ms`: its kernel's device time a launch from torch.profiler
    (`k3_profiled_launches`: the launches the profiler recorded);
  - `k3_fenced_ms`: CUDA events around one call queued behind a spin on
    the card (median of 20);
  - `k3_queued_ms`: CUDA events around all the calls, issued while the
    card spins, so the card runs them back to back;
  - `k3_call_ms`: CUDA events around 20 calls issued back to back (median
    of 5): the larger of the card's time a call and the host's;
  - `k3_dispatch_ms`: the host's cost of a call, its clock over the calls
    read before the closing synchronisation.

RTF > 1 is faster than real time.  Usage:

    python3 scripts/bench_torch_streaming.py [--weights models/<lstm>.npz]
        [--buffer-sizes 128,512,2048] [--seconds 2.0] [--channels 2]

Prints one table and, last, one JSON line `{"metric": "streaming_rtf", ...}`
with the card's name and power limit.  Needs a card; imports torch, numpy
and the port only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from mod_extraction_tpu_torch.utils.timing import (  # noqa: E402
    card_line,
    cuda_ms_fenced,
    cuda_ms_median,
    cuda_ms_queued,
    device_kernels,
)

SR = 44100.0
KNOBS = dict(lfo_rate=0.2, lfo_depth=0.6667, stereo_offset=0.0)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", default="models/lstm_64__lfo_2dcnn_r4__sim_phaser.npz",
                   help="LSTM effect-model .npz (flax layout)")
    p.add_argument("--buffer-sizes", default="128,512,2048")
    p.add_argument("--seconds", type=float, default=2.0, help="audio seconds per measurement")
    p.add_argument("--channels", type=int, default=2)
    return p.parse_args(argv)


def rtf_per_call(proc, buf: np.ndarray, n_buffers: int) -> float:
    """Plugin-host style: numpy in, one processor call, numpy out, per
    buffer; the first two calls (warm-up: the loaded artifact's eager first
    call of a buffer shape and its capture) are not timed."""
    state = proc.init_state()
    for _ in range(2):
        _, state = proc.process_np(state, buf, **KNOBS)
    t0 = time.perf_counter()
    for _ in range(n_buffers):
        _, state = proc.process_np(state, buf, **KNOBS)
    return n_buffers * buf.shape[-1] / SR / (time.perf_counter() - t0)


def rtf_sustained(proc, buf: np.ndarray, n_buffers: int) -> float:
    """The buffers chained on the card: a Python loop of `process` calls on
    device tensors, one synchronisation at the end."""
    from mod_extraction_tpu_torch.export.streaming import knob_tensors

    dev = proc.device
    x = torch.as_tensor(buf, device=dev)
    knobs = knob_tensors(dev, KNOBS["lfo_rate"], KNOBS["lfo_depth"], KNOBS["stereo_offset"])
    with torch.no_grad():
        state = proc.init_state()
        _, state = proc.process(state, x, *knobs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_buffers):
            _, state = proc.process(state, x, *knobs)
        torch.cuda.synchronize()
    return n_buffers * buf.shape[-1] / SR / (time.perf_counter() - t0)


def k3_args(proc, buf: np.ndarray, rng):
    """K3's arguments as the processor gives them for one buffer: seq
    (C, 2, T) = [lfo; x], the residual x (C, 1, T), a carried state."""
    dev = proc.device
    m = proc.model
    c, t = buf.shape
    x = torch.as_tensor(buf, device=dev)[:, None, :]
    lfo = torch.as_tensor(rng.uniform(0, 1, (c, 1, t)).astype(np.float32), device=dev)
    h0, c0 = (torch.as_tensor((0.1 * rng.standard_normal((c, m.n_hidden))).astype(np.float32), device=dev)
              for _ in range(2))
    w = [p.detach() for p in (m.w_ih, m.w_hh, m.b_gates, m.fc_kernel, m.fc_bias)]
    return (torch.cat([lfo, x], dim=1).contiguous(), x, h0, c0, *w)


def k3_times(proc, buf: np.ndarray, rng, reps: int = 50) -> dict:
    """K3's device time (profiler and fenced events), its time a call back
    to back, and the host's cost of a call at the buffer's shape (see the
    module docstring)."""
    from mod_extraction_tpu_torch.ops import lstm_kernels as lk

    args = k3_args(proc, buf, rng)

    def call():
        return lk.lstm_forward(*args)

    kernels = device_kernels(call, reps)
    k3 = [v for name, v in kernels.items() if name.startswith("lstm_fwd")]
    if len(k3) != 1:
        raise RuntimeError(f"expected one K3 kernel in the profile, got {kernels}")
    (k3_total_ms, k3_launches), = k3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    dispatch_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return {
        "k3_ms": k3_total_ms / k3_launches, "k3_profiled_launches": k3_launches,
        "k3_fenced_ms": cuda_ms_fenced(call),
        "k3_queued_ms": cuda_ms_queued(call, reps, spin_ms=2 * reps * dispatch_ms),
        "k3_call_ms": cuda_ms_median(call), "k3_dispatch_ms": dispatch_ms,
    }


def measure(proc, artifact, buffer_sizes, seconds: float, rng) -> list:
    """One row per buffer size (see the module docstring)."""
    rows = []
    for bs in buffer_sizes:
        n_buffers = max(int(seconds * SR / bs), 2)
        buf = (0.1 * rng.standard_normal((proc.n_channels, bs))).astype(np.float32)
        rows.append({
            "buffer_size": bs,
            "latency_budget_ms": bs / SR * 1e3,
            "n_buffers": n_buffers,
            "rtf_per_call": rtf_per_call(proc, buf, n_buffers),
            "rtf_sustained": rtf_sustained(proc, buf, n_buffers),
            "rtf_artifact_per_call": rtf_per_call(artifact, buf, n_buffers),
            **k3_times(proc, buf, rng),
        })
    return rows


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from mod_extraction_tpu_torch.export.streaming import (
        CompiledStreamingProcessor,
        StreamingEffectModel,
        serialize_streaming_processor,
    )
    from mod_extraction_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    weights = str(ROOT / args.weights)
    proc = StreamingEffectModel(weights, n_channels=args.channels, device=device)
    artifact = CompiledStreamingProcessor(
        serialize_streaming_processor(proc), n_channels=args.channels, n_hidden=proc.n_hidden,
        device=device,
    )
    rows = measure(proc, artifact, [int(s) for s in args.buffer_sizes.split(",")], args.seconds,
                   np.random.default_rng(0))
    for r in rows:
        print(f"buffer {r['buffer_size']:5d} ({r['latency_budget_ms']:7.3f} ms): per-call RTF "
              f"{r['rtf_per_call']:9.2f}  sustained RTF {r['rtf_sustained']:9.2f}  artifact RTF "
              f"{r['rtf_artifact_per_call']:9.2f}")
        print(f"      K3 ms a launch: profiler {r['k3_ms']:.4f} ({r['k3_profiled_launches']} launches recorded), "
              f"fenced {r['k3_fenced_ms']:.4f}, queued {r['k3_queued_ms']:.4f}, issued back to back "
              f"{r['k3_call_ms']:.4f}; host {r['k3_dispatch_ms']:.4f} ms a call")
    print(json.dumps({
        "metric": "streaming_rtf", "card": card_line(), "weights": args.weights,
        "n_hidden": proc.n_hidden, "channels": args.channels, "seconds": args.seconds, "rows": rows,
    }))


if __name__ == "__main__":
    main()
