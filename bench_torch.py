"""Throughput of the PyTorch port's train steps on one NVIDIA GPU (the
counterpart of `bench.py`, built for the H100).

    python3 bench_torch.py [--batch N] [--conv-impl lax|freq_folded|pair]
        [--wgrad-impl xla|pallas|s2b] [--stft-impl auto|rfft|dft|dft_bf16]
        [--act-io float32|compute]
    python3 bench_torch.py --tbptt [--batch N]

Default mode times the port's stage-1 `LFOExtractionTask.train_step`: the
paper Spectral2DCNN (6x64 channels, 256 mels, bf16 convs, seeded init) on
interwoven synthetic batches (flanger, chorus and phaser rows; delay line
1764) of 2 s clips, l1 + 5 fdl1 + 10 sdl1, AdamW; batch 256 unless asked.
`--tbptt` times stage 2's `TBPTTEffectModelingTask.train_step` as
`configs/train_em_sim_flanger_r7.yml` sets it up: the shipped LSTM-64 on the
frozen r7 extractor (bf16), flanger batches (delay line 485), a 1024-sample
warm-up and 83 chunk updates a step; batch 32 unless asked.

Each step gets a batch of its own.  After one warm-up step, each of the
timed steps (5, or 3 with `--tbptt`) is fenced with
`torch.cuda.synchronize()` on the host clock, and `value` is audio seconds
per second of the median step.  One more step runs under
`torch.profiler`, apart from the timed ones: `step_ms` is its wall time,
`busy_ms` the device time of its kernels and copies, and `idle_share` the
rest of its wall.  `mfu` is `train_step_model_flops` (a copy of `bench.py`'s)
over the median step over the card's dense bf16 peak: 989 TFLOP/s for the
H100 SXM at 700 W, or `BENCH_PEAK_TFLOPS`; the line names the card and its
power limit beside it.

`vs_baseline` and `baseline_value` are null: `bench.py`'s baseline is a
per-sample torch loop timed on the host CPU, which says nothing about the
card.  A batch that does not fit in the card's memory raises; the batch is
never shrunk.  Without a card the bench raises; it has no CPU fallback.

Prints one JSON line.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from mod_extraction_tpu_torch.utils.timing import card_line, profile_step

ROOT = Path(__file__).resolve().parent

R7 = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
LSTM64 = ROOT / "models" / "lstm_64__lfo_2dcnn_r7__sim_flanger.npz"
SR, N_SAMPLES = 44100.0, 88200
PAPER = dict(
    in_ch=2, n_samples=N_SAMPLES, sr=SR, n_fft=1024, hop_len=256, n_mels=256,
    kernel_size=(5, 13), out_channels=(64,) * 6, temp_dilations=(1, 1, 2, 4, 8, 16),
    pool_size=(2, 1), freq_mask_amount=0.25, time_mask_amount=0.25,
)
LOSSES = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}
TBPTT = dict(
    warmup_n_samples=1024, step_n_samples=1024, model_smooth_n_frames=8, should_stretch=True,
    max_n_corners=16, discard_invalid_lfos=True, loss_dict={"l1": 1.0, "esr": 0.0, "dc": 0.0},
)
# the card's dense bf16 tensor-core peak (H100 SXM data sheet, 700 W)
PEAK_FLOPS = float(os.environ.get("BENCH_PEAK_TFLOPS", "989")) * 1e12


def train_step_model_flops(
    batch_size: int,
    n_samples: int = 88200,
    hop_len: int = 256,
    n_fft: int = 1024,
    n_mels: int = 256,
    channels: tuple = (2, 64, 64, 64, 64, 64, 64),
    kernel: tuple = (5, 13),
    pool_h: int = 2,
) -> float:
    """Analytic model FLOPs of one stage-1 train step (paper config), as
    `bench.py` counts them: conv trunk forward + dgrad + wgrad (2 FLOPs a
    MAC), the DFT frontend and mel projection (forward only) and the 1x1
    head (forward + backward); elementwise work, LayerNorm, losses and AdamW
    excluded."""
    frames = n_samples // hop_len + 1
    kh, kw = kernel
    mels = n_mels
    conv_macs = 0
    for cin, cout in zip(channels[:-1], channels[1:]):
        conv_macs += cin * cout * kh * kw * mels * frames
        mels //= pool_h
    conv_flops = 3 * 2 * conv_macs
    bins = n_fft // 2 + 1
    dft_flops = 2 * (2 * 2 * frames * n_fft * bins)
    mel_flops = 2 * (2 * frames * bins * n_mels)
    head_flops = 3 * 2 * (channels[-1] * frames)
    return float(batch_size) * (conv_flops + dft_flops + mel_flops + head_flops)


def _require_card() -> torch.device:
    from mod_extraction_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _out_of_memory(batch_size: int, what: str) -> RuntimeError:
    return RuntimeError(
        f"batch {batch_size} does not fit in the card's memory ({what}); the bench does not "
        "shrink it: pass a smaller --batch"
    )


def profile(step: Callable[[], object]) -> Dict[str, float]:
    """`step_ms`, `busy_ms` and `idle_share` of one `step()` under
    torch.profiler (kernels and copies)."""
    wall_ms, busy_ms, _ = profile_step(step)
    return {"step_ms": wall_ms, "busy_ms": busy_ms, "idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}


def time_steps(step: Callable[[int], object], n_steps: int) -> list:
    """Host-clock seconds of steps 1..n_steps, each fenced, after step 0
    (the warm-up: allocator, cuDNN plans, kernel builds)."""
    step(0)
    torch.cuda.synchronize()
    times = []
    for i in range(1, n_steps + 1):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def lfo_line(value, mfu, batch_size, profiled, card, opts) -> dict:
    """The default mode's JSON line: `bench.py`'s keys, then the port's."""
    return {
        "metric": "lfo_train_throughput", "value": value, "unit": "audio_sec/sec/chip",
        "vs_baseline": None, "mfu": mfu, "baseline_value": None, "baseline_reps": 0,
        **opts, "batch_size": batch_size, **profiled, "card": card,
        "peak_tflops": PEAK_FLOPS / 1e12,
    }


def tbptt_line(value, batch_size, updates, profiled, card) -> dict:
    """The `--tbptt` JSON line: `bench.py`'s keys, then the port's."""
    return {
        "metric": "tbptt_train_throughput", "value": value, "unit": "audio_sec/sec/chip",
        "vs_baseline": None, "baseline_value": None, "batch_size": batch_size,
        "updates_per_step": updates, **profiled, "card": card,
    }


def bench_lfo(
    batch_size: int = 256,
    n_steps: int = 5,
    conv_impl: str = "lax",
    wgrad_impl: str = "xla",
    stft_impl: str = "auto",
    act_io_dtype: str = "float32",
) -> dict:
    """Stage-1 train-step throughput on the card; returns the JSON line."""
    device = _require_card()
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        flanger_max_delay_samples,
        make_interwoven_batch,
    )
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig

    opts = dict(conv_impl=conv_impl, wgrad_impl=wgrad_impl, stft_impl=stft_impl, act_io_dtype=act_io_dtype)
    d = flanger_max_delay_samples(30.0, 10.0, SR)
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3), max_delay_samples=d)
    model = Spectral2DCNN(**PAPER, compute_dtype="bfloat16", **opts, seed=0)
    task = LFOExtractionTask(model, cfg, loss_dict=LOSSES, device=device, seed=0)
    batches = [batch_to_torch(make_interwoven_batch(s, batch_size, N_SAMPLES, SR), device)
               for s in range(n_steps + 2)]
    try:
        times = time_steps(lambda i: task.train_step(batches[i]), n_steps)
        profiled = profile(lambda: task.train_step(batches[n_steps + 1]))
    except torch.cuda.OutOfMemoryError as e:
        raise _out_of_memory(batch_size, str(e).splitlines()[0]) from e
    step_s = float(np.median(times))
    value = batch_size * (N_SAMPLES / SR) / step_s
    mfu = train_step_model_flops(batch_size) / step_s / PEAK_FLOPS
    line = lfo_line(value, mfu, batch_size, profiled, card_line(), opts)
    line["median_step_ms"] = step_s * 1e3
    return line


def bench_tbptt(batch_size: int = 32, n_steps: int = 3) -> dict:
    """Stage-2 (TBPTT) train-step throughput on the card; returns the JSON
    line."""
    device = _require_card()
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2,), max_delay_samples=485)
    extractor = load_spectral_2dcnn(str(R7), device=device, **PAPER, compute_dtype="bfloat16")
    task = TBPTTEffectModelingTask(
        load_lstm_effect_model(str(LSTM64), device=device), cfg, lfo_model=extractor,
        device=device, **TBPTT,
    )
    batches = [batch_to_torch(make_synthetic_batch(s, batch_size, N_SAMPLES, SR, "flanger"), device)
               for s in range(n_steps + 2)]
    try:
        times = time_steps(lambda i: task.train_step(batches[i]), n_steps)
        profiled = profile(lambda: task.train_step(batches[n_steps + 1]))
    except torch.cuda.OutOfMemoryError as e:
        raise _out_of_memory(batch_size, str(e).splitlines()[0]) from e
    step_s = float(np.median(times))
    line = tbptt_line(batch_size * (N_SAMPLES / SR) / step_s, batch_size, task.updates_per_batch,
                      profiled, card_line())
    line["median_step_ms"] = step_s * 1e3
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tbptt", action="store_true", help="time the stage-2 TBPTT step")
    p.add_argument("--batch", type=int, default=None, help="256 (stage 1) or 32 (--tbptt)")
    p.add_argument("--conv-impl", default="lax", choices=("lax", "freq_folded", "pair"))
    p.add_argument("--wgrad-impl", default="xla", choices=("xla", "pallas", "s2b"))
    p.add_argument("--stft-impl", default="auto", choices=("auto", "rfft", "dft", "dft_bf16"))
    p.add_argument("--act-io", default="float32", choices=("float32", "compute"))
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.tbptt:
        line = bench_tbptt(args.batch or 32)
    else:
        line = bench_lfo(
            args.batch or 256, conv_impl=args.conv_impl, wgrad_impl=args.wgrad_impl,
            stft_impl=args.stft_impl, act_io_dtype=args.act_io,
        )
    print(json.dumps(line))


if __name__ == "__main__":
    main()
