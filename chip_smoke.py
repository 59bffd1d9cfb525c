"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `mod_extraction_tpu_torch/csrc/` (one
`nvcc` per source, started together), holds each against its plain PyTorch
version on the card, then drives the ported paths through the port's entry
points at full width:

* stage 1, the extractor step: the paper Spectral2DCNN (6x64 channels, 256
  mels, 2 s clips at 44.1 kHz, bf16 convs) holding the shipped r7 weights, a
  `val_step` and a few AdamW `train_step`s on interwoven (flanger + chorus +
  phaser) synthetic batches of 32 (kernels K1, K2);
* the same step in its hand-written weight-gradient configuration,
  `Spectral2DCNN(wgrad_impl="pallas")`: the five 64-channel trunk layers take
  their weight gradient from the CUDA kernel K6 (kernels K1, K2, K6), held
  against the default configuration from the same weights, batch and
  SpecAugment draws, and timed beside the other conv configurations;
* stage 2, TBPTT effect-model training as configured by
  `configs/train_em_sim_flanger_r7.yml`: the shipped LSTM-64 conditioned on
  the frozen r7 extractor (bf16), flanger batches of 32, a 1024-sample
  warm-up and 83 chunk updates of 1024 samples per step, a `val_step` and
  a few `train_step`s (kernels K1, K3, K4, K5);
* stage 2 at H 160, the task of `configs/train_em_sim_chorus_h160.yml`:
  the shipped LSTM-160 chorus model on the frozen r6 extractor, synthetic
  chorus batches of 32 (delay line 1764), the config's AdamW, a `val_step`
  and a few `train_step`s beside the H 64 step, one held against the CPU;
  K3, K4 and K5's walk run on the cluster kernels (one thread-block
  cluster of CTAs for one or two batch rows, W_hh split over their
  registers) (kernels K1, K3, K4, K5);
* serving, the streaming processor of `export/streaming.py`: the shipped
  egfx LSTM-64 and sim_chorus LSTM-160 effect models, mono and stereo,
  driven over random buffers of 1-2048 samples (K3, through its
  `torch.library` operator), held against one full call, against the CPU,
  and through the `torch.export` artifact reloaded on the card; K3 timed
  per buffer beside its latency floor, and the real-time factors;
* `bench_torch.py`'s two measurements: stage 1 at batch 99 and TBPTT at 32,
  the batches of the two configs the fit phases train;
* `fit stage 1` and `fit stage 2`, the training entry point
  (`mod_extraction_tpu_torch.cli.fit`, what `scripts/train_torch.py
  <config>` runs) on two shipped configs, each over a riff corpus written
  here (`data/synthetic.py::write_synthetic_corpus`) with the config's data
  directories pointed at it, three train batches and one val batch an
  epoch, a log line a step, and everything else as shipped:
  `configs/train_lfo_interwoven_all_live_r7.yml` (the paper extractor at
  batch 99 warm-started from the r6 weights, cosine schedule, the
  interwoven flanger + chorus + phaser module on a device corpus: K1, K2)
  and `configs/train_em_sim_flanger_r7.yml` (the LSTM-64 warm-started from
  the r6-conditioned weights on the frozen r7 extractor, lr 1e-5, dry/wet
  pairs whose wet side is the corpus through K1 at fixed parameters: K3,
  K4, K5).  Each fit runs an epoch, then resumes from `last` for a second;
  the launches of each epoch, its metric records, the step count after the
  resume and the optimizer's lr and weight decay are checked, and the
  losses of an epoch whose batches reach the card on a side stream must
  equal those with copies on the compute stream bit for bit.  Each phase
  prints its step times and `audio_sec_per_sec`, and the idle share of one
  iteration of the step loop, profiled by the Trainer's own window
  (`cli.fit(..., profile_steps=...)`), beside the bench at the same batch.

For each path it checks that every kernel of the path ran on it (launch
counts), that the outputs are finite, and that the path on the card agrees
with the same path on the CPU in float32 (plain kernel versions).  K1,
which steps each row a warp's worth of samples at a time where its feedback
allows, is also held at the edges of its steps (delay lines of 2 to 1764
samples, T around a warp and a chunk, delays outside the line) and on both
paths' batches against the sequential walk bit for bit, its per-row step
counts against the plain count, and timed in turns with the walk.

Prints the card's name and power limit, per-step times, a profile of one
step of each path, and on the last two lines a JSON object of per-kernel
measurements and a JSON status line.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
Imports torch, numpy and the port only.

On a machine without a card, the same entry point trains on the CPU with
the config's `custom.cpu_*` sizes: `python scripts/train_torch.py <config>
--device cpu`; the CPU tests hold it against the JAX package
(`python -m pytest tests/test_torch_fit.py tests/test_torch_cli.py
tests/test_torch_data.py`).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import bench_torch
from bench_torch import LOSSES, LSTM64, N_SAMPLES, PAPER, R7, SR, TBPTT
from mod_extraction_tpu_torch.utils.timing import (
    card_line,
    cuda_ms,
    cuda_ms_median,
    cuda_ms_queued,
    device_ms_by_kernel,
    device_ms_per_launch,
    profile_step,
)

ROOT = Path(__file__).resolve().parent
BATCH = 32
N_TRAIN_STEPS = 4  # timed, after one warm-up step
KERNEL_TOL = 1e-4  # max-abs, as scripts/tpu_parity_gate.py holds the TPU kernels
GRAD_REL = 5e-4  # gradient leaves, relative to the leaf's largest magnitude (same source)
LOSS_ATOL, LOSS_RTOL = 1e-6, 1e-4  # LSTM training loss (same source)
VAL_RTOL = 1e-3  # float32 val metrics, card vs CPU (reordered float32 sums)
# stage 2 (configs/train_em_sim_flanger_r7.yml, as bench_torch.py's --tbptt
# sets it up)
TBPTT_CHUNK = TBPTT["step_n_samples"]
N_TBPTT_STEPS = 2  # timed, after one warm-up step
# LSTM parameters after one TBPTT step (84 AdamW updates), card vs CPU: the
# sound runs on the H100 read 1.937e-7; a control step whose gate-bias
# gradient is zeroed reads far above the limit (printed and required below).
# AdamW is blind to a gradient's scale, which the kernel checks above hold.
PARAM_ATOL = 1e-5
# H100 SXM published peaks: HBM bytes/s, float32 operations/s outside the
# tensor cores, dense bf16 operations/s in them.
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
# K6 (conv weight gradient): sums of exact bf16 products in another order
# than the plain version; against float32 its bf16 operands show.  The
# bounds of scripts/tpu_parity_gate.py, relative to the largest |dW|.
WGRAD_PLAIN_REL, WGRAD_F32_REL = 1e-3, 2e-2
# (mel bins entering the layer, time dilation) of the 64-channel trunk layers
# of the paper config: 256 mels halved by each layer's pool, 345 frames
WGRAD_LAYERS = ((128, 1), (64, 2), (32, 4), (16, 8), (8, 16))
N_FRAMES, TRUNK_CH, KF, KT = N_SAMPLES // 256 + 1, 64, 5, 13
N_WGRAD_STEPS = 3  # timed, after one warm-up step
# serving: the streaming processor (K3) on two shipped effect models, the
# register-resident width and a generic one
SERVE_WEIGHTS = (
    ("egfx_ph_2_peak, H 64", ROOT / "models" / "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz"),
    ("sim_chorus, H 160", ROOT / "models" / "lstm_160__lfo_2dcnn_r6__sim_chorus.npz"),
)
SERVE_SAMPLES = 44100  # 1 s of audio a drive
SERVE_MAX_BUFFER = 2048
SERVE_BUFFERS = (128, 512, 2048)  # timed, stereo, H 64
SERVE_KNOBS = dict(lfo_rate=1.3, lfo_depth=0.9)
STREAM_ATOL = 1e-5  # chunked against full, the reloaded artifact against the live path
# the cell state c also within this share of its magnitude: it grows to
# |c| ~ 30, where a float32 ulp is 1.9e-6 (the LFO's phase is carried from
# buffer to buffer, so chunked and full differ in its last bits)
STREAM_C_RTOL = 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def sm_clock_mhz(fn, launches: int = 1500) -> float:
    """The SM clock `nvidia-smi` reports while the card works through a queue
    of `fn` launches."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    torch.cuda.synchronize()
    return float(out[0])


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs(a, b) / max(b.abs().max().item(), 1e-30)


def check_kernels_small(fxk, rng) -> None:
    """K1 in the flanger (d = 485) and chorus (d = 1764) regimes and K2, at
    b*c = 48 recurrences (48 blocks) and T = 6000."""
    dev = "cuda"
    b, c, t = 24, 2, 6000

    def u(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device=dev)

    for d, lo in ((485, 0.0), (1764, 0.367 * 1323)):
        x = u(-0.9, 0.9, (b, c, t))
        delay = u(0, 1, (b, c, t)) * (d - 1 - lo - 1e-3) + lo
        fb, depth, mix = u(0, 0.7, (b, 1, 1)), u(0.25, 1, (b, 1, 1)), u(0.25, 1, (b, 1, 1))
        err = max_abs(fxk.flanger(x, delay, fb, depth, mix, d),
                      fxk.flanger_plain(x, delay, fb, depth, mix, d))
        print(f"[K1 flanger d={d} n={b * c} T={t}] max_abs_err={err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"K1 d={d} disagrees with its plain version: {err}")
    check_k1_edges(fxk, rng)
    x, g = u(-0.9, 0.9, (b, c, t)), u(0.001, 30.0, (b, c, t))
    fb, mix = u(0, 0.7, (b, 1, 1)), u(0.2, 1, (b, 1, 1))
    err = max_abs(fxk.phaser(x, g, fb, mix, 6), fxk.phaser_plain(x, g, fb, mix, 6))
    print(f"[K2 phaser n={b * c} T={t}] max_abs_err={err:.3e}")
    if not err <= KERNEL_TOL:
        fail(f"K2 disagrees with its plain version: {err}")
    check_phaser_scan(fxk, rng)


# K1 at the edges of its steps: delay lines shorter than a warp and the two
# of the paths; T around a warp, around a chunk of the kernel's ring (512)
# and past the ring (4096)
K1_EDGE_D = (2, 17, 485, 1764)
K1_EDGE_T = (1, 31, 32, 33, 511, 513, 6000)
# what K1's row of the kernels line holds besides the common keys
K1_EXTRA = ("steps_max", "steps_total", "cycles_per_step", "walk_ms", "waits")


def k1_edge_delays(rng, t, d) -> np.ndarray:
    """(rows, 1, T) float32 delays, one row per regime of K1's steps:
    random over the line, exactly 0 and d, constant in (0, 1), integer 1, 2
    and 31, an ulp below an integer, a sweep down near 0, and outside the
    line: in (d, 2d), slightly below 0, over (-d, 2d)."""
    f32 = np.float32
    rows = [
        rng.uniform(0, d, t), np.zeros(t), np.full(t, d), np.full(t, 0.37), np.full(t, 1.0),
        np.full(t, 2.0), np.full(t, min(31.0, d - 0.5)),
        np.full(t, np.nextafter(f32(3.0), f32(0))),
        np.nextafter(rng.integers(1, d, t).astype(f32), f32(0)),
        0.5 + 0.49 * np.sin(np.arange(t) / 7.0) ** 2 * min(d - 1, 8),
        rng.uniform(d, 2 * d, t), rng.uniform(-0.01, 0.0, t), rng.uniform(-d, 2 * d, t),
    ]
    return np.stack(rows)[:, None, :].astype(f32)


def check_k1_edges(fxk, rng) -> None:
    """K1's stepped kernel at the edges of its steps: within KERNEL_TOL of
    its plain version, the sequential walk's bits, and the step counts of
    `flanger_step_counts`."""
    worst, n_cases, plain_bits = 0.0, 0, 0
    for d in K1_EDGE_D:
        for t in K1_EDGE_T:
            delay = torch.as_tensor(k1_edge_delays(rng, t, d), device="cuda")
            b = delay.shape[0]

            def u(lo, hi, shape):
                return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device="cuda")

            args = (u(-0.9, 0.9, (b, 1, t)), delay, u(0, 0.7, (b, 1, 1)), u(0.25, 1, (b, 1, 1)),
                    u(0.25, 1, (b, 1, 1)), d)
            out, stats = fxk.flanger(*args, step_counts=True)
            ref = fxk.flanger_plain(*args)
            err = max_abs(out, ref)
            if not err <= KERNEL_TOL:
                fail(f"K1 d={d} T={t} disagrees with its plain version: {err}")
            if not torch.equal(out, fxk.flanger(*args, walk=True)):
                fail(f"K1 d={d} T={t}: the steps do not give the walk's bits")
            want = fxk.flanger_step_counts(delay, d, delay.shape)
            if not torch.equal(stats[:, 0].cpu(), want):
                fail(f"K1 d={d} T={t}: steps {stats[:, 0].tolist()}, the plain count {want.tolist()}")
            worst, n_cases = max(worst, err), n_cases + 1
            plain_bits += int(torch.equal(out, ref))
    print(f"[K1 edges: d {K1_EDGE_D} x T {K1_EDGE_T}, {b} delay regimes each, delays outside [0, d] "
          f"included] worst max_abs_err={worst:.3e}; walk's bits and the plain step counts in all "
          f"{n_cases}; plain version's bits in {plain_bits}")


def k1_args(batch, d: int) -> tuple:
    """K1's arguments as the render makes them from a batch on the card."""
    from mod_extraction_tpu_torch.train.render import flanger_delay_samples
    from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim

    fx = batch["fx"]
    mod_audio = linear_interpolate_last_dim(batch["mod_sig"], N_SAMPLES)[:, None, :]
    return (batch["dry"], flanger_delay_samples(fx, mod_audio, SR), fx["feedback"][:, None, None],
            fx["depth"][:, None, None], fx["mix"][:, None, None], d)


def k1_path_batches() -> list:
    """(label, K1 arguments) of the batches K1 is timed on: stage 1's last
    train batch and stage 2's."""
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        make_interwoven_batch,
        make_synthetic_batch,
    )

    return [
        (f"stage 1 batch, interwoven seed {N_TRAIN_STEPS}, d 1764",
         k1_args(batch_to_torch(make_interwoven_batch(N_TRAIN_STEPS, BATCH, N_SAMPLES, SR)), 1764)),
        (f"stage 2 batch, flanger seed {N_TBPTT_STEPS}, d 485",
         k1_args(batch_to_torch(make_synthetic_batch(N_TBPTT_STEPS, BATCH, N_SAMPLES, SR, "flanger")), 485)),
    ]


def check_k1_path(fxk, args, label: str, plain: bool = True) -> dict:
    """K1 at a path's shape: the stepped kernel against the walk (bits),
    the plain version (KERNEL_TOL) and the plain step counts; the two
    kernels timed in turns (walk, steps, steps, walk); the worst row's
    steps and the cycles a step at the SM clock under load."""
    x, delay, d = args[0], args[1], args[-1]
    n_rows, t_len = x.shape[0] * x.shape[1], x.shape[2]
    out, stats = fxk.flanger(*args, step_counts=True)
    same = torch.equal(out, fxk.flanger(*args, walk=True))
    steps = stats[:, 0].cpu()
    want = fxk.flanger_step_counts(delay, d, x.shape)
    res = dict(steps_max=int(steps.max()), steps_median=float(steps.float().median()),
               steps_total=int(steps.sum()), waits=int(stats[:, 1].sum()), err=None, plain_ms=None,
               bound_ms=4 * (3 * n_rows * t_len + 3 * n_rows) / HBM_BYTES_S * 1e3)
    if plain:
        ref = []
        res["plain_ms"] = cuda_ms(lambda: ref.append(fxk.flanger_plain(*args)), 1)
        res["err"] = max_abs(out, ref[0])
        res["plain_bits"] = torch.equal(out, ref[0])
    turns = {True: [], False: []}
    for walk in (True, False, False, True):
        turns[walk].append(cuda_ms_median(lambda: fxk.flanger(*args, walk=walk)))
    res["ms"], res["walk_ms"] = float(np.mean(turns[False])), float(np.mean(turns[True]))
    res["mhz"] = sm_clock_mhz(lambda: fxk.flanger(*args))
    res["cycles_per_step"] = res["ms"] * 1e3 * res["mhz"] / res["steps_max"]
    print(f"[K1 {label}] walk's bits: {same}; steps = plain count: {torch.equal(steps, want)}; "
          f"max_abs_err={res['err'] if res['err'] is None else format(res['err'], '.3e')} "
          f"(plain version's bits: {res.get('plain_bits')}); steps worst row {res['steps_max']} median "
          f"{res['steps_median']:.0f} total {res['steps_total']} (walk: {t_len} a row); walker waits "
          f"{res['waits']}; in turns ms={res['ms']:.4f} walk_ms={res['walk_ms']:.4f} "
          f"({res['walk_ms'] / res['ms']:.1f}x); {res['cycles_per_step']:.1f} cycles a step at "
          f"{res['mhz']:.0f} MHz; plain_ms={res['plain_ms']}")
    if not same:
        fail(f"K1 {label}: the steps do not give the walk's bits")
    if not torch.equal(steps, want):
        fail(f"K1 {label}: steps differ from the plain count in rows "
             f"{torch.nonzero(steps != want).flatten().tolist()}")
    if plain and not res["err"] <= KERNEL_TOL:
        fail(f"K1 {label} disagrees with its plain version: {res['err']}")
    return res


# K2 at the edges of its chunked scan: T around the chunk and past a block's
# span (32 chunks); 1, 6 and 8 stages take the scan, 12 the sequential walk
PHASER_EDGE_T = (1, 127, 128, 129, 6000)
PHASER_EDGE_STAGES = (1, 6, 8, 12)


def phaser_extremes(rng, b, t, fb=0.7, g_lo=0.001, g_hi=32.0):
    """K2 arguments with g swept log-uniformly over [g_lo, g_hi] (tan(0.49
    pi) ~ 32 is the top of the phaser's range) and a fixed feedback: the
    corners of the scan's numerics."""
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (b, 1, t)).astype(np.float32), device="cuda")
    ph = rng.uniform(0, 2 * np.pi, (b, 1, 1))
    lfo = 0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * np.arange(t) / SR + ph)
    g = torch.as_tensor((g_lo * (g_hi / g_lo) ** lfo).astype(np.float32), device="cuda")
    mix = torch.as_tensor(rng.uniform(0.2, 1.0, (b, 1, 1)).astype(np.float32), device="cuda")
    return x, g, torch.full((b, 1, 1), fb, device="cuda"), mix


def walk64_chunk_states(x, g, fb, n_stages: int, chunk: int) -> np.ndarray:
    """The state (s_1 .. s_n, last) entering every chunk of a float64 walk
    of the cascade, numpy on the CPU, rows at once: (rows, chunks, n + 1)."""
    x64 = x.reshape(-1, x.shape[-1]).double().cpu().numpy()
    g64 = g.expand(x.shape).reshape(x64.shape).double().cpu().numpy()
    big_g = g64 / (1.0 + g64)
    f = fb.expand(x.shape[0], x.shape[1], 1).reshape(-1).double().cpu().numpy()
    rows, t = x64.shape
    s = np.zeros((rows, n_stages))
    last = np.zeros(rows)
    states = np.zeros((rows, -(-t // chunk), n_stages + 1))
    for i in range(t):
        if i % chunk == 0:
            states[:, i // chunk, :n_stages], states[:, i // chunk, n_stages] = s, last
        gi = big_g[:, i]
        u = x64[:, i] + f * last
        for k in range(n_stages):
            v = gi * (u - s[:, k])
            lp = v + s[:, k]
            s[:, k] = lp + v
            u = 2.0 * lp - u
        last = u
    return states


def phaser_scan_numerics(fxk, args, n_stages: int = 6, chunk: int | None = None, z64=None) -> tuple:
    """(max|P_c| over the chunks that are joined, max|z_c|, worst z_c error
    against a float64 walk) of K2's scan on these arguments, in chunks of
    `chunk` (the kernel's own by default); `z64`: the walk's states, if
    already at hand."""
    chunk = chunk or fxk.PHASER_CHUNK
    _, p, _, z = fxk.phaser(*args, n_stages, chunk_states=True, chunk=chunk)
    if z64 is None:
        z64 = walk64_chunk_states(args[0], args[1], args[2], n_stages, chunk)
    max_p = p[:, :-1].abs().max().item() if p.shape[1] > 1 else 0.0
    return max_p, z.abs().max().item(), float(np.abs(z.double().cpu().numpy() - z64).max())


def check_phaser_scan(fxk, rng) -> None:
    """K2 against its plain version at the edges of the scan (T, stages),
    with feedback 0.7 and g over [0.001, 32], then at the full (32, 88200)
    shape there, with the scan's own numbers."""
    worst = 0.0
    for n_stages in PHASER_EDGE_STAGES:
        for t in PHASER_EDGE_T:
            args = phaser_extremes(rng, 5, t)
            err = max_abs(fxk.phaser(*args, n_stages), fxk.phaser_plain(*args, n_stages))
            if not err <= KERNEL_TOL:
                fail(f"K2 n_stages={n_stages} T={t} (fb 0.7, g 0.001-32) disagrees with its plain version: {err}")
            worst = max(worst, err)
    print(f"[K2 edges: stages {PHASER_EDGE_STAGES} x T {PHASER_EDGE_T}, fb 0.7, g 0.001-32, chunk "
          f"{fxk.PHASER_CHUNK}] worst max_abs_err={worst:.3e}")
    args = phaser_extremes(rng, BATCH, N_SAMPLES)
    err = max_abs(fxk.phaser(*args, 6), fxk.phaser_plain(*args, 6))
    max_p, max_z, z_err = phaser_scan_numerics(fxk, args)
    print(f"[K2 n={BATCH} T={N_SAMPLES} fb 0.7, g 0.001-32] max_abs_err={err:.3e} max|P_c|={max_p:.4f} "
          f"max|z_c|={max_z:.4f} z_c vs float64 walk {z_err:.3e}")
    if not err <= KERNEL_TOL:
        fail(f"K2 at full shape with fb 0.7 and g 0.001-32 disagrees with its plain version: {err}")
    if not z_err <= KERNEL_TOL:
        fail(f"K2's chunk entry states are {z_err} from a float64 walk")


def profile_train_step(task, batch, label: str, top: int = 15) -> tuple:
    """torch.profiler over one train step: device time by kernel (top
    entries) and the device's busy share of the step's wall time; returns
    (wall ms, busy ms)."""
    wall_ms, busy_ms, events = profile_step(lambda: task.train_step(batch))
    print(f"[profile {label} train_step] wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")
    return wall_ms, busy_ms


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, n_bytes, n_ops, library_ms,
               ops_rate=F32_OPS_S):
    """One entry of the `kernels` JSON line; the bound is the larger of the
    bytes over the HBM rate and the operations over the peak rate for their
    type (float32 outside the tensor cores unless `ops_rate` says bf16)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# stage 1: the extractor step (K1, K2)
# ---------------------------------------------------------------------------


def run_stage1(fxk, rng) -> list:
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        flanger_max_delay_samples,
        make_interwoven_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops.fx import phaser_coefficients
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig, phaser_params

    # -- kernels against their plain versions, small regimes
    check_kernels_small(fxk, rng)

    # -- the main path, counted
    d = flanger_max_delay_samples(30.0, 10.0, SR)  # 1764: the interwoven line
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3), max_delay_samples=d)
    model = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = LFOExtractionTask(model, cfg, loss_dict=LOSSES, device="cuda", seed=0)
    val_batch = batch_to_torch(make_interwoven_batch(1000, BATCH, N_SAMPLES, SR))
    train_batches = [
        batch_to_torch(make_interwoven_batch(s, BATCH, N_SAMPLES, SR))
        for s in range(N_TRAIN_STEPS + 1)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fxk.reset_launch_counts()
    val = {k: v.item() for k, v in task.val_step(val_batch).items()}
    print(f"[val_step r7 bf16 b={BATCH}] " + " ".join(f"{k}={v:.6f}" for k, v in sorted(val.items())))
    metrics = task.train_step(train_batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    step_s = []
    for i in range(1, N_TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        metrics = task.train_step(train_batches[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        print(f"[train_step {i}] loss={metrics['loss'].item():.6f} wall={step_s[-1] * 1e3:.2f} ms")
    launches = dict(fxk.LAUNCHES)
    print(f"[stage 1 main path] launches={launches}")

    finite = all(math.isfinite(v) for v in val.values()) and all(
        math.isfinite(v.item()) for v in metrics.values()
    )
    if not finite:
        fail(f"non-finite metrics: val={val} train={metrics}")
    if not (launches["flanger"] > 0 and launches["phaser"] > 0):
        fail(f"a kernel of the main path was never launched: {launches}")
    if not all(torch.isfinite(p).all().item() for p in task.model.parameters()):
        fail("non-finite parameters after the train steps")
    step_mean = float(np.mean(step_s))
    audio_s = BATCH * N_SAMPLES / SR
    print(f"[stage 1 train] batch={BATCH} steps={N_TRAIN_STEPS} mean_step_ms={step_mean * 1e3:.3f} "
          f"min_step_ms={min(step_s) * 1e3:.3f} audio_s_per_s={audio_s / step_mean:.2f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # -- the whole path against the CPU (float32, plain kernels)
    ref_batch_np = make_interwoven_batch(2000, 3, N_SAMPLES, SR)
    ref_cfg = dict(PAPER, compute_dtype="float32")
    ref = {}
    for dev in ("cuda", "cpu"):
        t = LFOExtractionTask(
            load_spectral_2dcnn(str(R7), device=dev, **ref_cfg), cfg,
            loss_dict=LOSSES, device=dev,
        )
        ref[dev] = {k: v.item() for k, v in t.val_step(batch_to_torch(ref_batch_np, dev)).items()}
    for k in ref["cpu"]:
        if not math.isclose(ref["cuda"][k], ref["cpu"][k], rel_tol=VAL_RTOL, abs_tol=1e-6):
            fail(f"val_step {k}: card {ref['cuda'][k]} vs CPU {ref['cpu'][k]}")
    print("[val_step f32 card vs CPU, b=3] " + " ".join(
        f"{k}={ref['cuda'][k]:.6f}/{ref['cpu'][k]:.6f}" for k in sorted(ref["cpu"])))

    # -- each kernel at the main path's shapes (the last train batch)
    tb = train_batches[-1]
    dry, fx = tb["dry"], tb["fx"]
    n_lanes, t_len = dry.shape[0] * dry.shape[1], dry.shape[2]
    k1 = check_k1_path(fxk, k1_args(tb, d), f"stage 1 batch, interwoven seed {N_TRAIN_STEPS}, d {d}")
    k1_row = kernel_row(
        "flanger_delay_line", "mod_extraction_tpu_torch/csrc/fx.cu",
        "mod_extraction_tpu/ops/pallas_fx.py:45", launches["flanger"], k1["err"], k1["ms"],
        k1["plain_ms"], 4 * (3 * n_lanes * t_len + 3 * n_lanes), 16 * n_lanes * t_len, None,
    )
    k1_row.update({k: k1[k] for k in K1_EXTRA})
    pp = phaser_params(fx, SR)
    g, _ = phaser_coefficients(N_SAMPLES, SR, pp["rate_hz"], pp["depth"],
                               pp["centre_frequency_hz"], pp["phase"])
    ph_args = (dry, g[:, None, :], pp["feedback"][:, None, None], pp["mix"][:, None, None], 6)
    out = fxk.phaser(*ph_args)
    ms = cuda_ms_median(lambda: fxk.phaser(*ph_args))
    ref_out = []
    plain_ms = cuda_ms(lambda: ref_out.append(fxk.phaser_plain(*ph_args)), 1)
    err = max_abs(out, ref_out[0])
    print(f"[phaser_allpass n={n_lanes} T={t_len}] max_abs_err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f}")
    if not err <= KERNEL_TOL:
        fail(f"phaser_allpass at the main-path shapes disagrees with its plain version: {err}")
    max_p, max_z, z_err = phaser_scan_numerics(fxk, ph_args[:4])
    print(f"[phaser_allpass scan on the path's data, chunk {fxk.PHASER_CHUNK}] max|P_c|={max_p:.4f} "
          f"max|z_c|={max_z:.4f} z_c vs float64 walk {z_err:.3e}")
    k2_row = kernel_row(
        "phaser_allpass", "mod_extraction_tpu_torch/csrc/fx.cu", "mod_extraction_tpu/ops/pallas_fx.py:156",
        launches["phaser"], err, ms, plain_ms, 4 * (3 * n_lanes * t_len + 2 * n_lanes),
        43 * n_lanes * t_len, None,
    )
    k2_row.update(chunk=fxk.PHASER_CHUNK, max_p=max_p, z_err=z_err)
    rows = [k1_row, k2_row]
    # -- where one full-width train step spends the card's time
    profile_train_step(task, train_batches[1], "stage 1")
    return rows


# ---------------------------------------------------------------------------
# stage 1 in its hand-written weight-gradient configuration (K1, K2, K6)
# ---------------------------------------------------------------------------


def wgrad_ops_bytes(b, f, t, ci, co, kf=KF, kt=KT):
    """(bf16 operations, bytes) one K6 launch needs: two operations per
    product of the contraction; x and dy read once in bf16, dW written once
    in float32."""
    return 2 * b * f * t * kf * kt * ci * co, 2 * b * f * t * (ci + co) + 4 * kf * kt * ci * co


def library_wgrad(x, g, dil):
    """One library call that computes K6's function (bf16, the weight
    gradient alone), in the time-phase form `conv2d_same` gives a dilated
    layer; the operands are prepared outside the timed region."""
    from mod_extraction_tpu_torch.ops.conv import time_phases

    xph, gph = time_phases(x, dil).contiguous(), time_phases(g, dil).contiguous()
    w = torch.empty(g.shape[1], x.shape[1], KF, KT, dtype=x.dtype, device=x.device)
    return lambda: torch.ops.aten.convolution_backward(
        gph, xph, w, None, [1, 1], [KF // 2, KT // 2], [1, 1], False, [0, 0], 1,
        [False, True, False],
    )[1]


def check_wgrad(ck, x, g, dil, label):
    """K6 against its plain version and the float32 reference, and two
    launches against each other; returns (error vs plain relative to the
    largest |dW|, the plain version's ms)."""
    got = ck.conv2d_wgrad_tapcat(x, g, KF, KT, dil)
    again = ck.conv2d_wgrad_tapcat(x, g, KF, KT, dil)
    ref_out = []
    plain_ms = cuda_ms(lambda: ref_out.append(ck.conv2d_wgrad_plain(x, g, KF, KT, dil)), 1)
    ref = ck.conv2d_wgrad_reference(x, g, KF, KT, dil)
    scale = ref.abs().max().item()
    e_plain, e_ref = max_abs(got, ref_out[0]) / scale, max_abs(got, ref) / scale
    same = torch.equal(got, again)
    print(f"[K6 {label}] vs plain {e_plain:.3e} (limit {WGRAD_PLAIN_REL})  vs float32 reference "
          f"{e_ref:.3e} (limit {WGRAD_F32_REL})  relaunch bit-identical: {same}")
    if not e_plain <= WGRAD_PLAIN_REL:
        fail(f"K6 {label} disagrees with its plain version: {e_plain}")
    if not e_ref <= WGRAD_F32_REL:
        fail(f"K6 {label} disagrees with the float32 reference: {e_ref}")
    if not same:
        fail(f"K6 {label}: two launches on the same inputs differ")
    return e_plain, plain_ms


def run_stage1_kernel_wgrad(fxk, ck, rng) -> list:
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        flanger_max_delay_samples,
        make_interwoven_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig

    def rand(*shape):
        a = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        return torch.as_tensor(a, device="cuda").to(torch.bfloat16)

    # -- the kernel against its plain version: a small shape with ragged
    #    edges (T a multiple of no tile, few channels), then the path's shapes
    check_wgrad(ck, rand(2, 16, 6, 57), rand(2, 8, 6, 57), 4, "small B=2 ci=16 co=8 F=6 T=57 dil=4")
    check_wgrad(ck, rand(2, 64, 6, 352), rand(2, 64, 6, 352), 16, "B=2 F=6 T=352 dil=16 (aligned T, shifts past a tile)")
    check_wgrad(ck, rand(1, 64, 1, N_FRAMES), rand(1, 64, 1, N_FRAMES), 1, f"B=1 F=1 T={N_FRAMES} dil=1")
    layers = []
    for f, dil in WGRAD_LAYERS:
        x, g = rand(BATCH, TRUNK_CH, f, N_FRAMES), rand(BATCH, TRUNK_CH, f, N_FRAMES)
        label = f"B={BATCH} F={f} T={N_FRAMES} dil={dil}"
        err, plain_ms = check_wgrad(ck, x, g, dil, label)
        n_ops, n_bytes = wgrad_ops_bytes(BATCH, f, N_FRAMES, TRUNK_CH, TRUNK_CH)
        ms = cuda_ms_median(lambda: ck.conv2d_wgrad_tapcat(x, g, KF, KT, dil))
        library_ms = cuda_ms_median(library_wgrad(x, g, dil))
        bound_ms = max(n_ops / BF16_OPS_S, n_bytes / HBM_BYTES_S) * 1e3
        print(f"[K6 {label}] ms={ms:.3f} bound_ms={bound_ms:.3f} (operations) bound/ms={bound_ms / ms:.3f} "
              f"tflops={n_ops / ms / 1e9:.1f} library_ms={library_ms:.3f} plain_ms={plain_ms:.1f}")
        layers.append(dict(bins=f, dil=dil, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, err=err, n_ops=n_ops, n_bytes=n_bytes))
        del x, g
    torch.cuda.empty_cache()

    # -- the main path, counted per step
    d = flanger_max_delay_samples(30.0, 10.0, SR)
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3), max_delay_samples=d)

    def make_task(**opts):
        model = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16", **opts)
        return LFOExtractionTask(model, cfg, loss_dict=LOSSES, device="cuda", seed=0)

    batches = [
        batch_to_torch(make_interwoven_batch(100 + s, BATCH, N_SAMPLES, SR))
        for s in range(N_WGRAD_STEPS + 1)
    ]
    task = make_task(wgrad_impl="pallas")
    keys = ("flanger", "phaser", "conv_wgrad")
    per_step = dict(flanger=1, phaser=1, conv_wgrad=len(WGRAD_LAYERS))
    total = dict.fromkeys(keys, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i, tb in enumerate(batches):
        fxk.reset_launch_counts()
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = task.train_step(tb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = {**fxk.LAUNCHES, **ck.LAUNCHES}
        if any(c[k] != per_step[k] for k in keys):
            fail(f"wgrad_impl='pallas' train_step {i}: launches {c}, expected {per_step}")
        total = {k: total[k] + c[k] for k in keys}
        if i > 0:  # step 0 warms up the allocator and the cuDNN plans
            step_s.append(dt)
        print(f"[wgrad=pallas train_step {i}] loss={metrics['loss'].item():.6f} wall={dt * 1e3:.2f} ms "
              f"launches={c}")
        if not all(math.isfinite(v.item()) for v in metrics.values()):
            fail(f"non-finite metrics in the wgrad_impl='pallas' step: {metrics}")
    if not all(torch.isfinite(p).all().item() for p in task.model.parameters()):
        fail("non-finite parameters after the wgrad_impl='pallas' train steps")
    print(f"[stage 1 wgrad=pallas main path] launches={total} mean_step_ms={np.mean(step_s) * 1e3:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # -- one backward in this configuration and one in the default, from the
    #    same weights, batch and SpecAugment draws
    draws = torch.tensor([0.31, 0.62, 0.47, 0.15])
    grads = {}
    for name, opts in (("pallas", dict(wgrad_impl="pallas")), ("default", {})):
        t = make_task(**opts)
        t.model.train()
        loss, _ = t._loss(batches[0], None, draws)
        loss.backward()
        grads[name] = (loss.item(), {k: p.grad.detach().clone() for k, p in t.model.named_parameters()})
        del t
    (loss_k, g_k), (loss_d, g_d) = grads["pallas"], grads["default"]
    worst = max(
        (rel_err(g_k[k], g_d[k]), k) for k in g_d if k.startswith("convs.") and k.endswith(".weight")
    )
    others = max(rel_err(g_k[k], g_d[k]) for k in g_d if not k.endswith(".weight") or k.startswith("out."))
    print(f"[wgrad=pallas vs default backward] loss {loss_k:.8f}/{loss_d:.8f} conv weight gradients "
          f"max_rel={worst[0]:.3e} ({worst[1]}; limit {WGRAD_F32_REL}) other leaves max_rel={others:.3e}")
    if loss_k != loss_d:
        fail(f"the two configurations share their forward, yet the losses differ: {loss_k} vs {loss_d}")
    if not worst[0] <= WGRAD_F32_REL:
        fail(f"conv weight gradient {worst[1]} of the kernel configuration differs by {worst[0]}")
    if not others <= WGRAD_F32_REL:
        fail(f"a gradient that K6 does not compute differs between the configurations: {others}")

    # -- the train step in each conv configuration, taking turns
    configs = {
        "wgrad=xla (default)": {}, "wgrad=pallas": dict(wgrad_impl="pallas"),
        "wgrad=s2b": dict(wgrad_impl="s2b"), "conv=pair": dict(conv_impl="pair"),
    }
    tasks = {name: make_task(**opts) for name, opts in configs.items()}
    times = {name: [] for name in configs}
    for rnd in range(N_WGRAD_STEPS + 1):
        for name, t in tasks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(batches[rnd])
            torch.cuda.synchronize()
            if rnd > 0:
                times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"[stage 1 train_step {name}] batch={BATCH} mean_step_ms={np.mean(ts) * 1e3:.3f} "
              f"min_step_ms={min(ts) * 1e3:.3f}")
    profile_train_step(tasks["wgrad=pallas"], batches[1], "stage 1 wgrad=pallas")

    def total_of(key):
        return sum(layer[key] for layer in layers)

    row = kernel_row(
        "conv_wgrad_tapcat", "mod_extraction_tpu_torch/csrc/conv_wgrad.cu",
        "mod_extraction_tpu/ops/pallas_conv.py:51", total["conv_wgrad"],
        max(layer["err"] for layer in layers), total_of("ms"), total_of("plain_ms"),
        total_of("n_bytes"), total_of("n_ops"), total_of("library_ms"), ops_rate=BF16_OPS_S,
    )
    # ms, plain_ms, bound_ms and library_ms are sums over the five launches of
    # one train step; max_abs_err is relative to the largest |dW|
    row["layers"] = [{k: layer[k] for k in ("bins", "dil", "ms", "plain_ms", "library_ms", "bound_ms")}
                     for layer in layers]
    return [row]


# ---------------------------------------------------------------------------
# stage 2: TBPTT effect-model training (K1, K3, K4, K5)
# ---------------------------------------------------------------------------


def lstm_inputs(rng, b, t, hid, in_dim=2):
    """Random K3/K4 arguments with a non-zero initial state."""
    k = 1.0 / math.sqrt(hid)

    def u(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device="cuda")

    seq = u(0.0, 1.0, (b, in_dim, t))
    seq[:, -1] = torch.as_tensor((0.3 * rng.standard_normal((b, t))).astype(np.float32), device="cuda")
    return dict(
        seq=seq, xres=seq[:, -1:].contiguous(), h0=u(-0.3, 0.3, (b, hid)), c0=u(-0.3, 0.3, (b, hid)),
        w_ih=u(-k, k, (in_dim, 4 * hid)), w_hh=u(-k, k, (hid, 4 * hid)), b=u(-k, k, (4 * hid,)),
        fc_k=u(-k, k, (hid, 1)), fc_b=u(-k, k, (1,)),
    )


def check_lstm_kernels(lk, a, dh_seed: int, label: str) -> None:
    """K3, K4 (its saved gate activations too) and K5 (dseq, dh0, dc0, the
    weight gradients and its walk's gate cotangents) against their plain
    versions on the same inputs, two K5 launches against each other, and the
    K4/K5 training pair against autograd through the plain forward."""
    ref = lk.lstm_forward_plain(**a, save_states=True)  # y, hn, cn, hs, cs, gates
    err3 = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(**a), ref[:3]))
    out4 = lk.lstm_train_forward(**a)
    err4 = max(max_abs(x, y) for x, y in zip(out4[:5], ref[:5]))
    err_gates = max_abs(out4[5], ref[5])
    b, _, t = a["seq"].shape
    hid = a["w_hh"].shape[0]
    def plan_name(plan):
        kernel, n, rows = plan
        return f"{kernel}{f' ({n} CTAs, {rows} rows)' if kernel == 'cluster' else ''}"

    label = f"{label}, {plan_name(lk.forward_kernel(hid, b))} forward, " \
            f"{plan_name(lk.backward_kernel(hid, b))} backward"
    gen = torch.Generator(device="cuda").manual_seed(dh_seed)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=gen)
    dhn, dcn = (torch.randn(b, hid, device="cuda", generator=gen) for _ in range(2))
    bargs = (a["seq"], *ref[3:6], a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, dhn, dcn)
    got5, again5 = lk._backward_launch(*bargs), lk._backward_launch(*bargs)
    err5 = max(rel_err(x, y) for x, y in zip(got5, lk.lstm_backward_plain(*bargs, with_dgates=True)))
    same5 = all(torch.equal(x, y) for x, y in zip(got5, again5))

    x, lat = a["seq"][:, 1:].contiguous(), a["seq"][:, :1].contiguous()
    tgt = torch.randn(b, 1, t, device="cuda", generator=gen)
    names = ("w_ih", "w_hh", "b", "fc_k", "fc_b")

    def loss_and_grads(fn):
        leaves = [a[n].clone().requires_grad_() for n in names]
        xs, ls, h0, c0 = (v.clone().requires_grad_() for v in (x, lat, a["h0"], a["c0"]))
        y, hn, cn = fn(*leaves, xs, ls, h0, c0)
        loss = ((y - tgt) ** 2).mean() + (hn**2).mean() + (cn**2).mean()
        loss.backward()
        return loss.item(), [v.grad for v in (*leaves, xs, ls, h0, c0)]

    def plain(w_ih, w_hh, b_, fc_k, fc_b, xs, ls, h0, c0):
        return lk.lstm_forward_plain(torch.cat([ls, xs], 1), xs, h0, c0, w_ih, w_hh, b_, fc_k, fc_b)

    loss_k, g_k = loss_and_grads(lk.lstm_effect_model_train)
    loss_p, g_p = loss_and_grads(plain)
    err_g = max(rel_err(x, y) for x, y in zip(g_k, g_p))
    print(f"[{label}] K3 max_abs={err3:.3e} K4 max_abs={err4:.3e} K4 saved gates max_abs={err_gates:.3e} "
          f"K5 max_rel={err5:.3e} K5 relaunch bit-identical: {same5} "
          f"loss {loss_k:.8f}/{loss_p:.8f} grads max_rel={err_g:.3e}")
    if not (err3 <= KERNEL_TOL and err4 <= KERNEL_TOL):
        fail(f"{label}: K3/K4 disagree with their plain versions: {err3}, {err4}")
    if not err_gates <= KERNEL_TOL:
        fail(f"{label}: K4's saved gate activations disagree with the plain version's: {err_gates}")
    if not err5 <= GRAD_REL:
        fail(f"{label}: K5 disagrees with its plain version: {err5}")
    if not same5:
        fail(f"{label}: two K5 launches on the same inputs differ")
    if not abs(loss_k - loss_p) <= LOSS_ATOL + LOSS_RTOL * abs(loss_p):
        fail(f"{label}: training loss {loss_k} vs {loss_p}")
    if not err_g <= GRAD_REL:
        fail(f"{label}: training gradients disagree with autograd of the plain version: {err_g}")


def long_walk_drift(lk, k3_args):
    """K3's final (hn, cn) and its y, batch row 0, against the plain version
    walked in float64 on the CPU: (state max-abs, y max-abs)."""
    y_card, hn_card, cn_card = lk.lstm_forward(*k3_args)
    row64 = [a[:1].double().cpu() for a in k3_args[:4]] + [a.double().cpu() for a in k3_args[4:]]
    y64, hn64, cn64 = lk.lstm_forward_plain(*row64)
    state = max(max_abs(hn_card[:1].double().cpu(), hn64), max_abs(cn_card[:1].double().cpu(), cn64))
    return state, max_abs(y_card[:1].double().cpu(), y64)


def library_lstm(w_ih, w_hh, b) -> torch.nn.LSTM:
    """`torch.nn.LSTM` on the card holding the same weights (no fc head)."""
    lib = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0]).to("cuda")
    with torch.no_grad():
        lib.weight_ih_l0.copy_(w_ih.T)
        lib.weight_hh_l0.copy_(w_hh.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    return lib


def lstm_path_rows(lk, k3_args, k4_args, k5_args, launches: dict, suffix: str = "") -> tuple:
    """K3, K4 and K5 at a path's shapes, on its own data: each against its
    plain version and timed (medians of 5 x 20 calls) beside
    `torch.nn.LSTM` holding the same weights and state (forward for K3 and
    K4, forward + backward for K5, and for K5 also the library's backward
    alone, its forward's graph kept; no fc head).  Returns the kernels
    line's rows (names + `suffix`, `launches` by counter) and {counter:
    (ms, library ms)}."""
    b, in_dim, t_len = k4_args[0].shape
    hid = k4_args[5].shape[0]
    lib_lstm = library_lstm(*k3_args[4:7])
    lib_state = (k4_args[2][None].contiguous(), k4_args[3][None].contiguous())
    # torch.nn.LSTM takes (T, B, C), contiguous
    warm_tbc = k3_args[0].permute(2, 0, 1).contiguous()
    chunk_tbc = k4_args[0].permute(2, 0, 1).contiguous()

    def lib_fwd(seq_tbc):
        with torch.no_grad():
            lib_lstm(seq_tbc, lib_state)

    seq_tbc_grad = chunk_tbc.clone().requires_grad_()

    def lib_fwd_bwd():
        out_, _ = lib_lstm(seq_tbc_grad, lib_state)
        out_.sum().backward()

    out_kept, _ = lib_lstm(seq_tbc_grad, lib_state)
    leaves = [seq_tbc_grad, *lib_lstm.parameters()]
    ones = torch.ones_like(out_kept)

    def lib_bwd():
        torch.autograd.grad(out_kept, leaves, ones, retain_graph=True)

    rows, times = [], {}
    specs = [
        ("lstm_forward", "lstm_effect_model", lk.lstm_forward, lambda: lk.lstm_forward_plain(*k3_args),
         k3_args, "mod_extraction_tpu/ops/pallas_lstm.py:52", lambda: lib_fwd(warm_tbc),
         lstm_ops_bytes(b, t_len, hid, in_dim, 1)),
        ("lstm_train_forward", "lstm_effect_model_train_fwd", lk.lstm_train_forward,
         lambda: lk.lstm_forward_plain(*k4_args, save_states=True), k4_args,
         "mod_extraction_tpu/ops/pallas_lstm.py:141", lambda: lib_fwd(chunk_tbc),
         lstm_ops_bytes(b, t_len, hid, in_dim, 1, save_states=True)),
        ("lstm_backward", "lstm_effect_model_train_bwd", lk.lstm_backward,
         lambda: lk.lstm_backward_plain(*k5_args), k5_args,
         "mod_extraction_tpu/ops/pallas_lstm.py:198", lib_fwd_bwd,
         lstm_ops_bytes(b, t_len, hid, in_dim, 1, backward=True)),
    ]
    for key, name, kern, plain, args, replaces, lib_fn, (n_ops, n_bytes) in specs:
        got = kern(*args)
        ms = cuda_ms_median(lambda: kern(*args))
        ref_out = []
        plain_ms = cuda_ms(lambda: ref_out.append(plain()), 1)
        if key == "lstm_backward":
            err = max(rel_err(x, y_) for x, y_ in zip(got, ref_out[0]))
            tol = GRAD_REL
        else:
            err = max(max_abs(x, y_) for x, y_ in zip(got, ref_out[0]))
            tol = KERNEL_TOL
        library_ms = cuda_ms_median(lib_fn)
        times[key] = (ms, library_ms)
        print(f"[{name} B={b} T={args[0].shape[-1]} H={hid}] err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f} "
              f"library_ms={library_ms:.3f} (torch.nn.LSTM, no fc head; medians of 5 x 20 calls)")
        if not err <= tol:
            fail(f"{name} at H {hid}, the main-path shapes, disagrees with its plain version: {err}")
        rows.append(kernel_row(
            name + suffix, "mod_extraction_tpu_torch/csrc/lstm.cu", replaces, launches[key], err, ms,
            plain_ms, n_bytes, n_ops, library_ms,
        ))
    # the pair a training user pays for: the library's forward + backward call
    # holds its own forward, so it stands beside K4 + K5
    pair_ms = times["lstm_train_forward"][0] + times["lstm_backward"][0]
    bwd_ms = cuda_ms_median(lib_bwd)
    rows[2]["library_bwd_only_ms"] = bwd_ms
    print(f"[K4 + K5 B={b} T={t_len} H={hid}] ms={pair_ms:.3f} beside torch.nn.LSTM forward + backward "
          f"{times['lstm_backward'][1]:.3f}; K5 {times['lstm_backward'][0]:.3f} beside its backward alone "
          f"{bwd_ms:.3f}; K3 {times['lstm_forward'][0]:.3f} and K4 "
          f"{times['lstm_train_forward'][0]:.3f} beside its forward {times['lstm_forward'][1]:.3f} / "
          f"{times['lstm_train_forward'][1]:.3f}")
    return rows, times


def path_lstm_args(lk, task, val_batch) -> tuple:
    """The arguments K3, K4 and K5 take on a TBPTT path, from its own val
    batch: the warm-up (K3), the first chunk (K4, from the warmed-up state),
    K5 on that chunk with the l1 loss's cotangent through the fc head, and
    K3 over the whole val_step clip."""
    from mod_extraction_tpu_torch.models.lstm import lstm_init_state

    dry, wet, mod_sr, _, weights = task._prepare(val_batch)
    em = task.effect_model
    w = [p.detach() for p in (em.w_ih, em.w_hh, em.b_gates, em.fc_kernel, em.fc_bias)]
    warm, chunk = task.warmup_n_samples, task.step_n_samples
    end = warm + task.updates_per_batch * chunk
    b = dry.shape[0]
    h0, c0 = lstm_init_state(b, em.n_hidden, "cuda")
    seq_full = torch.cat([mod_sr[:, :, :end], dry[:, :, :end]], 1).contiguous()
    k3_args = (seq_full[:, :, :warm].contiguous(), dry[:, :, :warm].contiguous(),
               h0, c0, *w)  # the warm-up of every train step
    _, hw, cw = lk.lstm_forward(*k3_args)
    sl = slice(warm, warm + chunk)
    k4_args = (seq_full[:, :, sl].contiguous(), dry[:, :, sl].contiguous(), hw, cw, *w)
    y, _, _, hs, cs, gates = lk.lstm_train_forward(*k4_args)
    dz = torch.sign(y - wet[:, :, sl]) * weights[:, None, None] / (weights.sum().clamp(min=1e-8) * chunk)
    dz = dz * (1 - y * y)
    dh_in = torch.einsum("ho,bot->bth", w[3], dz).contiguous()
    zeros = torch.zeros_like(hw)
    k5_args = (k4_args[0], hs, cs, gates, hw, cw, *w[:2], dh_in, zeros, zeros)
    k3_val = (seq_full, dry[:, :, :end].contiguous(), h0, c0, *w)
    return k3_args, k4_args, k5_args, k3_val


def val_walk(lk, k3_val) -> dict:
    """K3 over the whole val_step clip: timed at full length, held against
    the plain version on its first 4096 steps (the plain loop is slow), and
    its final state and y against a float64 plain walk of one batch row on
    the CPU, where drift over the long walk would show; `torch.nn.LSTM`
    timed at the same shape where cuDNN takes it."""
    b, _, end = k3_val[0].shape
    hid = k3_val[5].shape[0]
    val_ms = cuda_ms(lambda: lk.lstm_forward(*k3_val), 3)
    n_cmp = 4096
    head = [a[..., :n_cmp].contiguous() for a in k3_val[:2]]
    err = max(max_abs(x, y_) for x, y_ in zip(
        lk.lstm_forward(*head, *k3_val[2:]), lk.lstm_forward_plain(*head, *k3_val[2:])))
    if not err <= KERNEL_TOL:
        fail(f"K3 at H {hid} on the val_step clip's first {n_cmp} steps disagrees with its plain version: {err}")
    drift, drift_y = long_walk_drift(lk, k3_val)
    if not (drift <= KERNEL_TOL and drift_y <= KERNEL_TOL):
        fail(f"K3 at H {hid} after {end} steps is {drift} (state) / {drift_y} (y) from a float64 walk")
    lib = library_lstm(*k3_val[4:7])
    full_tbc = k3_val[0].permute(2, 0, 1).contiguous()

    def lib_fwd():
        with torch.no_grad():
            lib(full_tbc, (k3_val[2][None].contiguous(), k3_val[3][None].contiguous()))

    try:
        lib_fwd()
        lib_val = f"{cuda_ms(lib_fwd, 3):.3f}"
    except RuntimeError as e:  # a yardstick only: report what cuDNN refused
        lib_val = f"refused ({str(e).splitlines()[0][:80]})"
    val_ops, val_bytes = lstm_ops_bytes(b, end, hid, 2, 1)
    bound_ms = max(val_ops / F32_OPS_S, val_bytes / HBM_BYTES_S) * 1e3
    print(f"[lstm_effect_model val_step B={b} T={end} H={hid}] ms={val_ms:.3f} "
          f"err(first {n_cmp} steps)={err:.3e} (hn, cn) after {end} steps vs float64 CPU walk, row 0: "
          f"{drift:.3e}, y over the clip: {drift_y:.3e} bound_ms={bound_ms:.4f} library_ms={lib_val}")
    return dict(ms=val_ms, err_head=err, drift_state=drift, drift_y=drift_y, bound_ms=bound_ms,
                library_ms=lib_val)


def lstm_ops_bytes(b, t, hid, in_dim, out_ch, backward=False, save_states=False):
    """(float32 operations, bytes) one K3/K4/K5 launch needs: each input
    read once, each output written once (K4's saved states and gate
    activations are its outputs and K5's inputs; K5's gate cotangents are
    scratch and not counted); transcendental functions count as one
    operation."""
    g4 = 4 * hid
    w_floats = in_dim * g4 + hid * g4 + g4
    if not backward:
        ops = b * t * (2 * g4 * (hid + in_dim) + g4 + g4 + 5 * hid + 2 * hid * out_ch + 3 * out_ch)
        floats = b * t * (in_dim + 2 * out_ch) + 4 * b * hid + w_floats + hid * out_ch + out_ch
        if save_states:
            floats += 2 * b * t * hid + b * t * g4
        return ops, 4 * floats
    ops = b * t * (
        20 * hid  # cell backward and gate cotangents
        + 2 * g4 * hid  # recurrent cotangent
        + 2 * g4 * (hid + in_dim + 1)  # dW_hh, dW_ih, db
        + 2 * g4 * in_dim  # dseq
    )
    floats = 2 * b * in_dim * t + 3 * b * t * hid + b * t * g4 + 6 * b * hid + 2 * w_floats
    return ops, 4 * floats


def run_stage2(fxk, lk, rng, k1_row: dict, summary: dict) -> list:
    """Stage 2's checks and main path; adds K1 on stage 2's batch (d 485) to
    `k1_row` under "d485", and the step's mean, profiled wall and busy ms to
    `summary`."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops.corners import find_corners, smoothen
    from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    # -- kernels against their plain versions: the register-resident kernels
    #    (H 64, 16), the cluster kernels (H 160)
    #    and the generic ones (H 48) at a T ragged against both chunk sizes
    #    and at a single step, then the main path's shapes with the shipped
    #    weights
    for hid in (64, 160, 16, 48):
        check_lstm_kernels(lk, lstm_inputs(rng, 5, 300, hid), hid, f"LSTM B=5 T=300 H={hid}")
        check_lstm_kernels(lk, lstm_inputs(rng, 1, 1, hid), hid + 1, f"LSTM B=1 T=1 H={hid}")
    kinds = {hid: (lk.forward_kernel(hid, 5)[0], lk.backward_kernel(hid, 5)[0]) for hid in (64, 160, 16, 48)}
    if kinds != {64: ("registers", "registers"), 160: ("cluster", "cluster"),
                 16: ("registers", "registers"), 48: ("generic", "generic")}:
        fail(f"the small-shape checks did not cover every kernel path: {kinds}")
    em_w = load_lstm_effect_model(str(LSTM64), device="cuda")
    a = lstm_inputs(rng, BATCH, TBPTT_CHUNK, 64)
    a.update(w_ih=em_w.w_ih.detach(), w_hh=em_w.w_hh.detach(), b=em_w.b_gates.detach(),
             fc_k=em_w.fc_kernel.detach(), fc_b=em_w.fc_bias.detach())
    check_lstm_kernels(lk, a, 7, f"LSTM B={BATCH} T={TBPTT_CHUNK} H=64 (shipped weights)")

    # -- the main path, counted per step
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2,), max_delay_samples=485)
    extractor = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")

    def make_task(dev, lfo_model):
        return TBPTTEffectModelingTask(
            load_lstm_effect_model(str(LSTM64), device=dev), cfg, lfo_model=lfo_model,
            device=dev, **TBPTT,
        )

    task = make_task("cuda", extractor)
    n_up = task.updates_per_batch
    if n_up != 83:
        fail(f"updates_per_batch is {n_up}, expected 83")
    val_batch = batch_to_torch(make_synthetic_batch(1000, BATCH, N_SAMPLES, SR, "flanger"), "cuda")
    train_batches = [
        batch_to_torch(make_synthetic_batch(s, BATCH, N_SAMPLES, SR, "flanger"), "cuda")
        for s in range(N_TBPTT_STEPS + 1)
    ]
    keys = ("flanger", "phaser", "lstm_forward", "lstm_train_forward", "lstm_backward")

    def counts():
        return {**fxk.LAUNCHES, **lk.LAUNCHES}

    def reset():
        fxk.reset_launch_counts()
        lk.reset_launch_counts()

    def expect(got, want, what):
        if any(got[k] != want[k] for k in keys):
            fail(f"{what}: launches {got}, expected {want}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = dict.fromkeys(keys, 0)
    reset()
    val = {k: v.item() for k, v in task.val_step(val_batch).items()}
    c = counts()
    expect(c, dict(flanger=1, phaser=0, lstm_forward=1, lstm_train_forward=0, lstm_backward=0), "val_step")
    total = {k: total[k] + c[k] for k in keys}
    print(f"[TBPTT val_step r7 bf16 b={BATCH}] " + " ".join(f"{k}={v:.6f}" for k, v in sorted(val.items())))
    per_step = dict(flanger=1, phaser=0, lstm_forward=1, lstm_train_forward=n_up, lstm_backward=n_up)
    step_s = []
    for i, tb in enumerate(train_batches):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = task.train_step(tb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts()
        expect(c, per_step, f"train_step {i}")
        total = {k: total[k] + c[k] for k in keys}
        if i > 0:  # step 0 warms up the allocator and the cuDNN plans
            step_s.append(dt)
        print(f"[TBPTT train_step {i}] " + " ".join(f"{k}={v.item():.6f}" for k, v in sorted(metrics.items()))
              + f" wall={dt * 1e3:.2f} ms launches={c}")
    print(f"[stage 2 main path] launches={total}")
    if not (all(math.isfinite(v) for v in val.values())
            and all(math.isfinite(v.item()) for v in metrics.values())):
        fail(f"non-finite TBPTT metrics: val={val} train={metrics}")
    if not all(torch.isfinite(p).all().item() for p in task.effect_model.parameters()):
        fail("non-finite LSTM parameters after the TBPTT steps")
    step_mean = float(np.mean(step_s))
    audio_s = BATCH * N_SAMPLES / SR
    print(f"[stage 2 train] batch={BATCH} updates_per_step={n_up} steps={len(step_s)} "
          f"mean_step_ms={step_mean * 1e3:.3f} min_step_ms={min(step_s) * 1e3:.3f} "
          f"audio_s_per_s={audio_s / step_mean:.2f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # -- the whole path against the CPU, float32, batch 3, plain kernels there.
    #    Ground-truth conditioning: val and train metrics and the parameters.
    ref_np = make_synthetic_batch(2001, 3, N_SAMPLES, SR, "flanger")  # mixed validity
    out = {}
    for dev in ("cuda", "cpu"):
        t = make_task(dev, None)
        bt = batch_to_torch(ref_np, dev)
        v = {k: x.item() for k, x in t.val_step(bt).items()}
        m = {k: x.item() for k, x in t.train_step(bt).items()}
        out[dev] = (v, m, [p.detach().cpu() for p in t.effect_model.parameters()])
    for what, i in (("val_step", 0), ("train_step", 1)):
        for k in out["cpu"][i]:
            a_, b_ = out["cuda"][i][k], out["cpu"][i][k]
            if not math.isclose(a_, b_, rel_tol=VAL_RTOL, abs_tol=1e-6):
                fail(f"TBPTT {what} {k}: card {a_} vs CPU {b_}")
        print(f"[TBPTT {what} f32 gt-LFO card vs CPU, b=3] " + " ".join(
            f"{k}={out['cuda'][i][k]:.6f}/{out['cpu'][i][k]:.6f}" for k in sorted(out["cpu"][i])))
    p_err = max(max_abs(x, y) for x, y in zip(out["cuda"][2], out["cpu"][2]))

    def control(scale):
        """The card's parameters after the same step with the gate-bias
        gradient scaled, against the CPU's sound ones."""
        t = make_task("cuda", None)
        t.effect_model.b_gates.register_hook(lambda g: g * scale)
        t.train_step(batch_to_torch(ref_np, "cuda"))
        return max(max_abs(x.detach().cpu(), y) for x, y in zip(t.effect_model.parameters(), out["cpu"][2]))

    zeroed, doubled = control(0.0), control(2.0)
    print(f"[TBPTT LSTM parameters after one gt-LFO train step, card vs CPU] "
          f"max_abs={p_err:.3e} (tolerance {PARAM_ATOL}); controls: gate-bias gradient "
          f"zeroed {zeroed:.3e}, doubled {doubled:.3e}")
    if not p_err <= PARAM_ATOL:
        fail(f"LSTM parameters after a train step: card vs CPU max-abs {p_err}")
    if not zeroed > PARAM_ATOL:
        fail(f"the parameter check cannot see a missing gradient: {zeroed}")

    #    Extractor conditioning: the smoothed LFO, its corners, and (when no
    #    corner flips) the val metrics.
    ref_cfg = dict(PAPER, compute_dtype="float32")
    ext = {}
    for dev in ("cuda", "cpu"):
        t = make_task(dev, load_spectral_2dcnn(str(R7), device=dev, **ref_cfg))
        bt = batch_to_torch(ref_np, dev)
        with torch.no_grad():
            dry, wet, mod_frames, _ = render_batch(bt, cfg)
        mod_hat = t._extract_mod_sig(dry, wet, mod_frames)
        sm = smoothen(mod_hat, TBPTT["model_smooth_n_frames"])
        ext[dev] = (sm.cpu(), [x.cpu() for x in find_corners(sm)], t, bt, mod_hat.cpu())
    sm_err = max_abs(ext["cuda"][0], ext["cpu"][0])
    flips = sum(int((x != y).sum()) for x, y in zip(ext["cuda"][1], ext["cpu"][1]))
    # the smoothing itself gives the CPU's bits on the card (additions in a
    # fixed order), so flips can come only from the extractor's output
    sm_exact = torch.equal(ext["cuda"][0], smoothen(ext["cuda"][4], TBPTT["model_smooth_n_frames"]))
    print(f"[TBPTT r7 f32 LFO card vs CPU, b=3] smoothed max_abs={sm_err:.3e} corner_flips={flips} "
          f"smoothing_bit_exact={sm_exact}")
    if not sm_err <= KERNEL_TOL:
        fail(f"extracted LFO: card vs CPU max-abs {sm_err}")
    if not sm_exact:
        fail("smoothing the same LFO gives other bits on the card than on the CPU")
    if flips == 0:
        vals = {dev: {k: x.item() for k, x in ext[dev][2].val_step(ext[dev][3]).items()}
                for dev in ("cuda", "cpu")}
        for k in vals["cpu"]:
            if not math.isclose(vals["cuda"][k], vals["cpu"][k], rel_tol=VAL_RTOL, abs_tol=1e-6):
                fail(f"TBPTT val_step (r7) {k}: card {vals['cuda'][k]} vs CPU {vals['cpu'][k]}")
        print("[TBPTT val_step f32 r7 card vs CPU, b=3] " + " ".join(
            f"{k}={vals['cuda'][k]:.6f}/{vals['cpu'][k]:.6f}" for k in sorted(vals["cpu"])))
    else:
        print("[TBPTT val_step f32 r7 card vs CPU] not compared: the corners differ")

    # -- K1 on the path's last train batch (d 485)
    d = cfg.max_delay_samples
    k1 = check_k1_path(fxk, k1_args(train_batches[-1], d),
                       f"stage 2 batch, flanger seed {N_TBPTT_STEPS}, d {d}")
    k1_row["d485"] = dict(launches=total["flanger"], max_abs_err=k1["err"], ms=k1["ms"],
                          plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
                          **{k: k1[k] for k in K1_EXTRA})

    # -- each kernel at the main path's shapes, on the path's own data
    k3_args, k4_args, k5_args, k3_val = path_lstm_args(lk, task, val_batch)
    rows, times = lstm_path_rows(lk, k3_args, k4_args, k5_args, total)
    # cycles a step of the two walks: kernel time / T x the SM clock under load
    by_kernel = device_ms_per_launch(lambda: lk.lstm_backward(*k5_args), 10)
    walk_ms = sum(v for k_, v in by_kernel.items() if "bwd_walk" in k_)
    mhz = sm_clock_mhz(lambda: lk.lstm_train_forward(*k4_args))
    print("[K5 by kernel, ms a launch (profiler, mean of the launches recorded)] " + "  ".join(
        f"{k_}={v:.4f}" for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"[cycles a step at {mhz:.0f} MHz (nvidia-smi clocks.sm under load)] "
          f"K4 walk {times['lstm_train_forward'][0] / TBPTT_CHUNK * mhz * 1e3:.0f}  "
          f"K5 walk {walk_ms / TBPTT_CHUNK * mhz * 1e3:.0f} (walk kernel {walk_ms:.4f} ms)")
    if not walk_ms > 0:
        fail(f"the profiler saw no K5 walk kernel: {sorted(by_kernel)}")
    val_walk(lk, k3_val)

    # -- where one full-width TBPTT train step spends the card's time
    wall_ms, busy_ms = profile_train_step(task, train_batches[1], "stage 2")
    summary.update(step_ms=step_mean * 1e3, profiled_wall_ms=wall_ms, busy_ms=busy_ms)
    return rows


# ---------------------------------------------------------------------------
# stage 2 at H 160: configs/train_em_sim_chorus_h160.yml's task (K1, and K3,
# K4 and K5's walk on the cluster kernels)
# ---------------------------------------------------------------------------

H160_CONFIG = "configs/train_em_sim_chorus_h160.yml"
LSTM160 = ROOT / "models" / "lstm_160__lfo_2dcnn_r6__sim_chorus.npz"
R6 = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r6.npz"
N_H160_STEPS = 2  # timed, after one warm-up step
# the per-step floor of the cluster kernels (the forward's W_hh^T h, the
# backward's W_hh dgates): 4 H^2 multiply-adds a row, R rows over n CTAs at
# an SM's 128 a cycle
def h160_fma_cycles(n: int, rows: int) -> int:
    return rows * 4 * 160 * 160 // (n * 128)


def run_stage2_h160(fxk, lk, rng, h64: dict) -> tuple:
    """The shipped H 160 chorus model's TBPTT training as its config sets it
    up (batch 32, warm-up and 83 chunks of 1024, the config's AdamW, the
    frozen r6 extractor in bf16) on synthetic chorus batches (delay line
    1764): the kernels at the path's shapes with the shipped weights, a
    `val_step` and a few `train_step`s counted per step and timed beside
    the H 64 step (`h64`), one step on the card against the CPU, K3 over the
    val_step clip against a float64 walk, the kernels' rows and a profile.
    Returns (rows, K1's launches)."""
    from mod_extraction_tpu_torch.cli import build_optimizer, load_yaml_with_includes
    from mod_extraction_tpu_torch.data.synthetic import (
        CHORUS_DELAYS_MS,
        batch_to_torch,
        flanger_max_delay_samples,
        make_synthetic_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    hid = 160
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {shape: lk.cluster_occupancy(*shape, save=True) for shape in lk.CLUSTER_SHAPES}
    kern, n, n_rows = lk.forward_kernel(hid, BATCH)
    waves = math.ceil(math.ceil(BATCH / n_rows) / occ[(n, n_rows)])
    print(f"[stage 2 H 160] forward kernel at B {BATCH}: {kern} of {n} CTAs for {n_rows} row(s); the card "
          f"holds at most {', '.join(f'{v} clusters of {k[0]} CTAs x {k[1]} rows' for k, v in occ.items())} at "
          f"once ({n_sms} SMs), so B {BATCH} takes {waves} wave(s); at B 2 (serving) {lk.forward_kernel(hid, 2)}")
    if kern != "cluster" or min(occ.values()) < 1:
        fail(f"H 160 at B {BATCH} takes {kern}, occupancy {occ}")
    occ5 = {shape: lk.backward_cluster_occupancy(*shape) for shape in lk.CLUSTER_SHAPES}
    kern5, n5, rows5 = lk.backward_kernel(hid, BATCH)
    waves5 = math.ceil(math.ceil(BATCH / rows5) / occ5[(n5, rows5)])
    print(f"[stage 2 H 160] backward walk at B {BATCH}: {kern5} of {n5} CTAs for {rows5} row(s); the card holds "
          f"at most {', '.join(f'{v} clusters of {k[0]} CTAs x {k[1]} rows' for k, v in occ5.items())} of its "
          f"kernels at once, so B {BATCH} takes {waves5} wave(s); at B 3 {lk.backward_kernel(hid, 3)}")
    if kern5 != "cluster" or min(occ5.values()) < 1:
        fail(f"K5 at H 160, B {BATCH} takes {kern5}, occupancy {occ5}")
    config = load_yaml_with_includes(H160_CONFIG)
    margs = config["model"]["init_args"]
    kw = {k: margs[k] for k in ("warmup_n_samples", "step_n_samples", "use_dry", "model_smooth_n_frames",
                                "should_stretch", "max_n_corners", "discard_invalid_lfos", "loss_dict")}
    if not (margs["effect_model"]["init_args"]["n_hidden"] == hid
            and Path(margs["lfo_model_weights_path"]).name == R6.name
            and config["data"]["init_args"]["batch_size"] == BATCH):
        fail(f"{H160_CONFIG} no longer names H {hid}, the r6 extractor and batch {BATCH}")
    optimizer = build_optimizer(config["optimizer"])
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2,),
                       max_delay_samples=flanger_max_delay_samples(*CHORUS_DELAYS_MS, SR))

    def make_task(dev, lfo_model):
        return TBPTTEffectModelingTask(load_lstm_effect_model(str(LSTM160), device=dev), cfg,
                                       lfo_model=lfo_model, optimizer=optimizer, device=dev, **kw)

    # -- the kernels at the path's shapes with the shipped weights
    em_w = load_lstm_effect_model(str(LSTM160), device="cuda")
    a = lstm_inputs(rng, BATCH, TBPTT_CHUNK, hid)
    a.update(w_ih=em_w.w_ih.detach(), w_hh=em_w.w_hh.detach(), b=em_w.b_gates.detach(),
             fc_k=em_w.fc_kernel.detach(), fc_b=em_w.fc_bias.detach())
    check_lstm_kernels(lk, a, 9, f"LSTM B={BATCH} T={TBPTT_CHUNK} H=160 (shipped weights)")

    # -- the main path, counted per step
    extractor = load_spectral_2dcnn(str(R6), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = make_task("cuda", extractor)
    n_up = task.updates_per_batch
    if n_up != 83:
        fail(f"updates_per_batch is {n_up}, expected 83")
    val_batch = batch_to_torch(make_synthetic_batch(1100, BATCH, N_SAMPLES, SR, "chorus"), "cuda")
    train_batches = [batch_to_torch(make_synthetic_batch(100 + s, BATCH, N_SAMPLES, SR, "chorus"), "cuda")
                     for s in range(N_H160_STEPS + 1)]
    keys = ("flanger", "phaser", "lstm_forward", "lstm_train_forward", "lstm_backward")

    def reset():
        fxk.reset_launch_counts()
        lk.reset_launch_counts()

    def counts():
        c = {**fxk.LAUNCHES, **lk.LAUNCHES}
        return {k: c[k] for k in keys}

    torch.cuda.synchronize()
    reset()
    val = {k: v.item() for k, v in task.val_step(val_batch).items()}
    total = counts()
    if total != dict(flanger=1, phaser=0, lstm_forward=1, lstm_train_forward=0, lstm_backward=0):
        fail(f"H 160 val_step: launches {total}")
    print(f"[TBPTT H 160 val_step r6 bf16 b={BATCH}] " + " ".join(f"{k}={v:.6f}" for k, v in sorted(val.items())))
    per_step = dict(flanger=1, phaser=0, lstm_forward=1, lstm_train_forward=n_up, lstm_backward=n_up)
    step_s = []
    for i, tb in enumerate(train_batches):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = task.train_step(tb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts()
        if c != per_step:
            fail(f"H 160 train_step {i}: launches {c}, expected {per_step}")
        total = {k: total[k] + c[k] for k in keys}
        if i > 0:
            step_s.append(dt)
        print(f"[TBPTT H 160 train_step {i}] " + " ".join(f"{k}={v.item():.6f}" for k, v in sorted(metrics.items()))
              + f" wall={dt * 1e3:.2f} ms launches={c}")
    print(f"[stage 2 H 160 main path] launches={total}")
    if not (all(math.isfinite(v) for v in val.values())
            and all(math.isfinite(v.item()) for v in metrics.values())
            and all(torch.isfinite(p).all().item() for p in task.effect_model.parameters())):
        fail(f"non-finite H 160 TBPTT metrics or parameters: val={val} train={metrics}")
    step_ms = float(np.mean(step_s)) * 1e3
    wall_ms, busy_ms = profile_train_step(task, train_batches[1], "stage 2 H 160")
    print(f"[stage 2 H 160 train] batch={BATCH} updates_per_step={n_up} steps={len(step_s)} "
          f"mean_step_ms={step_ms:.3f} audio_s_per_s={BATCH * N_SAMPLES / SR / step_ms * 1e3:.2f}; profiled "
          f"wall {wall_ms:.2f} ms, busy {busy_ms:.2f} ms; the H 64 step (stage 2 above): mean_step_ms="
          f"{h64['step_ms']:.3f}, profiled wall {h64['profiled_wall_ms']:.2f} ms, busy {h64['busy_ms']:.2f} ms")

    # -- one step on the card against the CPU, float32, batch 3, ground-truth
    #    conditioning, plain kernels there: the val and train metrics and the
    #    parameters after the step's 84 AdamW updates
    ref_np = make_synthetic_batch(2101, 3, N_SAMPLES, SR, "chorus")
    out = {}
    for dev in ("cuda", "cpu"):
        t = make_task(dev, None)
        bt = batch_to_torch(ref_np, dev)
        v = {k: x.item() for k, x in t.val_step(bt).items()}
        m = {k: x.item() for k, x in t.train_step(bt).items()}
        out[dev] = (v, m, [p.detach().cpu() for p in t.effect_model.parameters()])
    for what, i in (("val_step", 0), ("train_step", 1)):
        for k in out["cpu"][i]:
            a_, b_ = out["cuda"][i][k], out["cpu"][i][k]
            if not math.isclose(a_, b_, rel_tol=VAL_RTOL, abs_tol=1e-6):
                fail(f"TBPTT H 160 {what} {k}: card {a_} vs CPU {b_}")
        print(f"[TBPTT H 160 {what} f32 gt-LFO card vs CPU, b=3] " + " ".join(
            f"{k}={out['cuda'][i][k]:.6f}/{out['cpu'][i][k]:.6f}" for k in sorted(out["cpu"][i])))
    p_err = max(max_abs(x, y) for x, y in zip(out["cuda"][2], out["cpu"][2]))
    print(f"[TBPTT H 160 LSTM parameters after one gt-LFO train step, card vs CPU] max_abs={p_err:.3e} "
          f"(tolerance {PARAM_ATOL})")
    if not p_err <= PARAM_ATOL:
        fail(f"H 160 LSTM parameters after a train step: card vs CPU max-abs {p_err}")

    # -- each kernel at the path's shapes, on the path's own data; K3 over
    #    the val clip; the cluster kernels' cycles a step beside their floor
    k3_args, k4_args, k5_args, k3_val = path_lstm_args(lk, task, val_batch)
    rows, times = lstm_path_rows(lk, k3_args, k4_args, k5_args, total, suffix="_h160")
    val = val_walk(lk, k3_val)
    rows[0]["val_step"] = val
    by_kernel = device_ms_per_launch(lambda: lk.lstm_backward(*k5_args), 10)
    walk_ms = sum(v for k_, v in by_kernel.items() if "bwd_cluster" in k_)
    if not walk_ms > 0:
        fail(f"the profiler saw no cluster walk in K5 at H 160: {sorted(by_kernel)}")
    mhz = sm_clock_mhz(lambda: lk.lstm_train_forward(*k4_args))
    cyc = {k: times[k][0] / TBPTT_CHUNK * mhz * 1e3 for k in ("lstm_forward", "lstm_train_forward")}
    cyc["lstm_backward"] = walk_ms / TBPTT_CHUNK * mhz * 1e3
    print("[K5 H 160 by kernel, ms a launch (profiler, mean of the launches recorded)] " + "  ".join(
        f"{k_}={v:.4f}" for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"[cycles a step at {mhz:.0f} MHz, H 160 B {BATCH}] forward: clusters of {n} CTAs x {n_rows} rows in "
          f"{waves} wave(s), K3 {cyc['lstm_forward']:.0f} K4 {cyc['lstm_train_forward']:.0f}, the multiply-adds' "
          f"floor {h160_fma_cycles(n, n_rows)} a step; K5's walk: clusters of {n5} CTAs x {rows5} rows in {waves5} "
          f"wave(s), {cyc['lstm_backward']:.0f} (walk kernel {walk_ms:.4f} ms), floor {h160_fma_cycles(n5, rows5)}")
    shapes = ((n, n_rows, waves, occ), (n, n_rows, waves, occ), (n5, rows5, waves5, occ5))
    for row, key, (cn, cr, cw, co) in zip(rows, ("lstm_forward", "lstm_train_forward", "lstm_backward"), shapes):
        row.update(cycles_per_step=cyc[key], fma_floor_cycles=h160_fma_cycles(cn, cr), cluster_ctas=cn,
                   cluster_rows=cr, waves=cw, occupancy={f"{k[0]}x{k[1]}": v for k, v in co.items()})
    rows[2]["walk_ms"] = walk_ms
    return rows, total["flanger"]


# ---------------------------------------------------------------------------
# serving: the streaming processor and its torch.export artifact (K3)
# ---------------------------------------------------------------------------


def serve_buffers(rng, total: int) -> list:
    """Buffer lengths covering `total` samples: a single sample first, then
    uniform in [1, SERVE_MAX_BUFFER]."""
    sizes = [1]
    while sum(sizes) < total:
        sizes.append(min(int(rng.integers(1, SERVE_MAX_BUFFER + 1)), total - sum(sizes)))
    return sizes


def drive(proc, x, sizes, knobs):
    """Buffer by buffer, numpy in and out: (y, final state)."""
    state, outs, i = proc.init_state(), [], 0
    for n in sizes:
        y, state = proc.process_np(state, x[:, i : i + n], **knobs)
        outs.append(y)
        i += n
    return np.concatenate(outs, axis=-1), state


def load_script(name: str):
    """`scripts/<name>.py` as a module, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def c_errors(c, c_ref) -> tuple:
    """(the largest |dc| of a carried cell state, |dc| / |c_ref| at that
    element, the largest share of the limit STREAM_ATOL + STREAM_C_RTOL
    |c_ref| that any element uses: at most 1 where the state holds)."""
    d, mag = (c - c_ref).abs().flatten(), c_ref.abs().flatten()
    i = int(d.argmax())
    share = (d / (STREAM_ATOL + STREAM_C_RTOL * mag)).max().item()
    return d[i].item(), d[i].item() / max(mag[i].item(), 1e-30), share


def run_serving(lk, rng) -> dict:
    """K3 at the serving shapes against its plain version; the streaming
    processor driven over random buffers on the card (counted), against one
    full call, against the CPU, and through its reloaded `.pt2` artifact;
    K3's times per buffer and the three real-time factors.  Returns what K3's
    row of the kernels line adds."""
    import tempfile

    bts = load_script("bench_torch_streaming")
    from mod_extraction_tpu_torch.export.streaming import (
        StreamingEffectModel,
        export_streaming_model,
        load_compiled_processor,
    )

    # -- K3 at the processor's shapes: batch = channels, T = the buffer
    worst = 0.0
    for hid in (64, 160):
        for b in (1, 2):
            for t in (1, 128, SERVE_MAX_BUFFER):
                a = lstm_inputs(rng, b, t, hid)
                err = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(**a), lk.lstm_forward_plain(**a)))
                if not err <= KERNEL_TOL:
                    fail(f"K3 at B {b} T {t} H {hid} disagrees with its plain version: {err}")
                worst = max(worst, err)
    print(f"[K3 serving shapes: H 64/160 x B 1/2 x T 1/128/{SERVE_MAX_BUFFER}] worst max_abs_err={worst:.3e}")

    # -- the main path: the processor driven buffer by buffer, counted (by
    #    the model's width: H 64 takes the register-resident forward, H 160
    #    the cluster forward)
    launches, worst_c = {64: 0, 160: 0}, (0.0, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for label, weights in SERVE_WEIGHTS:
            for n_ch, offset in ((1, 0.0), (2, math.pi / 2)):
                knobs = dict(SERVE_KNOBS, stereo_offset=offset)
                what = f"{label}, {'mono' if n_ch == 1 else 'stereo, offset pi/2'}"
                sm = StreamingEffectModel(str(weights), n_channels=n_ch, device="cuda")
                x = rng.uniform(-0.5, 0.5, (n_ch, SERVE_SAMPLES)).astype(np.float32)
                y_full, s_full = sm.process_np(sm.init_state(), x, **knobs)
                sizes = serve_buffers(rng, SERVE_SAMPLES)
                lk.reset_launch_counts()
                y_chunk, s_chunk = drive(sm, x, sizes, knobs)
                counted = dict(lk.LAUNCHES)
                target = export_streaming_model(
                    str(weights), tmp, f"m{n_ch}_{sm.n_hidden}",
                    metadata_overrides={"is_input_mono": n_ch == 1},
                )
                art = load_compiled_processor(target, device="cuda")
                art_sizes = serve_buffers(rng, SERVE_SAMPLES)
                lk.reset_launch_counts()
                y_art, s_art = drive(art, x, art_sizes, knobs)
                art_counted = dict(lk.LAUNCHES)
                cpu = StreamingEffectModel(str(weights), n_channels=n_ch, device="cpu")
                y_cpu, _ = cpu.process_np(cpu.init_state(), x, **knobs)
                chunk_err = max(float(np.abs(y_chunk - y_full).max()),
                                max_abs(s_chunk["h"], s_full["h"]))
                art_err = float(np.abs(y_art - y_full).max())
                c_chunk, c_art = c_errors(s_chunk["c"], s_full["c"]), c_errors(s_art["c"], s_full["c"])
                worst_c = max(worst_c, c_chunk[:2], c_art[:2])
                cpu_err = float(np.abs(y_full - y_cpu).max())
                print(f"[serving {what}] {len(sizes)} buffers of 1-{SERVE_MAX_BUFFER} over {SERVE_SAMPLES} "
                      f"samples: chunked vs full {chunk_err:.3e} (limit {STREAM_ATOL}); card vs CPU "
                      f"{cpu_err:.3e} (limit {KERNEL_TOL}); reloaded .pt2 on the card ({len(art_sizes)} "
                      f"buffers) vs live {art_err:.3e} (limit {STREAM_ATOL}); K3 launches {counted['lstm_forward']}"
                      f" / artifact {art_counted['lstm_forward']}; phase {s_chunk['phase'].item():.6f}")
                print(f"  cell state, chunked / artifact vs full: max |dc| {c_chunk[0]:.3e} / {c_art[0]:.3e}, "
                      f"|dc|/|c| there {c_chunk[1]:.3e} / {c_art[1]:.3e}, share of the limit {STREAM_ATOL} + "
                      f"{STREAM_C_RTOL} |c| used {c_chunk[2]:.3f} / {c_art[2]:.3f}; max |c| "
                      f"{s_full['c'].abs().max().item():.3f}")
                for c, n in ((counted, len(sizes)), (art_counted, len(art_sizes))):
                    if c != dict(lstm_forward=n, lstm_train_forward=0, lstm_backward=0):
                        fail(f"serving {what}: launches {c}, expected K3 once for each of {n} buffers")
                if not np.isfinite(y_chunk).all() or y_chunk.shape != x.shape:
                    fail(f"serving {what}: output of shape {y_chunk.shape}, finite {np.isfinite(y_chunk).all()}")
                if not chunk_err <= STREAM_ATOL:
                    fail(f"serving {what}: chunked differs from one full call by {chunk_err}")
                if not cpu_err <= KERNEL_TOL:
                    fail(f"serving {what}: the card differs from the CPU by {cpu_err}")
                if not art_err <= STREAM_ATOL:
                    fail(f"serving {what}: the reloaded artifact differs from the live path by {art_err}")
                if not (c_chunk[2] <= 1.0 and c_art[2] <= 1.0):
                    fail(f"serving {what}: carried cell state, chunked {c_chunk}, artifact {c_art}")
                if not abs(s_chunk["phase"].item() - s_full["phase"].item()) <= 1e-5:
                    fail(f"serving {what}: carried phase {s_chunk['phase'].item()} vs {s_full['phase'].item()}")
                launches[sm.n_hidden] += counted["lstm_forward"] + art_counted["lstm_forward"]

        # -- times: stereo, H 64 (the egfx model), per buffer size
        sm = StreamingEffectModel(str(SERVE_WEIGHTS[0][1]), n_channels=2, device="cuda")
        art = load_compiled_processor(export_streaming_model(sm.model, tmp, "timed"), device="cuda")
        rows = bts.measure(sm, art, SERVE_BUFFERS, 2.0, rng)
    # K3's cycles a step at B 32, T 1024, and the latency floor it sets on a
    # buffer of T dependent steps
    a32 = lstm_inputs(rng, BATCH, TBPTT_CHUNK, 64)
    ms32 = cuda_ms_median(lambda: lk.lstm_forward(**a32))
    mhz = sm_clock_mhz(lambda: lk.lstm_forward(**a32))
    cycles = ms32 * 1e3 * mhz / TBPTT_CHUNK
    lib = torch.nn.LSTM(2, 64).to("cuda")
    shapes = []
    for row in rows:
        t = row["buffer_size"]
        a = bts.k3_args(sm, (0.1 * rng.standard_normal((2, t))).astype(np.float32), rng)
        ref = []
        plain_ms = cuda_ms(lambda: ref.append(lk.lstm_forward_plain(*a)), 1)
        err = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(*a), ref[0]))
        seq_tbc = a[0].permute(2, 0, 1).contiguous()

        def lib_fwd():
            with torch.no_grad():
                lib(seq_tbc)

        # the library's time a call issued back to back, and the card's time a
        # call with the calls queued ahead (no profiler: inside this run it
        # has recorded fewer launches than were made)
        library_call_ms = cuda_ms_median(lib_fwd)
        library_ms = cuda_ms_queued(lib_fwd, 50, spin_ms=2 * 50 * library_call_ms)
        n_ops, n_bytes = lstm_ops_bytes(2, t, 64, 2, 1)
        t_ops, t_bytes = n_ops / F32_OPS_S * 1e3, n_bytes / HBM_BYTES_S * 1e3
        shape = dict(b=2, t=t, hid=64, ms=row["k3_ms"], profiled_launches=row["k3_profiled_launches"],
                     fenced_ms=row["k3_fenced_ms"], queued_ms=row["k3_queued_ms"], call_ms=row["k3_call_ms"],
                     dispatch_ms=row["k3_dispatch_ms"], plain_ms=plain_ms, max_abs_err=err,
                     bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                     latency_floor_ms=t * cycles / mhz / 1e3, library_ms=library_ms,
                     library_call_ms=library_call_ms)
        shapes.append(shape)
        print(f"[serving, stereo H 64, buffer {t}] per-call RTF {row['rtf_per_call']:.2f}  sustained RTF "
              f"{row['rtf_sustained']:.2f} (Python loop of device calls, one sync)  artifact per-call RTF "
              f"{row['rtf_artifact_per_call']:.2f}  K3 device ms={row['k3_ms']:.4f} ({row['k3_profiled_launches']} "
              f"launches profiled; fenced {row['k3_fenced_ms']:.4f}, queued {row['k3_queued_ms']:.4f}, "
              f"issued back to back {row['k3_call_ms']:.4f}, host dispatch {row['k3_dispatch_ms']:.4f}) "
              f"bound_ms={shape['bound_ms']:.5f} ({shape['bound_by']}) latency floor "
              f"{shape['latency_floor_ms']:.4f} ms ({cycles:.0f} cycles a step at B {BATCH}, {mhz:.0f} MHz) "
              f"plain_ms={plain_ms:.1f} library ms queued={library_ms:.4f} (issued back to back "
              f"{library_call_ms:.4f}) err={err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"K3 at the serving shape (2, {t}) disagrees with its plain version: {err}")
        if not all(math.isfinite(row[k]) and row[k] > 0 for k in ("rtf_per_call", "rtf_sustained",
                                                                  "rtf_artifact_per_call")):
            fail(f"serving RTFs not finite and positive: {row}")
    print(f"[serving main path] K3 launches by width {launches}; largest |dc| carried {worst_c[0]:.3e} "
          f"({worst_c[1]:.3e} of |c| there)")
    h160 = time_k3_h160(lk, rng)
    return dict(launches=launches, cycles_per_step_b32=cycles, shapes=shapes, rtf=rows,
                max_c_err=worst_c[0], c_rel_err_there=worst_c[1], h160=h160)


def time_k3_h160(lk, rng) -> list:
    """K3 at H 160 (the shipped sim_chorus model's width, the cluster
    forward) in stereo at the three serving buffers, beside
    `torch.nn.LSTM(2, 160)` at the same shapes: each timed queued (calls
    issued behind a spin, so the events time the card) and issued back to
    back.  (K4 and K5 at H 160 are timed beside the library in the H 160
    stage-2 phase, `lstm_path_rows`.)"""
    lib = torch.nn.LSTM(2, 160).to("cuda")
    out = []
    for t in SERVE_BUFFERS:
        a = lstm_inputs(rng, 2, t, 160)
        seq_tbc = a["seq"].permute(2, 0, 1).contiguous()

        def k3():
            lk.lstm_forward(**a)

        def lib_fwd():
            with torch.no_grad():
                lib(seq_tbc)

        row = dict(b=2, t=t, hid=160, cluster=lk.forward_kernel(160, 2)[1:])
        for name, fn in (("k3", k3), ("library", lib_fwd)):
            call_ms = cuda_ms_median(fn, reps=5, batches=3)
            reps = max(5, min(50, int(200 / max(call_ms, 1e-3))))
            row[f"{name}_ms"] = cuda_ms_queued(fn, reps, spin_ms=2 * reps * call_ms)
            row[f"{name}_call_ms"] = call_ms
        ref = []
        row["plain_ms"] = cuda_ms(lambda: ref.append(lk.lstm_forward_plain(**a)), 1)
        row["max_abs_err"] = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(**a), ref[0]))
        if not row["max_abs_err"] <= KERNEL_TOL:
            fail(f"K3 at the serving shape (2, {t}) H 160 disagrees with its plain version: {row['max_abs_err']}")
        n_ops, n_bytes = lstm_ops_bytes(2, t, 160, 2, 1)
        row["bound_ms"] = max(n_ops / F32_OPS_S, n_bytes / HBM_BYTES_S) * 1e3
        out.append(row)
        print(f"[K3 H 160, stereo, buffer {t}] queued ms={row['k3_ms']:.4f} (back to back "
              f"{row['k3_call_ms']:.4f}); torch.nn.LSTM(2, 160) queued ms={row['library_ms']:.4f} (back to "
              f"back {row['library_call_ms']:.4f}); kernel / library {row['k3_ms'] / row['library_ms']:.3f}; "
              f"clusters (CTAs, rows) {row['cluster']}; plain_ms={row['plain_ms']:.1f} err={row['max_abs_err']:.3e} "
              f"bound_ms={row['bound_ms']:.5f}")
    return out


FIT_LFO_BATCH = 99  # configs/train_lfo_interwoven_all_live_r7.yml


def run_bench() -> list:
    """`bench_torch.py`'s two measurements at the batches of the configs the
    fit phases train (stage 1 at 99, TBPTT at 32), two timed steps; each
    line's numbers checked."""
    lines = [bench_torch.bench_lfo(batch_size=FIT_LFO_BATCH, n_steps=2),
             bench_torch.bench_tbptt(batch_size=BATCH, n_steps=2)]
    for line in lines:
        print(json.dumps(line))
        for k in ("value", "step_ms", "busy_ms"):
            if not (isinstance(line[k], float) and math.isfinite(line[k]) and line[k] > 0):
                fail(f"bench_torch {line['metric']}: {k} = {line[k]}")
        if not 0.0 <= line["idle_share"] < 1.0:
            fail(f"bench_torch {line['metric']}: idle_share = {line['idle_share']}")
        if "mfu" in line and not 0.0 < line["mfu"] <= 1.0:
            fail(f"bench_torch {line['metric']}: mfu = {line['mfu']}")
    return lines


# ---------------------------------------------------------------------------
# the training entry point: `cli.fit` on shipped configs over a corpus on disk
# ---------------------------------------------------------------------------

FIT_TRAIN_BATCHES, FIT_VAL_BATCHES = 3, 1
FIT_LFO_CONFIG = "configs/train_lfo_interwoven_all_live_r7.yml"
FIT_TBPTT_CONFIG = "configs/train_em_sim_flanger_r7.yml"
# the fixed flanger that makes stage 2's wet corpus: 1 ms + 10 ms lines
WET_FLANGER = dict(rate_hz=0.8, min_delay_width=0.5, width=1.0, feedback=0.5, depth=0.7, mix=1.0)


def fit_records(out_dir: str) -> list:
    (path,) = Path(out_dir).glob("*_metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def write_wet_corpus(fxk, dry_root: Path, wet_root: Path) -> int:
    """Each dry file through K1 on the card at fixed parameters (a 0.8 Hz
    triangle LFO over the 1 ms + 10 ms flanger), written as PCM16 under the
    same name; returns the K1 launches made."""
    from mod_extraction_tpu_torch.data.mods import np_make_mod_signal
    from mod_extraction_tpu_torch.data.synthetic import flanger_max_delay_samples
    from mod_extraction_tpu_torch.data.wav import wav_read, wav_write

    d = flanger_max_delay_samples(1.0, 10.0, SR)
    mmd, mld = round(1.0 / 1000 * SR), round(10.0 / 1000 * SR)
    launches = 0
    for split_dir in sorted(p for p in dry_root.iterdir() if p.is_dir()):
        paths = sorted(split_dir.glob("*.wav"))
        dry = np.stack([wav_read(str(p))[0] for p in paths])  # (n, 1, T)
        t = dry.shape[-1]
        mod = np_make_mod_signal(t, SR, WET_FLANGER["rate_hz"], 0.0, "tri")
        delay = mld * WET_FLANGER["width"] * mod + WET_FLANGER["min_delay_width"] * mmd
        x = torch.from_numpy(dry).cuda()
        n = x.shape[0]
        par = {k: torch.full((n, 1, 1), WET_FLANGER[k], device="cuda") for k in ("feedback", "depth", "mix")}
        wet = fxk.flanger(x, torch.from_numpy(np.broadcast_to(delay, (n, 1, t)).astype(np.float32)).cuda(),
                          par["feedback"], par["depth"], par["mix"], d)
        launches += 1
        wet = wet.cpu().numpy()
        out = wet_root / split_dir.name
        out.mkdir(parents=True, exist_ok=True)
        for p, w in zip(paths, wet):
            wav_write(str(out / p.name), w, int(SR))
    return launches


def fit_config(path: str, corpus: Path, wet: Path | None) -> dict:
    """The shipped config with its data directories on the corpus here,
    three train batches and one val batch an epoch, a log line a step;
    batch size, widths, optimizer, schedule and weights as shipped."""
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    cfg = load_yaml_with_includes(path)
    args = cfg["data"]["init_args"]
    bs = args["batch_size"]
    if "shared_train_args" in args:  # interwoven
        for split, n in (("train", FIT_TRAIN_BATCHES), ("val", FIT_VAL_BATCHES)):
            args[f"shared_{split}_args"].update(input_dir=str(corpus / split), num_examples_per_epoch=n * bs)
    else:  # dry/wet pairs
        for split in ("train", "val"):
            args[f"dry_{split}_dir"] = str(corpus / split)
            args[f"wet_{split}_dir"] = str(wet / split)
        args["train_num_examples_per_epoch"] = FIT_TRAIN_BATCHES * bs
        args["val_num_examples_per_epoch"] = FIT_VAL_BATCHES * bs
    cfg["custom"]["log_every_n_steps"] = 1
    return cfg


def run_fit(label: str, config: str, counters, expected, bench_line: dict, rows: list) -> dict:
    """`cli.fit` for one epoch, counted and timed, then resumed for a
    second; the same epoch again with copies made on the compute stream must
    give the same losses bit for bit (cuDNN held to deterministic algorithms
    for that pair).  `counters` are the launch-count modules of the path's
    kernels; `expected(task)` the launches an epoch ({counter: n})."""
    import copy
    import tempfile

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus
    from mod_extraction_tpu_torch.ops import fx_kernels as fxk
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_corpus(str(tmp / "corpus"))  # 32 + 8 riffs of 12 s
        wet = None
        if "em_sim" in config:
            wet = tmp / "wet"
            n = write_wet_corpus(fxk, tmp / "corpus", wet)
            print(f"[{label}] wet corpus: the dry riffs through K1 on the card ({n} launches, not counted "
                  f"on the path), {WET_FLANGER}")
        print(f"[{label}] corpus written in {time.perf_counter() - t0:.1f} s")
        cfg = fit_config(config, tmp / "corpus", wet)
        out = tmp / "out"

        def counted(run):
            for c in counters:
                c.reset_launch_counts()
            result = run()
            torch.cuda.synchronize()
            return result, {k: v for c in counters for k, v in c.LAUNCHES.items()}

        t0 = time.perf_counter()
        task, launches = counted(lambda: cli.fit(copy.deepcopy(cfg), out_dir=str(out), device="cuda",
                                                 max_epochs=1))
        fit_s = time.perf_counter() - t0
        first = fit_records(str(out))
        # the resumed run profiles its first loop iteration (step 4): the
        # step, its log line's read of the metrics, the wait for the next
        # batch and the copy of the one after it (the last iteration of an
        # epoch this short waits for no batch and issues no copy)
        resumed_cfg = copy.deepcopy(cfg)
        resumed_cfg["custom"]["profile_dir"] = str(tmp / "profile")
        window = (FIT_TRAIN_BATCHES, FIT_TRAIN_BATCHES + 1)
        task2, launches2 = counted(lambda: cli.fit(resumed_cfg, out_dir=str(out), device="cuda",
                                                   resume=True, max_epochs=2, profile_steps=window))
        records = fit_records(str(out))
        resumed = records[len(first):]

        # -- the checks
        want = expected(task)
        for name, recs, got in (("fit", first, launches), ("resumed fit", resumed, launches2)):
            steps = [r for r in recs if r["phase"] == "train_step"]
            epochs = [r for r in recs if r["phase"] == "epoch"]
            if len(steps) != FIT_TRAIN_BATCHES or len(epochs) != 1:
                fail(f"{label} {name}: {len(steps)} train_step and {len(epochs)} epoch records")
            losses = [r["loss"] for r in steps] + [epochs[0]["val/loss"], epochs[0]["train/loss"]]
            if not all(math.isfinite(v) for v in losses):
                fail(f"{label} {name}: non-finite losses {losses}")
            if got != want:
                fail(f"{label} {name}: launches {got}, expected {want} an epoch of "
                     f"{FIT_TRAIN_BATCHES} train and {FIT_VAL_BATCHES} val batches")
        steps2 = [r["step"] for r in resumed if r["phase"] == "train_step"]
        if steps2 != [FIT_TRAIN_BATCHES + i + 1 for i in range(FIT_TRAIN_BATCHES)]:
            fail(f"{label}: the resumed run's steps are {steps2}, not continuing at step {FIT_TRAIN_BATCHES}")
        ckpts = sorted(p.name for p in out.glob("*_ckpts/*"))
        if "last.pt" not in ckpts or "last.json" not in ckpts:
            fail(f"{label}: no last checkpoint: {ckpts}")
        upb = task2.updates_per_batch if isinstance(task2, TBPTTEffectModelingTask) else 1
        updates = 2 * FIT_TRAIN_BATCHES * upb
        group = task2.optimizer.param_groups[0]
        opt_cfg = cfg["optimizer"]
        lr = cli.build_lr(opt_cfg)
        want_lr = lr(updates) if callable(lr) else lr
        want_wd = float(opt_cfg["init_args"].get("weight_decay", 0.01))
        sched_ok = task2.scheduler is None if not callable(lr) else task2.scheduler.last_epoch == updates
        if not (math.isclose(group["lr"], want_lr, rel_tol=1e-6) and group["weight_decay"] == want_wd
                and sched_ok and type(task2.optimizer).__name__ == "AdamW"):
            fail(f"{label}: optimizer lr {group['lr']} wd {group['weight_decay']} after {updates} updates; "
                 f"the config gives {want_lr} / {want_wd}")

        # -- asynchronous copies against synchronous ones, bit for bit
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            pair = {}
            for mode in ("async", "sync"):
                d = tmp / f"det_{mode}"
                cli.fit(copy.deepcopy(cfg), out_dir=str(d), device="cuda", max_epochs=1,
                        sync_copies=mode == "sync")
                recs = fit_records(str(d))
                pair[mode] = [r["loss"] for r in recs if r["phase"] == "train_step"] + \
                    [r["val/loss"] for r in recs if r["phase"] == "epoch"]
        finally:
            torch.backends.cudnn.deterministic = det
        if pair["async"] != pair["sync"]:
            fail(f"{label}: losses with copies on the side stream {pair['async']} differ from those with "
                 f"copies on the compute stream {pair['sync']}")
        print(f"[{label}] losses, side-stream copies == compute-stream copies bit for bit: {pair['async']}")

        # -- times: each run's steps after its first (which builds cuDNN
        # plans or starts the loader) and not profiled: steps 2-3 of the
        # first run and 5-6 of the resumed one
        audio_per_batch = cfg["data"]["init_args"]["batch_size"] * N_SAMPLES / SR
        timed = [r for r in first if r["phase"] == "train_step"][1:] + \
            [r for r in resumed if r["phase"] == "train_step" and r["step"] > window[1]]
        readings = [audio_per_batch / r["audio_sec_per_sec"] * 1e3 for r in timed]
        step_ms = float(np.median(readings))
        summaries = list((tmp / "profile").glob("*_profile.json"))
        if len(summaries) != 1:
            fail(f"{label}: the loop iteration was not profiled")
        prof = json.loads(summaries[0].read_text())
        print(f"[{label}] {config} through cli.fit: batch {cfg['data']['init_args']['batch_size']}, epoch of "
              f"{FIT_TRAIN_BATCHES} + {FIT_VAL_BATCHES} batches in {fit_s:.1f} s (setup included); "
              f"step ms (median of steps {[r['step'] for r in timed]}) {step_ms:.3f}, readings "
              f"{[round(x, 3) for x in readings]}, audio_sec_per_sec "
              f"{audio_per_batch / step_ms * 1e3:.2f}; launches an epoch {launches}; final lr {group['lr']:.6e}")
        print(f"[{label} profile of one loop iteration] wall_ms={prof['wall_ms']:.3f} "
              f"device_busy_ms={prof['device_busy_ms']:.3f} idle_share={prof['idle_share']:.3f} host: "
              f"loader wait {prof['loader_wait_ms']:.3f} ms, batch copies issued {prof['batch_copy_ms']:.3f} ms")
        for key, ms, n in prof["top_device_ms"]:
            print(f"  {ms:9.3f} ms  x{n:<5d} {key[:90]}")
        print(f"[{label}] bench_torch.py at batch {bench_line['batch_size']}: median step ms "
              f"{bench_line['median_step_ms']:.3f} ({bench_line['value']:.2f} audio-s/s), profiled step "
              f"{bench_line['step_ms']:.3f} ms, idle_share {bench_line['idle_share']:.3f}; the fit's step is "
              f"{step_ms / bench_line['median_step_ms']:.3f} x the bench's")
    for row in rows:
        key = ROW_COUNTER.get(row["name"])
        if key in launches:
            row["launches"] += launches[key] + launches2[key]
    print(f"[{label} total] {time.perf_counter() - t_phase:.1f} s")
    return dict(step_ms=step_ms, step_ms_readings=readings, profile={k: v for k, v in prof.items() if k not in ("top_device_ms", "phase")})


# the kernels line's rows -> the launch counters of their wrappers
ROW_COUNTER = {
    "flanger_delay_line": "flanger", "phaser_allpass": "phaser", "conv_wgrad_tapcat": "conv_wgrad",
    "lstm_effect_model": "lstm_forward", "lstm_effect_model_train_fwd": "lstm_train_forward",
    "lstm_effect_model_train_bwd": "lstm_backward",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from mod_extraction_tpu_torch.ops import conv_kernels as ck
    from mod_extraction_tpu_torch.ops import cuda_build
    from mod_extraction_tpu_torch.ops import fx_kernels as fxk
    from mod_extraction_tpu_torch.ops import lstm_kernels as lk

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    rng = np.random.default_rng(0)

    # -- build: one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("fx.cu", "lstm.cu", "conv_wgrad.cu")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(lambda src: cuda_build.build(src, verbose=True), sources))
    print(f"[build] {' '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = run_stage1(fxk, rng)
    print(f"[stage 1 total] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += run_stage1_kernel_wgrad(fxk, ck, rng)
    print(f"[stage 1 (wgrad=pallas) total] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h64 = {}
    rows += run_stage2(fxk, lk, rng, rows[0], h64)
    print(f"[stage 2 total] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h160_rows, k1_h160 = run_stage2_h160(fxk, lk, rng, h64)
    rows += h160_rows
    rows[0]["d1764_h160_path_launches"] = k1_h160
    print(f"[stage 2 H 160 total] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving = run_serving(lk, rng)
    k3_row = next(r for r in rows if r["name"] == "lstm_effect_model")
    k3_row["launches"] += serving["launches"][64]
    k3_row["serving"] = {k: v for k, v in serving.items() if k != "h160"}
    k3_h160 = next(r for r in rows if r["name"] == "lstm_effect_model_h160")
    k3_h160["launches"] += serving["launches"][160]
    k3_h160["serving"] = serving["h160"]
    print(f"[serving total] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench_lines = run_bench()
    print(f"[bench_torch total] {time.perf_counter() - t0:.1f} s")

    counters = (fxk, ck, lk)
    none = {k: 0 for c in counters for k in c.LAUNCHES}
    n_batches = FIT_TRAIN_BATCHES + FIT_VAL_BATCHES
    fits = {
        "fit stage 1": run_fit(
            "fit stage 1", FIT_LFO_CONFIG, counters,
            lambda task: dict(none, flanger=n_batches, phaser=n_batches), bench_lines[0], rows),
        "fit stage 2": run_fit(
            "fit stage 2", FIT_TBPTT_CONFIG, counters,
            lambda task: dict(none, lstm_forward=n_batches,
                              lstm_train_forward=FIT_TRAIN_BATCHES * task.updates_per_batch,
                              lstm_backward=FIT_TRAIN_BATCHES * task.updates_per_batch),
            bench_lines[1], rows),
    }
    print("[fits] " + json.dumps(fits))

    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
