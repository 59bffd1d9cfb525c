"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `mod_extraction_tpu_torch/csrc/` (one
`nvcc` per source, started together), holds each against its plain PyTorch
version on the card, then drives the ported paths through the port's entry
points at full width:

* stage 1, the extractor step: the paper Spectral2DCNN (6x64 channels, 256
  mels, 2 s clips at 44.1 kHz, bf16 convs) holding the shipped r7 weights, a
  `val_step` and a few AdamW `train_step`s on interwoven (flanger + chorus +
  phaser) synthetic batches of 32 (kernels K1, K2, and K6, which takes the
  five 64-channel layers' weight gradients on the default path: five
  launches a train step, none a `val_step`);
* K7, the trunk's block between two convs (`ops/trunk_kernels.py`): held
  against its plain version (the eager chain) at the extractor's six block
  shapes, timed forward and forward + backward at batch 99 beside its byte
  bound and the eager chain; a stage-1 step counts six K7 launches each way;
* K6 alone at the trunk's shapes, reading the cotangent in the time-phase
  form the default route gives it, then the same step in its explicit
  weight-gradient configuration, `Spectral2DCNN(wgrad_impl="pallas")`: the
  five 64-channel trunk layers take their weight gradient from K6 through
  `make_conv2d_custom` (kernels K1, K2, K6); a backward of it and one of the
  default configuration are held against the library's route (the library's
  weight gradients) from the same weights, batch and SpecAugment draws, and
  the step is timed beside the other conv configurations;
* stage 2, TBPTT effect-model training as configured by
  `configs/train_em_sim_flanger_r7.yml`: the shipped LSTM-64 conditioned on
  the frozen r7 extractor (bf16), flanger batches of 32, a 1024-sample
  warm-up and 83 chunk updates of 1024 samples per step, a `val_step` and
  a few `train_step`s (kernels K1, K3, K4, K5), held against the CPU at
  batch 3, whose side runs in a process of its own from before stage 1;
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
  and through the `torch.export` artifact reloaded on the card (its
  `process_np` a CUDA graph replay, held bit for bit against its eager
  `process`); K3 timed per buffer beside its latency floor, the real-time
  factors and the artifact's host ms a call, replayed and eager;
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
  (`cli.fit(..., profile_steps=...)`), beside the bench at the same batch;
* `eval`, the evaluation path as a user runs it from the repo root, in a
  temporary working directory: the riff corpus, the sim corpora of
  `scripts/make_sim_effect_data_torch.py` (K1, K2) and the ground-truth
  control corpora of `scripts/make_sim_chorus_gt_control_torch.py` (K1)
  written on the card, one written wet held against K1's plain version,
  then `scripts/run_eval_grid_torch.py` (each variant cut to two val
  batches, one for the effect models) on `eval_lfo.yml` (K2, the r7
  extractor at batch 125), `eval_lfo_flanger.yml` (K1),
  `eval_em_unseen_effect.yml` (the imported LSTM-64s' forward, K3),
  `--unseen-audio` (the five synthetic domains: K1, K2) and `--em-sim`
  (every sim effect's LSTM-64 and rand-baseline tables, the
  ground-truth controls, the LSTM-160 capacity bracket on the cluster
  forward and the seed-2 chorus3 pair: K3 at H 64 and 160); every archive
  written with no FAILED or SKIPPED block, the launches those of the
  batches validated, each config's wall time and examples a second
  printed, and `eval_lfo.yml` at one val batch held card against CPU;
* `reference`, the reference's `.pt` checkpoints (`models/torch_port.py`):
  the shipped egfx phaser LSTM-64, the extractor of
  configs/eval_em_unseen_effect.yml and the r7 extractor rewritten in the
  reference's state_dict layout, loaded strictly into reference-architecture
  modules and imported back to the shipped `.npz` files by
  `scripts/import_reference_weights_torch.py`; the imported extractor
  against the reference module on the card; `eval_lfo.yml` from the `.pt`
  beside the `.npz` (K2); configs/train_em_sim_flanger_r7.yml's task on the
  r7 `.pt` beside the `.npz`, one step each bit for bit (K1, K3, K4, K5);
  the imported LSTM-64 against `nn.LSTM` and streamed stereo (K3);
* `ddp`, data parallelism (`parallel/dist.py`) on the one card: (a) the
  two fit configs' `cli.fit` in one rank of a real NCCL group (spawned with
  torchrun's variables) against the same fits with no group, losses and
  final weights bit for bit, and the stage-1 and H 64 steps timed with and
  without the group in turns, with the TBPTT step's all-reduces alone;
  (b) two ranks sharing the card (gloo over CUDA tensors), 16 rows each of
  a batch of 32: the stage-1 step bit for bit the one-process step over
  the same two halves (its loss also within 1e-5 of the full-batch step),
  the stage-1 step with `sub_batch_size` 8 (each rank 4 rows of each of the
  4 sub-batches: K1 and K2 4 times a rank) bit for bit the one-process step
  over the same shares, its loss within 1e-5 of the one-process sub-batched
  step and, in float32 convs, its gradients within 2e-2 of that step's,
  the H 64 and H 160 TBPTT steps within the JAX oracle's
  tolerances of the full-batch step, every rank's launches those of a whole
  step; (c) the resampler, card against CPU;
* `variants`, the TCN extractor and the TBPTT variants through
  `cli.RunConfig` on shipped configs changed in memory: (a) the SpectralTCN
  extractor (5 x 96 channels, kernel 13, dilations 1-16) as stage 1 on
  interwoven batches of 32 (K1, K2); (b) a SpectralDSTCN param-model
  latent (in_dim 4: K3, K4, K5 held against plain on the path's arguments,
  dseq's latent rows included), (c) the r7 extractor unfrozen and trained
  in every chunk, (d) `stretch_smooth_n_frames: 4`, each on
  configs/train_em_sim_flanger_r7.yml's task over dry/wet flanger pairs of
  32 (the wet through K1); (e) `train_steps` bit for bit two `train_step`s.
  (a)-(d) are also held against the CPU (batch 2 of 0.5 s clips, float32
  convs), the CPU side in spawned processes once the card's paths are timed;
* `prep`, the data-preparation scripts and the lineage tools as a user runs
  them: (a) a riff corpus through `scripts/make_synthetic_corpus_torch.py`;
  (b) `scripts/generate_preproc_datasets_torch.py` on in-memory copies of
  `configs/data/gen_idmt_fl.yml` and `gen_idmt_ch.yml` pointed at it (batch
  128 x 88200, 256 examples each: K1 at delay lines 485 and 1764), every
  triplet read back through `PreprocessedDataset` and the `random_preproc`
  module, the first batch's rows 0-1 rendered on the CPU, K1 timed at 128
  rows; (c) `scripts/measure_phaser_warmup_delta_torch.py` at batch 64 with
  the shipped r5 extractor (K2 at T 88200 and 176400), card vs CPU at batch
  2 in float32 convs; (d) `scripts/train_resumable_torch.sh` on the fit
  phase's cut r7 extractor config, two epochs in two processes (K1, K2,
  counted by each process), then `scripts/export_best_torch.sh` and the
  export loaded in `Spectral2DCNN`; (e) the EGFx split of
  `scripts/split_datasets_torch.py`, resampled on the card against the CPU.

For each path it checks that every kernel of the path ran on it (launch
counts), that the outputs are finite, and that the path on the card agrees
with the same path on the CPU in float32 (plain kernel versions).  K1,
which steps each row a warp's worth of samples at a time where its feedback
allows, is also held at the edges of its steps (delay lines of 2 to 1764
samples, T around a warp and a chunk, delays outside the line) and on both
paths' batches against the sequential walk bit for bit, its per-row step
counts against the plain count, and timed in turns with the walk.

Prints the card's name and power limit, per-step times, a profile of one
step of each path, every phase's seconds, and on the last two lines a JSON
object of per-kernel measurements and a JSON status line.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
Imports torch, numpy and the port only.

On a machine without a card, the same entry point trains on the CPU with
the config's `custom.cpu_*` sizes: `python scripts/train_torch.py <config>
--device cpu`; the CPU tests hold it against the JAX package
(`python -m pytest tests/test_torch_fit.py tests/test_torch_cli.py
tests/test_torch_data.py`).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import bench_torch
from bench_torch import LOSSES, LSTM64, N_SAMPLES, PAPER, R7, SR, TBPTT
from mod_extraction_tpu_torch.ops import trunk_kernels as tk
from mod_extraction_tpu_torch.ops.launches import launch_counts, read_launch_log, reset_launch_counts
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
# K6 launches a backward of the bf16 extractor: the trunk's default conv on
# the card takes the 64-channel layers' weight gradients from K6
K6_A_BACKWARD = len(WGRAD_LAYERS)
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


def check_kernels_small(fxk, rng, tmp: Path) -> tuple:
    """K1 in the flanger (d = 485) and chorus (d = 1764) regimes and K2, at
    b*c = 48 recurrences (48 blocks) and T = 6000; then `check_phaser_scan`,
    whose pending CPU check it returns."""
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
    return check_phaser_scan(fxk, rng, tmp)


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


def check_k1_path(fxk, args, label: str) -> dict:
    """K1 at a path's shape: the stepped kernel against the walk (bits) and
    the plain step counts; the two kernels timed in turns (walk, steps,
    steps, walk); the worst row's steps and the cycles a step at the SM
    clock under load.  The output (`out`, on the CPU) is held against the
    plain version by the caller, in a CPU process beside the card
    (`start_plain_on_cpu`)."""
    x, delay, d = args[0], args[1], args[-1]
    n_rows, t_len = x.shape[0] * x.shape[1], x.shape[2]
    out, stats = fxk.flanger(*args, step_counts=True)
    same = torch.equal(out, fxk.flanger(*args, walk=True))
    steps = stats[:, 0].cpu()
    want = fxk.flanger_step_counts(delay, d, x.shape)
    res = dict(steps_max=int(steps.max()), steps_median=float(steps.float().median()),
               steps_total=int(steps.sum()), waits=int(stats[:, 1].sum()), out=out.cpu(),
               bound_ms=4 * (3 * n_rows * t_len + 3 * n_rows) / HBM_BYTES_S * 1e3)
    turns = {True: [], False: []}
    for walk in (True, False, False, True):
        turns[walk].append(cuda_ms_median(lambda: fxk.flanger(*args, walk=walk)))
    res["ms"], res["walk_ms"] = float(np.mean(turns[False])), float(np.mean(turns[True]))
    res["mhz"] = sm_clock_mhz(lambda: fxk.flanger(*args))
    res["cycles_per_step"] = res["ms"] * 1e3 * res["mhz"] / res["steps_max"]
    print(f"[K1 {label}] walk's bits: {same}; steps = plain count: {torch.equal(steps, want)}; steps worst "
          f"row {res['steps_max']} median {res['steps_median']:.0f} total {res['steps_total']} (walk: {t_len} a "
          f"row); walker waits {res['waits']}; in turns ms={res['ms']:.4f} walk_ms={res['walk_ms']:.4f} "
          f"({res['walk_ms'] / res['ms']:.1f}x); {res['cycles_per_step']:.1f} cycles a step at "
          f"{res['mhz']:.0f} MHz")
    if not same:
        fail(f"K1 {label}: the steps do not give the walk's bits")
    if not torch.equal(steps, want):
        fail(f"K1 {label}: steps differ from the plain count in rows "
             f"{torch.nonzero(steps != want).flatten().tolist()}")
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


def check_phaser_scan(fxk, rng, tmp: Path) -> tuple:
    """K2 against its plain version at the edges of the scan (T, stages),
    with feedback 0.7 and g over [0.001, 32], then at the full (32, 88200)
    shape there, with the scan's own numbers; the plain version of the full
    shape runs in a CPU process beside the card, returned as (label, the
    process, its file, the kernel's output) for `plain_results`."""
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
    label = f"K2 n={BATCH} T={N_SAMPLES} fb 0.7, g 0.001-32"
    (tmp / "k2_extremes").mkdir()
    pending = (label, *start_plain_on_cpu("phaser_plain", [(*args, 6)], tmp / "k2_extremes"),
               [fxk.phaser(*args, 6).cpu()])
    max_p, max_z, z_err = phaser_scan_numerics(fxk, args)
    print(f"[{label}] max|P_c|={max_p:.4f} max|z_c|={max_z:.4f} z_c vs float64 walk {z_err:.3e}; against its "
          f"plain version in a CPU process beside the card")
    if not z_err <= KERNEL_TOL:
        fail(f"K2's chunk entry states are {z_err} from a float64 walk")
    return pending


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


def run_stage1(fxk, rng) -> tuple:
    """Stage 1's checks and main path.  The plain K1 / K2 loops at (32,
    88200) run in CPU processes beside the card's work (the kernels' rows
    carry their CPU ms as `plain_ms`, `plain_device` "cpu").  Returns (K1's
    and K2's rows, K6's launches in the train steps as its counter read
    them)."""
    with tempfile.TemporaryDirectory() as tmp:
        return _run_stage1(fxk, rng, Path(tmp))


def _run_stage1(fxk, rng, tmp: Path) -> tuple:
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        flanger_max_delay_samples,
        make_interwoven_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops import conv_kernels as ck
    from mod_extraction_tpu_torch.ops.fx import phaser_coefficients
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig, phaser_params

    # -- kernels against their plain versions, small regimes
    pending = [check_kernels_small(fxk, rng, tmp)]

    # -- the main path's batches; K1 and K2's plain versions on the last
    #    one start on the CPU now
    d = flanger_max_delay_samples(30.0, 10.0, SR)  # 1764: the interwoven line
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3), max_delay_samples=d)
    val_batch = batch_to_torch(make_interwoven_batch(1000, BATCH, N_SAMPLES, SR))
    train_batches = [
        batch_to_torch(make_interwoven_batch(s, BATCH, N_SAMPLES, SR))
        for s in range(N_TRAIN_STEPS + 1)
    ]
    tb = train_batches[-1]
    dry, fx = tb["dry"], tb["fx"]
    n_lanes, t_len = dry.shape[0] * dry.shape[1], dry.shape[2]
    k1_path = k1_args(tb, d)
    pp = phaser_params(fx, SR)
    g, _ = phaser_coefficients(N_SAMPLES, SR, pp["rate_hz"], pp["depth"],
                               pp["centre_frequency_hz"], pp["phase"])
    ph_args = (dry, g[:, None, :], pp["feedback"][:, None, None], pp["mix"][:, None, None], 6)
    for name, args in (("flanger_plain", k1_path), ("phaser_plain", ph_args)):
        (tmp / name).mkdir()
        pending.append((name, *start_plain_on_cpu(name, [args], tmp / name)))

    # -- the main path, counted
    model = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = LFOExtractionTask(model, cfg, loss_dict=LOSSES, device="cuda", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fxk.reset_launch_counts()
    tk.reset_launch_counts()
    ck.reset_launch_counts()
    val = {k: v.item() for k, v in task.val_step(val_batch).items()}
    print(f"[val_step r7 bf16 b={BATCH}] " + " ".join(f"{k}={v:.6f}" for k, v in sorted(val.items())))
    if tk.LAUNCHES != {"trunk_block_fwd": K7_A_PASS, "trunk_block_bwd": 0}:
        fail(f"stage 1 val_step: K7 launched {tk.LAUNCHES}, expected {K7_A_PASS} forward")
    if ck.LAUNCHES["conv_wgrad"] != 0:
        fail(f"stage 1 val_step: K6 launched {ck.LAUNCHES}, expected none (no gradient)")
    tk.reset_launch_counts()
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
    want = N_TRAIN_STEPS + 1
    if tk.LAUNCHES != {"trunk_block_fwd": K7_A_PASS * want, "trunk_block_bwd": K7_A_PASS * want}:
        fail(f"stage 1: {want} train steps launched K7 {tk.LAUNCHES}, expected {K7_A_PASS} each way a step")
    k6_launches = ck.LAUNCHES["conv_wgrad"]
    if k6_launches != K6_A_BACKWARD * want:
        fail(f"stage 1: {want} train steps launched K6 {ck.LAUNCHES}, expected {K6_A_BACKWARD} a step")
    print(f"[stage 1 K7] {K7_A_PASS} forward + {K7_A_PASS} backward launches a train step, "
          f"{K7_A_PASS} forward a val_step; K6 {K6_A_BACKWARD} a train step, none a val_step")
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
    k1 = check_k1_path(fxk, k1_path, f"stage 1 batch, interwoven seed {N_TRAIN_STEPS}, d {d}")
    out = fxk.phaser(*ph_args)
    ms = cuda_ms_median(lambda: fxk.phaser(*ph_args))
    max_p, max_z, z_err = phaser_scan_numerics(fxk, ph_args[:4])
    print(f"[phaser_allpass scan on the path's data, chunk {fxk.PHASER_CHUNK}] max|P_c|={max_p:.4f} "
          f"max|z_c|={max_z:.4f} z_c vs float64 walk {z_err:.3e}")
    # -- where one full-width train step spends the card's time
    profile_train_step(task, train_batches[1], "stage 1")

    # -- the plain versions' outputs from their CPU processes
    t0 = time.perf_counter()
    label, proc, dst, outs = pending[0]
    (err_x,), _ = plain_results(proc, dst, outs, label)
    print(f"[{label}] max_abs_err={err_x:.3e} against its plain version (CPU)")
    (k1["err"],), (k1["plain_ms"],) = plain_results(*pending[1][1:3], [k1["out"]], "K1 on stage 1's path")
    (err,), (plain_ms,) = plain_results(*pending[2][1:3], [out.cpu()], "K2 on stage 1's path")
    print(f"[stage 1 plain versions on the CPU] waited {time.perf_counter() - t0:.1f} s for them; K1 "
          f"max_abs_err={k1['err']:.3e} plain_ms={k1['plain_ms']:.1f}; K2 max_abs_err={err:.3e} "
          f"plain_ms={plain_ms:.1f} (one CPU thread each)")
    print(f"[phaser_allpass n={n_lanes} T={t_len}] max_abs_err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f} (CPU)")
    k1_row = kernel_row(
        "flanger_delay_line", "mod_extraction_tpu_torch/csrc/fx.cu",
        "mod_extraction_tpu/ops/pallas_fx.py:45", launches["flanger"], k1["err"], k1["ms"],
        k1["plain_ms"], 4 * (3 * n_lanes * t_len + 3 * n_lanes), 16 * n_lanes * t_len, None,
    )
    k1_row.update({k: k1[k] for k in K1_EXTRA}, plain_device="cpu")
    k2_row = kernel_row(
        "phaser_allpass", "mod_extraction_tpu_torch/csrc/fx.cu", "mod_extraction_tpu/ops/pallas_fx.py:156",
        launches["phaser"], err, ms, plain_ms, 4 * (3 * n_lanes * t_len + 2 * n_lanes),
        43 * n_lanes * t_len, None,
    )
    k2_row.update(chunk=fxk.PHASER_CHUNK, max_p=max_p, z_err=z_err, plain_device="cpu")
    return [k1_row, k2_row], k6_launches


# ---------------------------------------------------------------------------
# K7: the trunk's block between two convs
# ---------------------------------------------------------------------------

K7_A_PASS = len(PAPER["out_channels"])  # K7 launches a forward (and a backward) of the extractor
K7_BATCH = 99  # the shipped stage-1 batch (configs/train_lfo_interwoven_all_live_r7.yml)
K7_CHECK_BATCH = 4
# held against the plain version: what the sums' order leaves (tests/test_torch_trunk_block_cuda.py)
K7_BF16_STEP, K7_NEAR_ZERO, K7_SUM_REL = 2.0**-7, 1e-5, 1e-3


def outside_k7(counts: dict) -> dict:
    """Launch counts without K7's.  A phase that runs the extractor holds
    its own kernels' launches; K7's are held a step in stage 1 and in the
    trunk-block phase."""
    return {k: v for k, v in counts.items() if k not in tk.LAUNCHES}


def trunk_block_shapes(batch: int) -> list:
    """The extractor's six blocks: (label, conv output in its phase form,
    Block), frames and rows as the paper's config gives them."""
    frames = N_SAMPLES // PAPER["hop_len"] + 1
    h, out = PAPER["n_mels"], []
    for i, (c, d) in enumerate(zip(PAPER["out_channels"], PAPER["temp_dilations"])):
        last = i == len(PAPER["out_channels"]) - 1
        blk = tk.Block(phases=d, width=frames, pool=PAPER["pool_size"][0], ln=not last,
                       out_dtype=torch.float32 if last else torch.bfloat16)
        out.append((f"L{i}", (batch * d, c, h, -(-frames // d)), blk))
        h //= PAPER["pool_size"][0]
    return out


def trunk_block_bytes(shape, blk) -> tuple:
    """(forward, backward) bytes K7 needs at a block: the conv output's
    frames read once each way, the output written once and its cotangent
    read once, the conv output's cotangent written once."""
    bd, c, h, _ = shape
    n_in = bd // blk.phases * c * h * blk.width
    n_out = n_in // h * (h // blk.pool)
    e_out = torch.empty((), dtype=blk.out_dtype).element_size()
    return 2 * n_in + e_out * n_out, 2 * n_in + e_out * n_out + 2 * n_in


def k7_check(y, bias, alpha, blk) -> dict:
    """K7 against the plain version on the same inputs: for each output its
    largest deviation over its tolerance (<= 1 holds; the forward bit for
    bit: 0, else inf)."""
    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (y, bias, alpha)]
        out = fn(*leaves, blk)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(out.dtype).cuda()
        return [out, *torch.autograd.grad(out, leaves, g)]

    kern, plain = run(tk.trunk_block), run(tk.trunk_block_plain)
    res = {}
    for name, k, p, rounded, is_sum in (("out", kern[0], plain[0], blk.out_dtype == torch.bfloat16, False),
                                        ("dy", kern[1], plain[1], True, False),
                                        ("dbias", kern[2], plain[2], True, True),
                                        ("dalpha", kern[3], plain[3], False, True)):
        k, p = k.float(), p.float()
        scale = p.abs().max().item()
        if is_sum:
            tol = K7_SUM_REL * scale + (K7_BF16_STEP * p.abs() if rounded else 0)
        elif rounded:
            tol = K7_BF16_STEP * p.abs() + K7_NEAR_ZERO * scale
        else:
            tol = 1e-5 * (p.abs() + scale)
        if name == "out":  # the forward gives the eager chain's bits
            res[name] = 0.0 if torch.equal(k, p) else math.inf
        else:
            res[name] = ((k - p).abs() / tol).max().item()
    return res


def run_trunk_block() -> dict:
    """K7 at the extractor's six blocks: held against its plain version at
    batch 4 and L0 at batch 99, bit for bit across two launches; then timed
    at batch 99 (CUDA-event medians of 5 x 20): the forward alone (no
    gradients), forward + backward, the eager chain's forward + backward,
    each beside K7's byte bound at 3.35 TB/s.  Returns the kernel row's
    numbers: the six blocks summed."""
    gen = torch.Generator().manual_seed(0)

    def inputs(shape, c):
        y = torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
        return y, (torch.randn(c, generator=gen) * 0.3).cuda(), (torch.rand(c, generator=gen) * 0.5).cuda()

    worst = {}
    for batch in (K7_CHECK_BATCH, K7_BATCH):
        for label, shape, blk in trunk_block_shapes(batch):
            if batch == K7_BATCH and label != "L0":
                continue
            res = k7_check(*inputs(shape, shape[1]), blk)
            print(f"[K7 {label} b={batch} {shape}] against plain, deviation / tolerance: "
                  + " ".join(f"{k}={v:.3f}" for k, v in res.items()))
            if max(res.values()) > 1:
                fail(f"K7 {label} at batch {batch}: {res} past the tolerance")
            for k, v in res.items():
                worst[k] = max(worst.get(k, 0.0), v)

    rows, tot = [], dict(fwd_ms=0.0, ms=0.0, plain_ms=0.0, bound_fwd_ms=0.0, bound_ms=0.0, bytes=0,
                         dev_fwd_ms=0.0, dev_bwd_ms=0.0, plain_dev_ms=0.0)
    for label, shape, blk in trunk_block_shapes(K7_BATCH):
        y, bias, alpha = inputs(shape, shape[1])
        leaves = [t.detach().requires_grad_() for t in (y, bias, alpha)]
        out = tk.trunk_block(*leaves, blk)
        g = torch.randn_like(out)
        first = torch.autograd.grad(out, leaves, g)
        again = torch.autograd.grad(tk.trunk_block(*leaves, blk), leaves, g)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"K7 {label}: two launches differ")

        def fwd():
            with torch.no_grad():
                tk.trunk_block(y, bias, alpha, blk)

        def both(fn=tk.trunk_block):
            torch.autograd.grad(fn(*leaves, blk), leaves, g)

        fwd_ms, ms = cuda_ms_median(fwd), cuda_ms_median(both)
        plain_ms = cuda_ms_median(lambda: both(tk.trunk_block_plain), reps=3, batches=3)
        # device time (back to back, the small blocks' events read the host's pace): every kernel
        # of the forward (K7's two, torch's mean and variance) and of forward + backward
        dev_fwd = sum(device_ms_by_kernel(fwd, 10).values())
        dev_bwd = sum(device_ms_by_kernel(both, 10).values()) - dev_fwd
        plain_dev_ms = sum(device_ms_by_kernel(lambda: both(tk.trunk_block_plain), 3).values())
        n_fwd, n_bwd = trunk_block_bytes(shape, blk)
        b_fwd, b_bwd = n_fwd / HBM_BYTES_S * 1e3, n_bwd / HBM_BYTES_S * 1e3
        row = dict(block=label, shape=shape, fwd_ms=fwd_ms, ms=ms, plain_ms=plain_ms, bound_fwd_ms=b_fwd,
                   bound_ms=b_fwd + b_bwd, bytes=n_fwd + n_bwd, dev_fwd_ms=dev_fwd, dev_bwd_ms=dev_bwd,
                   plain_dev_ms=plain_dev_ms)
        print(f"[K7 {label} b={K7_BATCH} {shape}] forward {fwd_ms:.4f} ms (bound {b_fwd:.4f}), forward + "
              f"backward {ms:.4f} ms (bound {b_fwd + b_bwd:.4f}), eager chain {plain_ms:.4f} ms; device "
              f"time: forward {dev_fwd:.4f}, backward {dev_bwd:.4f}, eager chain {plain_dev_ms:.4f} ms")
        rows.append(row)
        for k in tot:
            tot[k] += row[k]
        del y, bias, alpha, leaves, out, g, first, again
    print(f"[K7 six blocks b={K7_BATCH}] forward {tot['fwd_ms']:.4f} ms (bound {tot['bound_fwd_ms']:.4f}), "
          f"forward + backward {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f}, "
          f"{100 * tot['bound_ms'] / tot['ms']:.1f} % of it), eager chain {tot['plain_ms']:.4f} ms "
          f"({tot['plain_ms'] / tot['ms']:.2f}x); device time: forward {tot['dev_fwd_ms']:.4f} ms, "
          f"backward {tot['dev_bwd_ms']:.4f} ms ({100 * tot['bound_ms'] / (tot['dev_fwd_ms'] + tot['dev_bwd_ms']):.1f} "
          f"% of the bound), eager chain {tot['plain_dev_ms']:.4f} ms")
    return dict(tot, worst=worst, blocks=rows)


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


def check_wgrad(ck, x, g, dil, label, g_phases=None):
    """K6 against its plain version and the float32 reference, and two
    launches against each other; returns (error vs plain relative to the
    largest |dW|, the plain version's ms).  With `g_phases`, K6 reads the
    cotangent in that time-phase form (`ops/conv.py::time_phases(g, dil)`,
    as the default route gives it) and the plain version and the reference
    read g unphased."""
    if g_phases is None:
        got, again = (ck.conv2d_wgrad_tapcat(x, g, KF, KT, dil) for _ in range(2))
    else:
        got, again = (ck.conv2d_wgrad_tapcat(x, g_phases, KF, KT, dil, dy_phases=dil) for _ in range(2))
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
    from mod_extraction_tpu_torch.models import spectral_2dcnn
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops.conv import time_phases
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
    # at the path's shapes K6 reads the cotangent in the time-phase form the
    # default route gives it (the three above hold the unphased form that
    # `make_conv2d_custom`'s "pallas" gives)
    layers = []
    for f, dil in WGRAD_LAYERS:
        x, g = rand(BATCH, TRUNK_CH, f, N_FRAMES), rand(BATCH, TRUNK_CH, f, N_FRAMES)
        g_ph = time_phases(g, dil).contiguous()
        label = f"B={BATCH} F={f} T={N_FRAMES} dil={dil}, dy over {dil} time phases"
        err, plain_ms = check_wgrad(ck, x, g, dil, label, g_ph)
        n_ops, n_bytes = wgrad_ops_bytes(BATCH, f, N_FRAMES, TRUNK_CH, TRUNK_CH)
        ms = cuda_ms_median(lambda: ck.conv2d_wgrad_tapcat(x, g_ph, KF, KT, dil, dy_phases=dil))
        library_ms = cuda_ms_median(library_wgrad(x, g, dil))
        bound_ms = max(n_ops / BF16_OPS_S, n_bytes / HBM_BYTES_S) * 1e3
        print(f"[K6 {label}] ms={ms:.3f} bound_ms={bound_ms:.3f} (operations) bound/ms={bound_ms / ms:.3f} "
              f"tflops={n_ops / ms / 1e9:.1f} library_ms={library_ms:.3f} plain_ms={plain_ms:.1f}")
        layers.append(dict(bins=f, dil=dil, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, err=err, n_ops=n_ops, n_bytes=n_bytes))
        del x, g, g_ph
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

    # -- one backward in each of K6's two configurations (the default route
    #    and "pallas") and one on the library's route, whose conv weight
    #    gradients are the library's (the default conv with `wgrad_supported`
    #    false, as before K6 took them: the same forward call), all from the
    #    same weights, batch and SpecAugment draws
    draws = torch.tensor([0.31, 0.62, 0.47, 0.15])
    grads = {}
    for name, opts in (("default", {}), ("pallas", dict(wgrad_impl="pallas")), ("library", {})):
        t = make_task(**opts)
        t.model.train()
        covered = spectral_2dcnn.wgrad_supported
        if name == "library":
            spectral_2dcnn.wgrad_supported = lambda *a: False
        try:
            loss, _ = t._loss(batches[0], None, draws)
            loss.backward()
        finally:
            spectral_2dcnn.wgrad_supported = covered
        grads[name] = (loss.item(), {k: p.grad.detach().clone() for k, p in t.model.named_parameters()})
        del t
    loss_d, g_d = grads["library"]
    for name in ("default", "pallas"):
        loss_k, g_k = grads[name]
        worst = max(
            (rel_err(g_k[k], g_d[k]), k) for k in g_d if k.startswith("convs.") and k.endswith(".weight")
        )
        others = max(rel_err(g_k[k], g_d[k]) for k in g_d if not k.endswith(".weight") or k.startswith("out."))
        print(f"[wgrad={name} vs library wgrad backward] loss {loss_k:.8f}/{loss_d:.8f} conv weight gradients "
              f"max_rel={worst[0]:.3e} ({worst[1]}; limit {WGRAD_F32_REL}) other leaves max_rel={others:.3e}")
        if loss_k != loss_d:
            fail(f"the two configurations share their forward, yet the losses differ: {loss_k} vs {loss_d}")
        if not worst[0] <= WGRAD_F32_REL:
            fail(f"conv weight gradient {worst[1]} of the kernel configuration differs by {worst[0]}")
        if not others <= WGRAD_F32_REL:
            fail(f"a gradient that K6 does not compute differs between the configurations: {others}")

    # -- the train step in each conv configuration, taking turns
    configs = {
        "default (K6 wgrad)": {}, "wgrad=pallas": dict(wgrad_impl="pallas"),
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
    with torch.no_grad():  # the LFO, and a param model's latent after it
        latent = task._latent(mod_sr[:, :, :end], wet)
    seq_full = torch.cat([latent, dry[:, :, :end]], 1).contiguous()
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


# stage 2's card-vs-CPU checks: batch 3 (mixed validity), float32, the plain
# kernels on the CPU; the CPU side runs in a process of its own, started
# before stage 1, beside the card (its train step alone takes about a minute)
STAGE2_CPU_SEED, STAGE2_CPU_BATCH, STAGE2_CPU_THREADS = 2001, 3, 2


def stage2_render_cfg():
    from mod_extraction_tpu_torch.train.render import RenderConfig

    return RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2,), max_delay_samples=485)


def stage2_task(dev: str, lfo_model):
    """Stage 2's task (configs/train_em_sim_flanger_r7.yml, as bench_torch.py's
    --tbptt sets it up) with the shipped LSTM-64 on `dev`, conditioned on
    `lfo_model` (None: the ground-truth LFO)."""
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    return TBPTTEffectModelingTask(
        load_lstm_effect_model(str(LSTM64), device=dev), stage2_render_cfg(), lfo_model=lfo_model,
        device=dev, **TBPTT,
    )


def stage2_extracted(task, batch) -> tuple:
    """(the smoothed LFO, its corners, the extractor's raw output) of a
    batch under `task`'s extractor, each moved to the CPU."""
    from mod_extraction_tpu_torch.ops.corners import find_corners, smoothen
    from mod_extraction_tpu_torch.train.render import render_batch

    with torch.no_grad():
        dry, wet, mod_frames, _ = render_batch(batch, stage2_render_cfg())
    mod_hat = task._extract_mod_sig(dry, wet, mod_frames)
    sm = smoothen(mod_hat, TBPTT["model_smooth_n_frames"])
    return sm.cpu(), [x.cpu() for x in find_corners(sm)], mod_hat.cpu()


def stage2_cpu_reference(out_path: str) -> None:
    """The CPU side of stage 2's card-vs-CPU checks, in a process of its
    own: on the ground-truth LFO the val and train metrics and the LSTM's
    parameters after the step; on the r7 extractor (float32 convs) the
    smoothed LFO, its corners and the extractor's output, then the val
    metrics.  Saved to `out_path` with the seconds it took."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn

    t0 = time.perf_counter()
    torch.set_num_threads(STAGE2_CPU_THREADS)
    bt = batch_to_torch(make_synthetic_batch(STAGE2_CPU_SEED, STAGE2_CPU_BATCH, N_SAMPLES, SR, "flanger"), "cpu")
    t = stage2_task("cpu", None)
    v = {k: x.item() for k, x in t.val_step(bt).items()}
    m = {k: x.item() for k, x in t.train_step(bt).items()}
    gt = (v, m, [p.detach().cpu() for p in t.effect_model.parameters()])
    t = stage2_task("cpu", load_spectral_2dcnn(str(R7), device="cpu", **PAPER, compute_dtype="float32"))
    ext = stage2_extracted(t, bt)
    ext_val = {k: x.item() for k, x in t.val_step(bt).items()}
    torch.save(dict(gt=gt, ext=ext, ext_val=ext_val, s=time.perf_counter() - t0), out_path)


def start_cpu_side(fn: str, tmp: str) -> tuple:
    """Starts `chip_smoke.<fn>(out_path)`, the CPU side of a card-vs-CPU
    check (`stage2_cpu_reference`, `h160_cpu_reference`), in a CPU process
    (no card visible); returns (the process, the file it writes, its start
    time)."""
    import os

    out = str(Path(tmp) / f"{fn}.pt")
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.{fn}({out!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def cpu_side_result(cpu_ref: tuple, label: str, summary: dict) -> dict:
    """What `start_cpu_side`'s process wrote, once it ends; its seconds,
    the wait for it and the seconds the card saved go to `summary`."""
    proc, path, started = cpu_ref
    t0 = time.perf_counter()
    _, stderr = proc.communicate(timeout=900)
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label} on the CPU: rc {proc.returncode}: {stderr[-3000:]}")
    res = torch.load(path, weights_only=False)
    summary.update(cpu_s=res["s"], cpu_waited_s=waited, cpu_saved_s=res["s"] - waited)
    print(f"[{label} CPU side] its process took {res['s']:.1f} s beside the card (started {t0 - started:.1f} s "
          f"before it was asked for); waited {waited:.1f} s: the cut saved {res['s'] - waited:.1f} s")
    return res


def tbptt_counted_steps(fxk, lk, task, train_batches, label: str) -> tuple:
    """A fresh task's train steps, each profiled and counted: K1 and the
    warm-up's K3 by their Python counters and device events, once a step;
    K4 and K5 by their device events, once a chunk update.  The chunk
    updates replay a CUDA graph, so K4's and K5's Python counters tick only
    at the task's first update (eager) and its capture, both in step 0, the
    one step with a `tbptt.capture` span; after it the task's graph cache
    holds that one shape, captured.  Then the steps after the first again,
    unprofiled and timed.  Returns (the launches summed, K3-K5's from their
    device events; the last metrics; the timed steps' seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from mod_extraction_tpu_torch.utils import spans

    n_up = task.updates_per_batch
    per_step = dict(flanger=1, phaser=0, lstm_forward=1, lstm_train_forward=n_up, lstm_backward=n_up)
    total = dict.fromkeys(per_step, 0)
    for i, tb in enumerate(train_batches):
        fxk.reset_launch_counts()
        lk.reset_launch_counts()
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            metrics = task.train_step(tb)
            torch.cuda.synchronize()
        c = {**fxk.LAUNCHES, **lk.LAUNCHES}
        python = {k: c[k] for k in per_step}
        device = lstm_device_launches(prof)
        captures = spans.summary().get("tbptt.capture", {"count": 0})["count"]
        spans.clear()
        first = 2 if i == 0 else 0
        want = dict(per_step, lstm_train_forward=first, lstm_backward=first)
        got = {**python, **device}
        kept = task.graphs.captured()
        if python != want or got != per_step or captures != int(i == 0) or len(kept) != 1:
            fail(f"{label} train_step {i}: Python launches {python}, expected {want}; device events {device}, "
                 f"expected {per_step}; captures {captures}; captured shapes kept {kept}, expected one")
        total = {k: total[k] + got[k] for k in per_step}
        print(f"[{label} train_step {i}] " + " ".join(f"{k}={v.item():.6f}" for k, v in sorted(metrics.items()))
              + f" launches: device {got}, Python {python}, captures {captures}")
    step_s = []
    for tb in train_batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = task.train_step(tb)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return total, metrics, step_s


def tbptt_python_launches(task, n_steps: int) -> dict:
    """K4's and K5's Python counts over a fresh task's first `n_steps`
    train steps of one batch shape: once an update on the eager loop; with
    the chunk updates replayed (`task.static_chunks`), once at the first
    update (eager) and once at the capture."""
    n = 2 if task.static_chunks else n_steps * task.updates_per_batch
    return dict(lstm_train_forward=n, lstm_backward=n)


def run_stage2(fxk, lk, rng, k1_row: dict, summary: dict, cpu_ref: tuple) -> list:
    """Stage 2's checks and main path; adds K1 on stage 2's batch (d 485) to
    `k1_row` under "d485", and the step's mean, profiled wall and busy ms and
    the CPU side's seconds to `summary`.  `cpu_ref`: `start_cpu_side`'s
    process of `stage2_cpu_reference`, collected for the card-vs-CPU
    checks."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops.corners import smoothen

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
    cfg = stage2_render_cfg()
    extractor = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = stage2_task("cuda", extractor)
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
    # step 0 warms up the allocator and the cuDNN plans and captures the chunk update
    steps, metrics, step_s = tbptt_counted_steps(fxk, lk, task, train_batches, "TBPTT")
    total = {k: total[k] + steps[k] for k in keys}
    print(f"[stage 2 main path] launches={total} (K3-K5: device events); timed steps ms "
          f"{[round(x * 1e3, 2) for x in step_s]}")
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

    # -- K1 on the path's last train batch (d 485); its plain version in a
    #    CPU process beside the rest of the phase
    d = cfg.max_delay_samples
    k1_path = k1_args(train_batches[-1], d)
    plain_tmp = tempfile.TemporaryDirectory()
    k1_plain = start_plain_on_cpu("flanger_plain", [k1_path], Path(plain_tmp.name))
    k1 = check_k1_path(fxk, k1_path, f"stage 2 batch, flanger seed {N_TBPTT_STEPS}, d {d}")

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

    # -- the whole path against the CPU, float32, batch 3, plain kernels there
    #    (the CPU side from `stage2_cpu_reference`'s process, asked for last:
    #    the replayed steps are fast, so it needs the card work above to end).
    #    Ground-truth conditioning: val and train metrics and the parameters.
    ref_np = make_synthetic_batch(STAGE2_CPU_SEED, STAGE2_CPU_BATCH, N_SAMPLES, SR, "flanger")  # mixed validity
    t = stage2_task("cuda", None)
    bt = batch_to_torch(ref_np, "cuda")
    v = {k: x.item() for k, x in t.val_step(bt).items()}
    m = {k: x.item() for k, x in t.train_step(bt).items()}
    out = {"cuda": (v, m, [p.detach().cpu() for p in t.effect_model.parameters()])}
    cpu = cpu_side_result(cpu_ref, f"stage 2, b={STAGE2_CPU_BATCH}", summary)
    out["cpu"] = cpu["gt"]
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
        t = stage2_task("cuda", None)
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
    t = stage2_task("cuda", load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="float32"))
    ext = {"cuda": stage2_extracted(t, bt), "cpu": cpu["ext"]}
    sm_err = max_abs(ext["cuda"][0], ext["cpu"][0])
    flips = sum(int((x != y).sum()) for x, y in zip(ext["cuda"][1], ext["cpu"][1]))
    # the smoothing itself gives the CPU's bits on the card (additions in a
    # fixed order), so flips can come only from the extractor's output
    sm_exact = torch.equal(ext["cuda"][0], smoothen(ext["cuda"][2], TBPTT["model_smooth_n_frames"]))
    print(f"[TBPTT r7 f32 LFO card vs CPU, b=3] smoothed max_abs={sm_err:.3e} corner_flips={flips} "
          f"smoothing_bit_exact={sm_exact}")
    if not sm_err <= KERNEL_TOL:
        fail(f"extracted LFO: card vs CPU max-abs {sm_err}")
    if not sm_exact:
        fail("smoothing the same LFO gives other bits on the card than on the CPU")
    if flips == 0:
        vals = {"cuda": {k: x.item() for k, x in t.val_step(bt).items()}, "cpu": cpu["ext_val"]}
        for k in vals["cpu"]:
            if not math.isclose(vals["cuda"][k], vals["cpu"][k], rel_tol=VAL_RTOL, abs_tol=1e-6):
                fail(f"TBPTT val_step (r7) {k}: card {vals['cuda'][k]} vs CPU {vals['cpu'][k]}")
        print("[TBPTT val_step f32 r7 card vs CPU, b=3] " + " ".join(
            f"{k}={vals['cuda'][k]:.6f}/{vals['cpu'][k]:.6f}" for k in sorted(vals["cpu"])))
    else:
        print("[TBPTT val_step f32 r7 card vs CPU] not compared: the corners differ")

    t0 = time.perf_counter()
    (k1["err"],), (k1["plain_ms"],) = plain_results(*k1_plain, [k1["out"]], "K1 on stage 2's path")
    plain_tmp.cleanup()
    print(f"[K1 stage 2 batch, d {d}, plain version on the CPU] max_abs_err={k1['err']:.3e} "
          f"plain_ms={k1['plain_ms']:.1f}; waited {time.perf_counter() - t0:.1f} s for it")
    k1_row["d485"] = dict(launches=total["flanger"], max_abs_err=k1["err"], ms=k1["ms"],
                          plain_ms=k1["plain_ms"], plain_device="cpu", bound_ms=k1["bound_ms"],
                          **{k: k1[k] for k in K1_EXTRA})
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


H160_CPU_SEED, H160_CPU_BATCH = 2101, 3  # the card-vs-CPU step at H 160


def h160_task(dev: str, lfo_model):
    """The task of configs/train_em_sim_chorus_h160.yml (its AdamW and task
    arguments, the shipped LSTM-160) on `dev`, conditioned on `lfo_model`
    (None: the ground-truth LFO), rendering chorus (delay line 1764)."""
    from mod_extraction_tpu_torch.cli import build_optimizer, load_yaml_with_includes
    from mod_extraction_tpu_torch.data.synthetic import CHORUS_DELAYS_MS, flanger_max_delay_samples
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    config = load_yaml_with_includes(H160_CONFIG)
    margs = config["model"]["init_args"]
    kw = {k: margs[k] for k in ("warmup_n_samples", "step_n_samples", "use_dry", "model_smooth_n_frames",
                                "should_stretch", "max_n_corners", "discard_invalid_lfos", "loss_dict")}
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2,),
                       max_delay_samples=flanger_max_delay_samples(*CHORUS_DELAYS_MS, SR))
    return TBPTTEffectModelingTask(load_lstm_effect_model(str(LSTM160), device=dev), cfg, lfo_model=lfo_model,
                                   optimizer=build_optimizer(config["optimizer"]), device=dev, **kw)


def h160_step(dev: str) -> tuple:
    """One float32 step of `h160_task` on the ground-truth LFO at batch 3 on
    `dev` (the plain kernels on the CPU): (val metrics, train metrics, the
    LSTM's parameters after the step's 84 AdamW updates, on the CPU)."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch

    t = h160_task(dev, None)
    bt = batch_to_torch(make_synthetic_batch(H160_CPU_SEED, H160_CPU_BATCH, N_SAMPLES, SR, "chorus"), dev)
    v = {k: x.item() for k, x in t.val_step(bt).items()}
    m = {k: x.item() for k, x in t.train_step(bt).items()}
    return v, m, [p.detach().cpu() for p in t.effect_model.parameters()]


def h160_cpu_reference(out_path: str) -> None:
    """The CPU side of the H 160 card-vs-CPU step, in a process of its own
    (`start_cpu_side`): `h160_step` on the CPU, saved to `out_path` with the
    seconds it took."""
    t0 = time.perf_counter()
    torch.set_num_threads(STAGE2_CPU_THREADS)
    gt = h160_step("cpu")
    torch.save(dict(gt=gt, s=time.perf_counter() - t0), out_path)


def run_stage2_h160(fxk, lk, rng, h64: dict, cpu_ref: tuple) -> tuple:
    """The shipped H 160 chorus model's TBPTT training as its config sets it
    up (batch 32, warm-up and 83 chunks of 1024, the config's AdamW, the
    frozen r6 extractor in bf16) on synthetic chorus batches (delay line
    1764): the kernels at the path's shapes with the shipped weights, a
    `val_step` and a few `train_step`s counted per step and timed beside
    the H 64 step (`h64`), one step on the card against the CPU (its CPU
    side `cpu_ref`, `start_cpu_side`'s process of `h160_cpu_reference`), K3
    over the val_step clip against a float64 walk, the kernels' rows and a
    profile.  Returns (rows, K1's launches); the CPU side's seconds go to
    `h64["h160 cpu"]`."""
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn

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
    if not (margs["effect_model"]["init_args"]["n_hidden"] == hid
            and Path(margs["lfo_model_weights_path"]).name == R6.name
            and config["data"]["init_args"]["batch_size"] == BATCH):
        fail(f"{H160_CONFIG} no longer names H {hid}, the r6 extractor and batch {BATCH}")

    # -- the kernels at the path's shapes with the shipped weights
    em_w = load_lstm_effect_model(str(LSTM160), device="cuda")
    a = lstm_inputs(rng, BATCH, TBPTT_CHUNK, hid)
    a.update(w_ih=em_w.w_ih.detach(), w_hh=em_w.w_hh.detach(), b=em_w.b_gates.detach(),
             fc_k=em_w.fc_kernel.detach(), fc_b=em_w.fc_bias.detach())
    check_lstm_kernels(lk, a, 9, f"LSTM B={BATCH} T={TBPTT_CHUNK} H=160 (shipped weights)")

    # -- the main path, counted per step
    extractor = load_spectral_2dcnn(str(R6), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = h160_task("cuda", extractor)
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
    steps, metrics, step_s = tbptt_counted_steps(fxk, lk, task, train_batches, "TBPTT H 160")
    total = {k: total[k] + steps[k] for k in keys}
    print(f"[stage 2 H 160 main path] launches={total} (K3-K5: device events); timed steps ms "
          f"{[round(x * 1e3, 2) for x in step_s]}")
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
    #    conditioning, plain kernels there (`h160_step`; the CPU side from
    #    its own process): the val and train metrics and the parameters
    #    after the step's 84 AdamW updates
    out = {"cuda": h160_step("cuda")}
    h64["h160 cpu"] = {}
    out["cpu"] = cpu_side_result(cpu_ref, f"stage 2 H 160, b={H160_CPU_BATCH}", h64["h160 cpu"])["gt"]
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


def serve_buffers_thrice(rng, total: int) -> list:
    """As `serve_buffers`, each length three times in a row (the last run
    cut to the total): the loaded artifact runs a length's first call
    eagerly, captures its graph at the second and replays it at the
    third."""
    sizes = []
    for n in serve_buffers(rng, total):
        sizes += [n] * 3
    cut, out = total, []
    for n in sizes:
        if cut <= 0:
            break
        out.append(min(n, cut))
        cut -= out[-1]
    return out


def lstm_device_launches(prof) -> dict:
    """K3, K4 and K5 among a profile's device events, under their Python
    counters' names: each launch, whether issued alone or by a graph
    replay.  A forward kernel (`lstm_fwd_*`) whose template saves the states
    (`true`) is K4, else K3; a K5 call runs one reverse walk (`lstm_bwd_*`)."""
    out = dict(lstm_forward=0, lstm_train_forward=0, lstm_backward=0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "lstm_fwd_" in e.name:
            args = e.name.partition("<")[2].partition(">")[0]
            out["lstm_train_forward" if "true" in args else "lstm_forward"] += 1
        elif "lstm_bwd_" in e.name:
            out["lstm_backward"] += 1
    return out


def profiled_artifact_drive(lk, art, x, sizes, knobs) -> dict:
    """`drive` of a loaded artifact under the profiler, counted: its calls,
    runs of one length, replays and captures (the spans), K3's Python counter
    (an eager call and a capture tick it once, a replay not at all), K3's
    device events (once a call) and the captured shapes the artifact's
    graph cache keeps (`graphs.captured()`: at most its bound and the
    captures, each a length driven); `counts_ok` whether they agree,
    `same` whether the drive equals the eager program (`drive_eager`) bit
    for bit."""
    from mod_extraction_tpu_torch.utils import spans

    lk.reset_launch_counts()
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        y, state = drive(art, x, sizes, knobs)
    found = spans.summary()
    spans.clear()
    replays, captures = (found.get(f"processor.{k}", {"count": 0})["count"] for k in ("replay", "capture"))
    python, device_k3 = dict(lk.LAUNCHES), lstm_device_launches(prof)["lstm_forward"]
    kept = art.graphs.captured()
    runs = sum(1 for i, n in enumerate(sizes) if i == 0 or n != sizes[i - 1])
    y_eager, s_eager = drive_eager(art, x, sizes, knobs)
    calls = len(sizes)
    return dict(
        y=y, state=state, calls=calls, runs=runs, replays=replays, device_k3=device_k3,
        counts=f"{calls - replays} eager, {replays} replays, {captures} captures; K3 in Python {python['lstm_forward']}"
               f"; {len(kept)} captured shapes kept",
        counts_ok=(calls - runs <= replays <= calls and captures <= min(runs, replays) and device_k3 == calls
                   and python == dict(lstm_forward=calls - replays + captures, lstm_train_forward=0,
                                      lstm_backward=0)
                   and len(kept) <= min(art.graphs.size, captures)
                   and all(k[0] == art.n_channels and k[1] in sizes for k in kept)),
        same=bool(np.array_equal(y, y_eager)) and all(torch.equal(state[k], s_eager[k]) for k in ("h", "c", "phase")))


def drive(proc, x, sizes, knobs):
    """Buffer by buffer, numpy in and out: (y, final state)."""
    state, outs, i = proc.init_state(), [], 0
    for n in sizes:
        y, state = proc.process_np(state, x[:, i : i + n], **knobs)
        outs.append(y)
        i += n
    return np.concatenate(outs, axis=-1), state


def drive_eager(proc, x, sizes, knobs):
    """As `drive`, through the tensor API `process`: the eager program."""
    from mod_extraction_tpu_torch.export.streaming import knob_tensors

    k = knob_tensors(proc.device, knobs["lfo_rate"], knobs["lfo_depth"], knobs.get("stereo_offset", 0.0))
    state, outs, i = proc.init_state(), [], 0
    with torch.no_grad():
        for n in sizes:
            y, state = proc.process(state, torch.as_tensor(x[:, i : i + n], device=proc.device), *k)
            outs.append(y.cpu().numpy())
            i += n
    return np.concatenate(outs, axis=-1), state


def host_ms_a_call(call, proc, buf, n: int) -> float:
    """Host ms of `call(state, buf, **SERVE_KNOBS)` (numpy in and out), the
    mean over `n` calls after two untimed (the artifact's eager first call
    of a shape and its capture)."""
    _, state = call(proc.init_state(), buf, **SERVE_KNOBS)
    _, state = call(state, buf, **SERVE_KNOBS)
    t0 = time.perf_counter()
    for _ in range(n):
        _, state = call(state, buf, **SERVE_KNOBS)
    return (time.perf_counter() - t0) / n * 1e3


def artifact_first_calls_ms(art, rng) -> dict:
    """Host ms of a fresh artifact's first three calls of each buffer length
    (eager; capture and replay; replay), stereo, one length after another."""
    state, out = art.init_state(), {}
    for t in (64, 128, 512, SERVE_MAX_BUFFER):
        buf = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, state = art.process_np(state, buf, **SERVE_KNOBS)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[t] = tuple(ms)
    return out


def artifact_variable_drive_ms(load, eager_call, rng, seconds: int = 4) -> dict:
    """Host ms a call over `seconds` of stereo audio in random buffers of
    1-SERVE_MAX_BUFFER samples, a host that changes its buffer size every
    call: a freshly loaded (`load()`) artifact's `process_np` against the
    eager program (`eager_call`) over the same buffers, in the order
    process_np, eager, eager, process_np (the second process_np on another
    fresh copy, so that no shape carries over), each copy first driven
    once, untimed, by the eager program; the means of the two turns a side.
    Then the replays and captures of the drive on a third fresh copy,
    counted under the profiler."""
    from mod_extraction_tpu_torch.utils import spans

    sizes = serve_buffers(rng, seconds * SERVE_SAMPLES)
    x = rng.uniform(-0.5, 0.5, (2, sum(sizes))).astype(np.float32)

    def timed(call, proc) -> float:
        state, i = proc.init_state(), 0
        t0 = time.perf_counter()
        for n in sizes:
            _, state = call(proc, state, x[:, i : i + n], **SERVE_KNOBS)
            i += n
        return (time.perf_counter() - t0) * 1e3 / len(sizes)

    def process_np(proc, *a, **k):
        return proc.process_np(*a, **k)

    arts = [load(), load()]
    for art in arts:
        timed(eager_call, art)
    turns = [timed(process_np, arts[0]), timed(eager_call, arts[0]), timed(eager_call, arts[0]),
             timed(process_np, arts[1])]
    out = {"calls": len(sizes), "process_np_ms": (turns[0] + turns[3]) / 2, "eager_ms": (turns[1] + turns[2]) / 2,
           "turns_ms": turns}
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drive(load(), x, sizes, SERVE_KNOBS)
    found = spans.summary()
    out.update({k: found.get(f"processor.{k[:-1]}", {"count": 0})["count"] for k in ("replays", "captures")})
    spans.clear()
    return out


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

    bts = load_script("bench_torch_streaming")
    from mod_extraction_tpu_torch.export.streaming import (
        StreamingEffectModel,
        _process_np,
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
                # the artifact over random buffers (held against the full call, as
                # the live path), then a fresh copy over each length three times
                # in a row (its replays); each against its eager program
                art_sizes = serve_buffers(rng, SERVE_SAMPLES)
                ra = profiled_artifact_drive(lk, load_compiled_processor(target, device="cuda"), x, art_sizes, knobs)
                rt = profiled_artifact_drive(lk, load_compiled_processor(target, device="cuda"), x,
                                             serve_buffers_thrice(rng, SERVE_SAMPLES), knobs)
                y_art, s_art = ra["y"], ra["state"]
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
                      f" / artifact {ra['device_k3']} on the device ({ra['counts']}); phase "
                      f"{s_chunk['phase'].item():.6f}")
                print(f"  artifact, each length thrice ({rt['calls']} buffers): K3 {rt['device_k3']} on the device "
                      f"({rt['counts']}); vs full, not held to it: y {float(np.abs(rt['y'] - y_full).max()):.3e}, "
                      f"share of the cell-state limit {c_errors(rt['state']['c'], s_full['c'])[2]:.3f}; both "
                      f"drives bit for bit their eager program: {ra['same']}, {rt['same']}")
                print(f"  cell state, chunked / artifact vs full: max |dc| {c_chunk[0]:.3e} / {c_art[0]:.3e}, "
                      f"|dc|/|c| there {c_chunk[1]:.3e} / {c_art[1]:.3e}, share of the limit {STREAM_ATOL} + "
                      f"{STREAM_C_RTOL} |c| used {c_chunk[2]:.3f} / {c_art[2]:.3f}; max |c| "
                      f"{s_full['c'].abs().max().item():.3f}")
                if counted != dict(lstm_forward=len(sizes), lstm_train_forward=0, lstm_backward=0):
                    fail(f"serving {what}: launches {counted}, expected K3 once for each of {len(sizes)} buffers")
                for r in (ra, rt):
                    if not r["counts_ok"]:
                        fail(f"serving {what}: artifact over {r['calls']} buffers in {r['runs']} runs of one "
                             f"length: {r['counts']}; expected a replay at each call of a length seen before, at "
                             f"most one capture a run, K3 in Python once an eager call and once a capture, and "
                             f"on the device once a call; captured shapes kept only among those driven")
                    if not r["same"]:
                        fail(f"serving {what}: the artifact's process_np differs from its eager program")
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
                launches[sm.n_hidden] += counted["lstm_forward"] + ra["device_k3"] + rt["device_k3"]

        # -- times: stereo, H 64 (the egfx model), per buffer size
        sm = StreamingEffectModel(str(SERVE_WEIGHTS[0][1]), n_channels=2, device="cuda")
        timed = export_streaming_model(sm.model, tmp, "timed")
        art = load_compiled_processor(timed, device="cuda")
        rows = bts.measure(sm, art, SERVE_BUFFERS, 2.0, rng)
        first_calls = artifact_first_calls_ms(load_compiled_processor(timed, device="cuda"), rng)
        variable = artifact_variable_drive_ms(lambda: load_compiled_processor(timed, device="cuda"), _process_np, rng)
    for t, (eager_ms, capture_ms, replay_ms) in first_calls.items():
        print(f"[serving artifact, stereo H 64, buffer {t}] host ms of a new shape's calls: first (eager) "
              f"{eager_ms:.4f}, second (capture and replay) {capture_ms:.4f}, third (replay) {replay_ms:.4f}")
    print(f"[serving artifact, stereo H 64, random buffers 1-{SERVE_MAX_BUFFER}] host ms a call over "
          f"{variable['calls']} calls ({variable['replays']} replays, {variable['captures']} captures): "
          f"process_np {variable['process_np_ms']:.4f}, eager {variable['eager_ms']:.4f} (turns "
          f"{', '.join(f'{v:.4f}' for v in variable['turns_ms'])})")
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
        buf = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
        n_calls = row["n_buffers"]
        replay_ms = host_ms_a_call(art.process_np, art, buf, n_calls)
        eager_ms = host_ms_a_call(lambda *a, **k: _process_np(art, *a, **k), art, buf, n_calls)
        shape = dict(b=2, t=t, hid=64, ms=row["k3_ms"], profiled_launches=row["k3_profiled_launches"],
                     fenced_ms=row["k3_fenced_ms"], queued_ms=row["k3_queued_ms"], call_ms=row["k3_call_ms"],
                     dispatch_ms=row["k3_dispatch_ms"], plain_ms=plain_ms, max_abs_err=err,
                     bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                     latency_floor_ms=t * cycles / mhz / 1e3, library_ms=library_ms,
                     library_call_ms=library_call_ms, artifact_replay_call_ms=replay_ms,
                     artifact_eager_call_ms=eager_ms)
        shapes.append(shape)
        print(f"[serving artifact, stereo H 64, buffer {t}] host ms a call over {n_calls} calls: replay "
              f"{replay_ms:.4f}, eager {eager_ms:.4f} ({eager_ms / replay_ms:.2f}x)")
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
                max_c_err=worst_c[0], c_rel_err_there=worst_c[1], h160=h160,
                artifact_first_calls_ms=first_calls, artifact_variable_drive=variable)


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
def fit_records(out_dir: str) -> list:
    (path,) = Path(out_dir).glob("*_metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def run_fit(label: str, config: str, counters, expected, bench_line: dict, rows: list) -> dict:
    """`cli.fit` for one epoch, counted and timed, then resumed for a
    second; the same epoch again with copies made on the compute stream must
    give the same losses bit for bit (cuDNN held to deterministic algorithms
    for that pair).  `counters` are the launch-count modules of the path's
    kernels; `expected(task)` the launches an epoch ({counter: n})."""
    import copy

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import (
        WET_FLANGER,
        fit_config,
        write_synthetic_corpus,
        write_wet_corpus,
    )
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_corpus(str(tmp / "corpus"))  # 32 + 8 riffs of 12 s
        wet = None
        if "em_sim" in config:
            wet = tmp / "wet"
            n = write_wet_corpus(tmp / "corpus", wet)
            print(f"[{label}] wet corpus: the dry riffs through K1 on the card ({n} launches, not counted "
                  f"on the path), {WET_FLANGER}")
        print(f"[{label}] corpus written in {time.perf_counter() - t0:.1f} s")
        cfg = fit_config(config, tmp / "corpus", wet, FIT_TRAIN_BATCHES, FIT_VAL_BATCHES)
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


# ---------------------------------------------------------------------------
# the evaluation path: the sim corpora, the eval grid, the archived tables
# ---------------------------------------------------------------------------

# run as a user runs `scripts/run_eval_grid_torch.py out/eval <config> ...`
EVAL_CONFIGS = ("eval_lfo.yml", "eval_lfo_flanger.yml", "eval_em_unseen_effect.yml")
EVAL_CPU_CONFIG = "configs/eval_lfo.yml"  # held card vs CPU at one val batch
# the phase's depth: val batches a variant, at most (the extractor configs;
# the effect-model configs, one 86016-sample K3 walk a batch); every config,
# archive and kernel stays
EVAL_MAX_VAL_BATCHES = {"lfo": 2, "em": 1}


def _val_batches(cfg: dict) -> int:
    args = cfg["data"]["init_args"]
    n, bs = args["val_num_examples_per_epoch"], args["batch_size"]
    if n % bs:
        fail(f"eval: {n} val examples do not fill batches of {bs}")
    return n // bs


def _cut_val(cfg: dict) -> dict:
    """`cfg` with its val examples cut to `EVAL_MAX_VAL_BATCHES` batches."""
    import copy

    cfg = copy.deepcopy(cfg)
    args = cfg["data"]["init_args"]
    kind = "em" if "effect_model" in cfg["model"]["init_args"] else "lfo"
    args["val_num_examples_per_epoch"] = min(args["val_num_examples_per_epoch"],
                                             EVAL_MAX_VAL_BATCHES[kind] * args["batch_size"])
    return cfg


def check_sim_render(fxk, sim) -> float:
    """The written val wet of sim_chorus against the same dry rendered by
    K1's plain version on the card: the generator's numpy stream replayed
    (its train draws, then the val dry windows and LFOs), the delays formed
    as `ops/fx.py::apply_flanger_chorus` forms them.  PCM16 quantizes the
    file by up to one step (3.1e-5); returns the max |diff|."""
    from mod_extraction_tpu_torch.data.wav import wav_read
    from mod_extraction_tpu_torch.ops.fx import ms_to_samples

    effect = "sim_chorus"
    mdw, width, mix, _ = sim.CHORUS_REGIMES[effect]
    rng = np.random.default_rng(sim.EFFECT_SEEDS[effect])
    sim._load_dry(rng, "data/idmt_4/train", 48)
    sim._quasi_tri(rng, 48, 1.6, 1.9)
    dry = sim._load_dry(rng, "data/idmt_4/val", 8)
    mod = torch.from_numpy(sim._quasi_tri(rng, 8, 1.6, 1.9)).cuda()[:, None, :]
    mmd, mld = ms_to_samples(30.0, SR), ms_to_samples(10.0, SR)

    def col(v):
        return torch.full((8, 1, 1), v, dtype=torch.float32, device="cuda")

    delay = mld * col(width) * mod + col(mdw) * mmd
    plain = fxk.flanger_plain(torch.from_numpy(dry).cuda(), delay, col(0.3), col(1.0), col(mix), mmd + mld)
    written = np.stack([wav_read(f"data/{effect}/val/wet/pair_{i:02d}.wav")[0] for i in range(8)])
    err = float(np.abs(written - plain.cpu().numpy()).max())
    print(f"[eval] {effect} val wet as written (PCM16) against K1's plain version on the card: "
          f"max |diff| {err:.3e} (limit {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        fail(f"eval: the written {effect} wet is {err} from the plain render")
    return err


EVAL_CPU_THREADS = 4  # the CPU side of the pair shares the host with the phase


def eval_pair_config(dtype: str) -> dict:
    """EVAL_CPU_CONFIG at its `custom.cpu_*` batch and examples (one val
    batch), its extractor's convs in `dtype`."""
    from mod_extraction_tpu_torch import cli

    cfg = cli.load_yaml_with_includes(EVAL_CPU_CONFIG)
    custom = cfg["custom"]
    cfg["data"]["init_args"].update(batch_size=custom["cpu_batch_size"],
                                    val_num_examples_per_epoch=custom["cpu_val_num_examples_per_epoch"])
    cfg["model"]["init_args"]["model"]["init_args"]["compute_dtype"] = dtype
    return cfg


def eval_pair_cpu() -> dict:
    """The CPU side of the eval phase's card-vs-CPU pair, from the phase's
    working directory: {conv dtype: metrics}, float32 first, then the
    config's own dtype."""
    from mod_extraction_tpu_torch import cli

    torch.set_num_threads(EVAL_CPU_THREADS)
    shipped = cli.load_yaml_with_includes(EVAL_CPU_CONFIG)["model"]["init_args"]["model"]["init_args"]
    return {dtype: cli.validate_many([("cpu", eval_pair_config(dtype))], device="cpu")[0][1]
            for dtype in ("float32", shipped["compute_dtype"])}


def run_eval(fxk, lk, rows: list) -> dict:
    """The evaluation path as a user runs it from the repo root, in a
    temporary working directory holding `configs` and `models` (linked) and
    a `data/` filled here: the riff corpus (`data/synthetic.py`), the sim
    corpora of `scripts/make_sim_effect_data_torch.py` (every effect, K1 and
    K2) and `scripts/make_sim_chorus_gt_control_torch.py` (three regimes,
    K1) and the five unseen-audio domains, then
    `scripts/run_eval_grid_torch.py` on `eval_lfo.yml` (K2),
    `eval_lfo_flanger.yml` (K1) and `eval_em_unseen_effect.yml` (the
    imported checkpoints' forward, K3), `--unseen-audio` (3 effects x 5
    domains x {fixed, varying}: K1, K2) and `--em-sim` (every effect's
    LSTM-64 and rand tables, the ground-truth controls, the H 160 capacity
    bracket on the cluster forward and the seed-2 chorus3 pair: K3).  Each
    config's wall time and examples a second are printed; every archive
    must be written with no FAILED block (and no SKIPPED one: every corpus
    and checkpoint is there), the launches must be those of the work done,
    and one eval config holds its card metrics against the CPU's in float32
    (the shipped bf16 convs' difference is printed beside it)."""
    import os

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus

    grid = load_script("run_eval_grid_torch")
    sim = load_script("make_sim_effect_data_torch")
    gt = load_script("make_sim_chorus_gt_control_torch")
    t_phase = time.perf_counter()
    counters = (fxk, lk)
    cwd = os.getcwd()
    launches = {"flanger": 0, "phaser": 0, "lstm_forward": 0, "lstm_forward_h160": 0}
    timings = {}

    def reset():
        for c in counters:
            c.reset_launch_counts()

    def read():
        torch.cuda.synchronize()
        got = {k: v for c in counters for k, v in c.LAUNCHES.items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got

    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        stack.callback(os.chdir, cwd)
        os.chdir(tmp)
        for name in ("configs", "models"):
            os.symlink(ROOT / name, name)
        t0 = time.perf_counter()
        write_synthetic_corpus("data/idmt_4")
        for domain in grid.UNSEEN_DOMAINS:  # `make_synthetic_corpus.py data/unseen_<d> 0 10 12 --style <d>`
            write_synthetic_corpus(f"data/unseen_{domain}", n_train=0, n_val=10, dur_s=12.0, style=domain)
        print(f"[eval] data/idmt_4 and data/unseen_{{{','.join(grid.UNSEEN_DOMAINS)}}} written in "
              f"{time.perf_counter() - t0:.1f} s")
        # the CPU side of the card-vs-CPU pair, in a process of its own beside the phase
        code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                "print(json.dumps(chip_smoke.eval_pair_cpu()))")
        cpu_pair = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        stack.callback(lambda: cpu_pair.poll() is None and (cpu_pair.kill(), cpu_pair.wait()))

        # -- the sim corpora, on the card
        t0 = time.perf_counter()
        reset()
        sim.main([])
        got = read()
        n_fl = 2 * sum(1 for e in sim.ALL_EFFECTS if e != "sim_phaser")
        if got != {"flanger": n_fl, "phaser": 2}:
            fail(f"eval: make_sim_effect_data_torch launched {got}, expected K1 {n_fl} and K2 2")
        print(f"[eval] make_sim_effect_data_torch (all {len(sim.ALL_EFFECTS)} effects, 48 + 8 pairs of 2.5 s "
              f"each) in {time.perf_counter() - t0:.1f} s; launches {got}")
        t0 = time.perf_counter()
        reset()
        for regime in gt.REGIMES:
            gt.main(["--regime", regime])
        got = read()
        n_gt = len(gt.REGIMES) * (-(-256 // 32) + -(-96 // 32))
        if got != {"flanger": n_gt}:
            fail(f"eval: make_sim_chorus_gt_control_torch launched {got}, expected K1 {n_gt}")
        print(f"[eval] make_sim_chorus_gt_control_torch ({len(gt.REGIMES)} regimes, 256 + 96 triplets "
              f"each) in {time.perf_counter() - t0:.1f} s; launches {got}")
        sim_err = check_sim_render(fxk, sim)

        # -- the grid, through the script's entry point
        examples = [0]
        metrics = []

        def counted_validate_many(variants):
            """`cli.validate_many` on the card, its K3 launches at H 160 set
            apart and its val batches counted against the launches; each
            variant cut to `EVAL_MAX_VAL_BATCHES`."""
            variants = [(label, _cut_val(c)) for label, c in variants]
            before = dict(lk.LAUNCHES), dict(fxk.LAUNCHES)
            out = cli.validate_many(variants, device="cuda")
            torch.cuda.synchronize()
            cfg = variants[0][1]
            args = cfg["model"]["init_args"]
            em = args.get("effect_model")
            n = sum(_val_batches(c) for _, c in variants)
            examples[0] += sum(c["data"]["init_args"]["val_num_examples_per_epoch"] for _, c in variants)
            if em is not None:
                k3 = lk.LAUNCHES["lstm_forward"] - before[0]["lstm_forward"]
                if k3 != n:
                    fail(f"eval: {[lb for lb, _ in variants]} launched K3 {k3} times over {n} val batches")
                if em["init_args"]["n_hidden"] == 160:
                    launches["lstm_forward_h160"] += k3
            else:
                effects = cfg["data"]["class_path"].rsplit(".", 1)[-1]
                key = "phaser" if "Phaser" in effects else "flanger"
                k = fxk.LAUNCHES[key] - before[1][key]
                if k != n:
                    fail(f"eval: {[lb for lb, _ in variants]} launched {key} {k} times over {n} val batches")
            for label, m in out:
                if not m or not all(math.isfinite(v) for v in m.values()):
                    fail(f"eval: {label!r} metrics {m}")
                metrics.append((label, m))
            return out

        reset()
        runs = [(name, ["out/eval", name]) for name in EVAL_CONFIGS] + \
            [(flag, [flag, "out/eval"]) for flag in ("--unseen-audio", "--em-sim")]
        for label, argv in runs:
            t0 = time.perf_counter()
            examples[0] = 0
            (path,) = grid.main(argv, validate_many=counted_validate_many)
            dt = time.perf_counter() - t0
            text = Path(path).read_text()
            if "FAILED" in text or "SKIPPED" in text:
                fail(f"eval: {path} holds a FAILED or SKIPPED block:\n{text[:4000]}")
            timings[label] = dict(s=dt, examples=examples[0], examples_per_s=examples[0] / dt if examples[0] else None)
            print(f"[eval] run_eval_grid_torch {label} -> {path}: {dt:.1f} s, {examples[0]} val examples, "
                  f"{examples[0] / dt:.1f} examples/s" if examples[0] else
                  f"[eval] run_eval_grid_torch {label} -> {path}: {dt:.1f} s (the EGFx/Melda stub)")
        got = read()
        stub = Path("out/eval/eval_em_unseen_effect.txt").read_text()
        if stub.count("forward OK") != 7:
            fail(f"eval: the unseen-effect stub served {stub.count('forward OK')} of 7 forwards")
        em_sim = Path("out/eval/eval_em_sim.txt").read_text()
        n_tables = em_sim.count("┏")
        want_tables = 2 * (len(grid.EM_SIM_EFFECTS) + len(grid.GT_CONTROL_REGIMES) + len(grid.H160_PAIRS) + 1)
        if n_tables != want_tables:
            fail(f"eval: eval_em_sim.txt holds {n_tables} tables, expected {want_tables}")
        print(f"[eval] grid launches {got} (K3 at H 160: {launches['lstm_forward_h160']}); "
              f"eval_em_sim.txt {n_tables} tables")

        # -- one eval config on the card against the CPU, one val batch: in
        # float32 (the model config's setting for parity runs), held; with
        # the shipped bf16 convs, printed (bf16 operands rounded by other
        # kernels on each side).  The CPU side ran beside the phase.
        t0 = time.perf_counter()
        stdout, stderr = cpu_pair.communicate(timeout=900)
        if cpu_pair.returncode != 0:
            fail(f"eval: {EVAL_CPU_CONFIG} on the CPU: rc {cpu_pair.returncode}: {stderr[-2000:]}")
        cpu_metrics = json.loads(stdout.strip().splitlines()[-1])
        print(f"[eval] the CPU side of the pair: waited {time.perf_counter() - t0:.1f} s")
        for dtype, on_cpu in cpu_metrics.items():
            t0 = time.perf_counter()
            cfg = eval_pair_config(dtype)
            on_card = cli.validate_many([("card", cfg)], device="cuda")[0][1]
            rel = max(abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-12) for k in on_cpu)
            print(f"[eval] {EVAL_CPU_CONFIG} ({dtype} convs) at one val batch of {cfg['data']['init_args']['batch_size']}: "
                  f"card {on_card}, cpu {on_cpu}, worst rel diff {rel:.3e}"
                  + (f" (limit {VAL_RTOL})" if dtype == "float32" else "") + f", {time.perf_counter() - t0:.1f} s")
            if set(on_card) != set(on_cpu):
                fail(f"eval: {EVAL_CPU_CONFIG} metrics {sorted(on_card)} on the card, {sorted(on_cpu)} on the CPU")
            if dtype == "float32":
                worst = rel
                if not worst <= VAL_RTOL:
                    fail(f"eval: {EVAL_CPU_CONFIG} on the card {on_card} against the CPU {on_cpu}")

    h160 = launches.pop("lstm_forward_h160")
    for row in rows:
        key = ROW_COUNTER.get(row["name"])
        if row["name"] == "lstm_effect_model_h160":
            row["launches"] += h160
            row["eval_launches"] = h160
        elif row["name"] == "lstm_effect_model":
            row["launches"] += launches["lstm_forward"] - h160
            row["eval_launches"] = launches["lstm_forward"] - h160
        elif key in launches:
            row["launches"] += launches[key]
            row["eval_launches"] = launches[key]
    total = time.perf_counter() - t_phase
    print(f"[eval total] {total:.1f} s")
    return dict(s=total, configs=timings, launches=dict(launches, lstm_forward_h160=h160),
                sim_wet_err=sim_err, card_vs_cpu_rel=worst)


# ---------------------------------------------------------------------------
# reference: the reference's `.pt` checkpoints through models/torch_port.py,
# scripts/import_reference_weights_torch.py and the CLI's `.pt` weights
# ---------------------------------------------------------------------------

# shipped weights rewritten in the reference's layout: the egfx phaser
# LSTM-64 (trained by the reference, imported) and the extractor of
# configs/eval_em_unseen_effect.yml; stage 2 takes the r7 extractor
REF_LSTM = ROOT / "models" / "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz"
REF_CNN = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__ph_fl_ch_all_2__idmt_4.npz"
REF_EVAL_CONFIG = "configs/eval_lfo.yml"
REF_CNN_TOL = 5e-5  # the imported extractor against the reference module (tests/test_spectral2dcnn_port.py)
REF_FEATURES_BATCH = 4
REF_FORWARD_T = 4096  # the imported LSTM-64 at (2, 1, T) against the reference module, KERNEL_TOL
REF_STREAM_SAMPLES, REF_STREAM_BUFFER = 44100, (37, 516)  # stereo, random buffer lengths in this range


def reference_frontend(n_mels: int = PAPER["n_mels"]) -> torch.nn.Module:
    """The buffers of the reference's torchaudio `MelSpectrogram` (44.1 kHz,
    n_fft 1024) under their names, `spectrogram.window` and `mel_scale.fb`."""
    from mod_extraction_tpu_torch.ops.stft import hann_window, mel_filterbank

    fe = torch.nn.Module()
    fe.spectrogram, fe.mel_scale = torch.nn.Module(), torch.nn.Module()
    fe.spectrogram.register_buffer("window", torch.from_numpy(hann_window(PAPER["n_fft"])))
    fe.mel_scale.register_buffer("fb", torch.from_numpy(mel_filterbank(int(SR), PAPER["n_fft"], n_mels)))
    return fe


class ReferenceCNN(torch.nn.Module):
    """The reference's Spectral2DCNN (`mod_extraction/models.py:128-215`),
    at the paper's size by default, on Mel features: [LayerNorm over (bins,
    frames), no affine -> dilated "same" Conv2d -> MaxPool2d((2, 1)) ->
    PReLU] a layer, in an `nn.Sequential` `cnn`; mean over bins; 1x1
    Conv1d `output`; sigmoid.  `spectrogram` holds its Mel frontend's
    buffers."""

    def __init__(self, in_ch=PAPER["in_ch"], n_mels=PAPER["n_mels"], n_frames=N_FRAMES,
                 chans=PAPER["out_channels"], dils=PAPER["temp_dilations"], kernel=PAPER["kernel_size"]):
        super().__init__()
        self.spectrogram = reference_frontend(n_mels)
        layers, bins, prev = [], n_mels, in_ch
        for ch, d in zip(chans, dils):
            layers += [torch.nn.LayerNorm([bins, n_frames], elementwise_affine=False),
                       torch.nn.Conv2d(prev, ch, kernel, dilation=(1, d), padding="same"),
                       torch.nn.MaxPool2d((2, 1)), torch.nn.PReLU(ch)]
            bins //= 2
            prev = ch
        self.cnn = torch.nn.Sequential(*layers)
        self.output = torch.nn.Conv1d(prev, 1, 1)

    def forward(self, spec):
        h = self.cnn(torch.log(torch.clamp(spec, min=1e-7)))
        return torch.sigmoid(self.output(h.mean(dim=-2)))


class ReferenceLSTM(torch.nn.Module):
    """The reference's LSTM effect model: `nn.LSTM` on cat(latent, x),
    `nn.Linear`, + x, tanh (LSTM-64 by default)."""

    def __init__(self, in_dim: int = 2, n_hidden: int = 64):
        super().__init__()
        self.lstm = torch.nn.LSTM(in_dim, n_hidden, batch_first=True)
        self.fc = torch.nn.Linear(n_hidden, 1)

    def forward(self, x, latent):
        out, _ = self.lstm(torch.cat([latent, x], 1).transpose(1, 2))
        return torch.tanh(self.fc(out).transpose(1, 2) + x)


def reference_layout(npz: Path) -> dict:
    """A shipped `.npz` rewritten in the reference's state_dict layout, the
    inverse of `models/torch_port.py` (kept here, not in the package): an
    LSTM's fused gate bias split as b/2 + b/2 (which sums back exactly); a
    Spectral2DCNN's convs at `cnn.{4k+1}`, PReLUs at `cnn.{4k+3}`, the head
    as a 1x1 Conv1d `output`, and the Mel frontend's buffers as extra keys."""
    with np.load(npz) as f:
        w = {k: f[k] for k in f.files}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if "w_hh" in w:
        half = w["b_gates"] / np.float32(2)
        return {"lstm.weight_ih_l0": t(w["w_ih"].T), "lstm.weight_hh_l0": t(w["w_hh"].T),
                "lstm.bias_ih_l0": t(half), "lstm.bias_hh_l0": t(half),
                "fc.weight": t(w["fc/kernel"].T), "fc.bias": t(w["fc/bias"])}
    sd = {}
    for k in range(sum(1 for key in w if key.startswith("Conv_") and key.endswith("/kernel"))):
        sd[f"cnn.{4 * k + 1}.weight"] = t(np.transpose(w[f"Conv_{k}/kernel"], (3, 2, 0, 1)))
        sd[f"cnn.{4 * k + 1}.bias"] = t(w[f"Conv_{k}/bias"])
        sd[f"cnn.{4 * k + 3}.weight"] = t(w[f"PReLU_{k}/alpha"])
    sd["output.weight"] = t(w["Dense_0/kernel"].T[:, :, None])
    sd["output.bias"] = t(w["Dense_0/bias"])
    sd.update({f"spectrogram.{k}": v for k, v in reference_frontend().state_dict().items()})
    return sd


@contextlib.contextmanager
def recorded(fxk, name: str, calls: list, outs: list):
    """While open, `fx_kernels.<name>` also records each call's arguments
    and output, moved to the CPU (for callers that look the kernel up on
    the module at each call, as `ops/fx.py` does)."""
    kernel = getattr(fxk, name)

    def wrapper(*args, **kw):
        y = kernel(*args, **kw)
        calls.append(tuple(a.cpu() if torch.is_tensor(a) else a for a in args))
        outs.append(y.cpu())
        return y

    setattr(fxk, name, wrapper)
    try:
        yield
    finally:
        setattr(fxk, name, kernel)


def run_reference(fxk, lk, rows: list) -> dict:
    """Reading the reference's `.pt` checkpoints, at the paper's widths:
    (1) the shipped egfx phaser LSTM-64, the extractor of
    configs/eval_em_unseen_effect.yml and the r7 extractor rewritten as
    reference-layout `.pt` files, each loaded strictly into a
    reference-architecture module; (2) `scripts/import_reference_weights_torch.py`
    back to the shipped `.npz` files, array for array; (3) the imported
    extractor (float32 convs) against the reference module on the same Mel
    features, within 5e-5; (4) `eval_lfo.yml` with its `ckpt_path` the
    `.pt`, beside the same run from the `.npz`, two val batches each: the
    tables bit for bit (K2); (5) configs/train_em_sim_flanger_r7.yml's task
    with `lfo_model_weights_path` the r7 `.pt`: its extractor bit for bit
    the `.npz` task's, and one `train_step` at batch 32 the same loss and
    parameters (K1 renders the wet; K3, K4, K5); (6) the imported LSTM-64
    at (2, 1, 4096) against the reference module within 1e-4, and streamed
    stereo over random buffers of 37-516 samples within 1e-5 of one call
    (K3).  Every kernel launched here is held against its plain version on
    the same inputs: K1 and K2 on the CPU in processes beside the phase, K3,
    K4 and K5 on the card."""
    import copy

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch, write_synthetic_corpus
    from mod_extraction_tpu_torch.evaluation.tables import format_validate_table
    from mod_extraction_tpu_torch.export.streaming import StreamingEffectModel
    from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict
    from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel, lstm_init_state
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
    from mod_extraction_tpu_torch.models.torch_port import REFERENCE, load_pt, reference_state_dict
    from mod_extraction_tpu_torch.ops.stft import mel_spectrogram
    from mod_extraction_tpu_torch.utils.device import resolve_device

    importer = load_script("import_reference_weights_torch")
    resolve_device("cuda")  # float32 convs and matmuls without TF32
    t_phase = time.perf_counter()
    out = {"launches": {}}
    k2_procs, k1_proc = [], None

    def count(what: str, want: dict) -> None:
        torch.cuda.synchronize()
        got = {k: v for k, v in outside_k7(launch_counts()).items() if v}
        if got != want:
            fail(f"reference {what}: launched {got}, expected {want}")
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp_, contextlib.ExitStack() as stack:
        tmp = Path(tmp_)
        stack.callback(lambda: [(p.kill(), p.wait()) for p, _ in filter(None, k2_procs + [k1_proc])
                                if p.poll() is None])

        # -- (1) the reference-layout files, each loaded strictly into its module
        t0 = time.perf_counter()
        pts = {}
        for npz in (REF_LSTM, REF_CNN, R7):
            sd = reference_layout(npz)
            (ReferenceLSTM() if npz == REF_LSTM else ReferenceCNN()).load_state_dict(sd, strict=True)
            pts[npz] = tmp / f"{npz.stem}.pt"
            torch.save(sd, pts[npz])
        # -- (2) imported back, array for array the shipped files
        for npz, pt in pts.items():
            got = tmp / f"{npz.stem}.imported.npz"
            importer.main([str(pt), str(got)] + ([] if npz == REF_LSTM else ["2dcnn"]))
            with np.load(got) as a, np.load(npz) as b:
                if sorted(a.files) != sorted(b.files) or not all(
                        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b.files):
                    fail(f"reference: {pt.name} imports to other arrays than {npz.name}")
        out["files_s"] = time.perf_counter() - t0
        print(f"[reference (1, 2)] {', '.join(p.name for p in pts.values())}: written in the reference layout, "
              f"each loaded with strict=True into ReferenceLSTM / ReferenceCNN, and imported by "
              f"import_reference_weights_torch.py back to the shipped .npz array for array; {out['files_s']:.1f} s")

        # -- (3) the imported extractor on the card against the reference module
        t0 = time.perf_counter()
        kind, sd = load_pt(str(pts[REF_CNN]))
        if kind != REFERENCE:
            fail(f"reference: {pts[REF_CNN].name} read as a {kind}")
        model = Spectral2DCNN(**PAPER, compute_dtype="float32").to("cuda").eval()
        model.load_state_dict(reference_state_dict(sd, model))
        ref = ReferenceCNN().to("cuda").eval()
        ref.load_state_dict(sd)
        dry = batch_to_torch(make_synthetic_batch(7000, 2 * REF_FEATURES_BATCH, N_SAMPLES, SR, "flanger"),
                             "cuda")["dry"]
        x = torch.cat([dry[:REF_FEATURES_BATCH], dry[REF_FEATURES_BATCH:]], 1)
        with torch.no_grad():
            spec = mel_spectrogram(x, int(SR), PAPER["n_fft"], PAPER["hop_len"], PAPER["n_mels"])
            got, _ = model(x, features=spec)
            want = ref(spec)
        cnn_err = max_abs(got, want)
        out["extractor"] = dict(max_abs_err=cnn_err, s=time.perf_counter() - t0)
        print(f"[reference (3)] the imported {REF_CNN.stem} on the card, float32 convs, at "
              f"{tuple(spec.shape)} Mel features: max_abs_err {cnn_err:.3e} against ReferenceCNN "
              f"(limit {REF_CNN_TOL})")
        if not cnn_err <= REF_CNN_TOL:
            fail(f"reference: the imported extractor is {cnn_err} from the reference module")

        # -- (4) eval_lfo.yml from the .pt beside the .npz, two val batches each (K2)
        t0 = time.perf_counter()
        corpus = tmp / "idmt_4"
        write_synthetic_corpus(str(corpus), n_train=1, n_val=8)
        base = cli.load_yaml_with_includes(str(ROOT / REF_EVAL_CONFIG))
        base["data"]["init_args"].update(train_dir=str(corpus / "train"), val_dir=str(corpus / "val"))
        variants = [(label, _cut_val(dict(copy.deepcopy(base), ckpt_path=str(path))))
                    for label, path in (("pt", pts[REF_CNN]), ("npz", REF_CNN))]
        k2_calls, k2_outs = [], []
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        reset_launch_counts()
        try:
            with recorded(fxk, "phaser", k2_calls, k2_outs):
                evals = cli.validate_many(variants, device="cuda")
        finally:
            torch.backends.cudnn.deterministic = prev
        n_val = 2 * _val_batches(variants[0][1])
        count("eval pair", {"phaser": n_val})
        tables = [format_validate_table({f"val/{k}": v for k, v in m.items()}) for _, m in evals]
        same = evals[0][1] == evals[1][1] and tables[0] == tables[1]
        half = n_val // 2
        same_k2 = all(torch.equal(a, b) for a, b in zip(k2_outs[:half], k2_outs[half:]))
        for i, call in enumerate(k2_calls[:half]):  # a process a call: each is a 88200-step loop
            (tmp / f"k2_{i}").mkdir()
            k2_procs.append(start_plain_on_cpu("phaser_plain", [call], tmp / f"k2_{i}"))
        out["eval"] = dict(metrics=evals[0][1], tables_equal=same, s=time.perf_counter() - t0)
        print(f"[reference (4)] {REF_EVAL_CONFIG} with ckpt_path {pts[REF_CNN].name} and with {REF_CNN.name}, "
              f"{_val_batches(variants[0][1])} val batches of {variants[0][1]['data']['init_args']['batch_size']} "
              f"each: tables equal {same}, K2's outputs equal {same_k2}; {evals[0][1]}; "
              f"{out['eval']['s']:.1f} s\n{tables[0]}")
        if not (same and same_k2):
            fail(f"reference: eval from the .pt {evals[0][1]} against the .npz {evals[1][1]}")

        # -- (5) stage 2 from the r7 .pt beside the .npz (K1 renders the wet; K3, K4, K5)
        t0 = time.perf_counter()
        cfg = cli.load_yaml_with_includes(str(ROOT / FIT_TBPTT_CONFIG))
        tasks = {}
        for label, path in (("pt", pts[R7]), ("npz", R7)):
            c = copy.deepcopy(cfg)
            c["model"]["init_args"]["lfo_model_weights_path"] = str(path)
            tasks[label] = cli.RunConfig(c, "cuda").task
        ext = [t.lfo_model.state_dict() for t in tasks.values()]
        same_ext = ext[0].keys() == ext[1].keys() and all(torch.equal(ext[0][k], ext[1][k]) for k in ext[0])
        reset_launch_counts()
        batch = _variant_batch("reference", 7100, BATCH, N_SAMPLES, "cuda")
        count("stage 2 batch", {"flanger": 1})
        # K1 again on the arguments the render gave it (every row a flanger): the path's wet, bit for bit
        k1_call = k1_args(batch, stage2_render_cfg().max_delay_samples)
        k1_outs = [fxk.flanger(*k1_call).cpu()]
        if not torch.equal(k1_outs[0], batch["wet"].cpu()):
            fail("reference: K1 on the render's arguments does not give the batch's wet")
        k1_proc = start_plain_on_cpu("flanger_plain", [k1_call], tmp)
        n_up = tasks["pt"].updates_per_batch
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        reset_launch_counts()
        losses, device = {}, []
        try:
            for label, t in tasks.items():  # a profile a task: one graph capture in each
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    losses[label] = t.train_step(batch)["loss"].item()
                device.append(lstm_device_launches(prof))
        finally:
            torch.backends.cudnn.deterministic = prev
        if any(d != {"lstm_forward": 1, "lstm_train_forward": n_up, "lstm_backward": n_up} for d in device):
            fail(f"reference stage 2 train_steps: device events {device}, expected {n_up} updates each")
        # each task's first update is eager and its second captured: the Python counters tick at those
        count("stage 2 train_steps", {"lstm_forward": 2, **{k: 2 * v for k, v in tbptt_python_launches(
            tasks["pt"], 1).items()}})
        params = [t.trained_model.state_dict() for t in tasks.values()]
        same_params = all(torch.equal(v, params[1][k]) for k, v in params[0].items())
        err3, err4, err5, _ = lstm_plain_errors(lk, *path_lstm_args(lk, tasks["pt"], batch)[:3])
        out["stage2"] = dict(extractor_equal=same_ext, losses=losses, params_equal=same_params, k3=err3, k4=err4,
                             k5=err5, s=time.perf_counter() - t0)
        print(f"[reference (5)] {FIT_TBPTT_CONFIG} with lfo_model_weights_path {pts[R7].name} and {R7.name}: "
              f"extractor state_dict bit for bit {same_ext}; one train_step at batch {BATCH} ({n_up} updates): "
              f"losses {losses}, parameters bit for bit {same_params}; on the path's arguments K3 "
              f"max_abs={err3:.3e} K4 max_abs={err4:.3e} (limit {KERNEL_TOL}), K5 max_rel={err5:.3e} (limit "
              f"{GRAD_REL}); {out['stage2']['s']:.1f} s")
        if not (same_ext and same_params and losses["pt"] == losses["npz"] and math.isfinite(losses["pt"])):
            fail("reference: stage 2 from the .pt differs from the .npz path")
        if not (err3 <= KERNEL_TOL and err4 <= KERNEL_TOL and err5 <= GRAD_REL):
            fail(f"reference: K3/K4/K5 on stage 2's path against plain: {err3}, {err4}, {err5}")

        # -- (6) the imported LSTM-64: its forward against the reference module, then streamed (K3)
        t0 = time.perf_counter()
        kind, sd = load_pt(str(pts[REF_LSTM]))
        em = LSTMEffectModel(n_hidden=64)
        em.load_state_dict(reference_state_dict(sd, em))
        shipped = flax_lstm_to_state_dict(str(REF_LSTM))
        same_w = kind == REFERENCE and all(torch.equal(v, shipped[k]) for k, v in em.state_dict().items())
        em = em.to("cuda").eval()
        ref = ReferenceLSTM().to("cuda").eval()
        ref.load_state_dict(sd)
        rng = np.random.default_rng(7200)
        xs = torch.as_tensor((0.2 * rng.standard_normal((2, 1, REF_FORWARD_T))).astype(np.float32), device="cuda")
        lat = torch.as_tensor(rng.uniform(0, 1, (2, 1, REF_FORWARD_T)).astype(np.float32), device="cuda")
        reset_launch_counts()
        with torch.no_grad():
            y, _ = em(xs, lat, lstm_init_state(2, 64, "cuda"))
        count("LSTM forward", {"lstm_forward": 1})
        with torch.no_grad():
            fwd_err = max_abs(y, ref(xs, lat))
        w = [p.detach() for p in (em.w_ih, em.w_hh, em.b_gates, em.fc_kernel, em.fc_bias)]
        k3_args = (torch.cat([lat, xs], 1), xs, *lstm_init_state(2, 64, "cuda"), *w)
        k3_err = max(max_abs(a, b) for a, b in zip(lk.lstm_forward(*k3_args), lk.lstm_forward_plain(*k3_args)))
        sm = StreamingEffectModel(em, n_channels=2, device="cuda")
        audio = rng.uniform(-0.4, 0.4, (2, REF_STREAM_SAMPLES)).astype(np.float32)
        sizes = []
        while sum(sizes) < REF_STREAM_SAMPLES:
            sizes.append(min(int(rng.integers(REF_STREAM_BUFFER[0], REF_STREAM_BUFFER[1] + 1)),
                             REF_STREAM_SAMPLES - sum(sizes)))
        reset_launch_counts()
        y_full, _ = sm.process_np(sm.init_state(), audio)
        y_chunked, _ = drive(sm, audio, sizes, {})
        count("streaming", {"lstm_forward": 1 + len(sizes)})
        stream_err = float(np.abs(y_chunked - y_full).max())
        out["serving"] = dict(weights_equal=same_w, forward_err=fwd_err, k3_err=k3_err, buffers=len(sizes),
                              stream_err=stream_err, s=time.perf_counter() - t0)
        print(f"[reference (6)] {pts[REF_LSTM].name} imported (the shipped weights bit for bit: {same_w}); "
              f"forward at (2, 1, {REF_FORWARD_T}) max_abs_err {fwd_err:.3e} against ReferenceLSTM (limit "
              f"{KERNEL_TOL}); K3 on those arguments {k3_err:.3e} from plain; streamed stereo over "
              f"{len(sizes)} buffers of {REF_STREAM_BUFFER[0]}-{REF_STREAM_BUFFER[1]}: max_abs {stream_err:.3e} "
              f"from one call (limit {STREAM_ATOL}); {out['serving']['s']:.1f} s")
        if not (same_w and fwd_err <= KERNEL_TOL and k3_err <= KERNEL_TOL and stream_err <= STREAM_ATOL):
            fail(f"reference: the imported LSTM-64: weights {same_w}, forward {fwd_err}, K3 {k3_err}, "
                 f"stream {stream_err}")

        # -- K1 and K2 against their plain versions on the same inputs (CPU processes)
        t0 = time.perf_counter()
        out["k2_err"] = max(plain_errors(*proc, [o], "reference K2 (eval_lfo.yml)")[0]
                            for proc, o in zip(k2_procs, k2_outs[:half]))
        out["k1_err"] = plain_errors(*k1_proc, k1_outs, "reference K1 (stage 2 batch)")[0]
        print(f"[reference plain] K1 at {tuple(k1_outs[0].shape)} max_abs_err {out['k1_err']:.3e}, K2 at "
              f"{[tuple(o.shape) for o in k2_outs[:half]]} max_abs_err {out['k2_err']:.3e} (limit {KERNEL_TOL}; "
              f"flanger_plain / phaser_plain on the CPU); waited {time.perf_counter() - t0:.1f} s")

    errs = {"flanger": out["k1_err"], "phaser": out["k2_err"], "lstm_forward": max(err3, k3_err),
            "lstm_train_forward": err4, "lstm_backward": err5}
    for row in rows:
        key = ROW_COUNTER.get(row["name"])
        if key in out["launches"] and not row["name"].endswith("_h160"):
            row["launches"] += out["launches"][key]
            row["reference_launches"] = out["launches"][key]
            row["reference_err"] = errs[key]
    out["s"] = time.perf_counter() - t_phase
    print(f"[reference total] {out['s']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# the data-parallel path (parallel/dist.py): cli.fit under a one-rank NCCL
# group, the steps on two ranks of one card, and the resampler
# ---------------------------------------------------------------------------

# tests/test_multidevice.py's tolerances for the sharded step against the
# one-device step: (loss atol, parameter atol, parameter rtol)
DDP_TOL = {"stage 1": (1e-5, 2e-5, 1e-4), "H 64": (5e-5, 5e-5, 5e-4), "H 160": (5e-5, 5e-5, 5e-4)}
# the stage-1 ranks' all-reduced gradients against the full-batch gradient:
# each leaf's max |d| over its max |g|.  Sound runs read 6.8e-3 (bf16 convs)
# and 1.2e-3 (float32): cuDNN sums B 16 in another order than B 32.  One
# rank's own half-batch gradient, which a missing all-reduce would leave,
# must read above the bound, or the check fails as blind.
DDP_GRAD_BOUND = 2e-2
DDP_RANKS = 2
DDP_SUB_BATCH = 8  # the sub-batched stage-1 step: 4 sub-batches of 32, 4 rows of each a rank
N_DDP_TIMED = 3  # steps timed in each turn, after one warm-up step
DDP_TIMEOUT = 600.0  # seconds a spawned run may take before its ranks are killed
RESAMPLE_PAIRS = ((44100, 48000), (48000, 44100))
RESAMPLE_TOL = 1e-6  # max-abs, the card against its CPU run


def ddp_task(name: str):
    """(task on the card, its global batch as numpy) of one of the steps the
    two-rank check holds, from fixed seeds: "stage 1" (the r7 extractor at
    paper width, bf16 convs, an interwoven batch of 32), "stage 1
    sub-batched" (the same with `sub_batch_size` DDP_SUB_BATCH), "stage 1
    sub-batched f32" (that in float32 convs), "H 64"
    (the task of configs/train_em_sim_flanger_r7.yml) and "H 160" (that of
    configs/train_em_sim_chorus_h160.yml)."""
    from mod_extraction_tpu_torch.data.synthetic import (
        CHORUS_DELAYS_MS,
        flanger_max_delay_samples,
        make_interwoven_batch,
        make_synthetic_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import RenderConfig

    if name.startswith("stage 1"):
        cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3),
                           max_delay_samples=flanger_max_delay_samples(*CHORUS_DELAYS_MS, SR))
        dtype = "float32" if name.endswith("f32") else "bfloat16"
        model = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype=dtype)
        sub = DDP_SUB_BATCH if "sub-batched" in name else None
        task = LFOExtractionTask(model, cfg, loss_dict=LOSSES, sub_batch_size=sub, device="cuda", seed=0)
        return task, make_interwoven_batch(3000, BATCH, N_SAMPLES, SR)
    if name == "H 64":
        extractor = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")
        return stage2_task("cuda", extractor), make_synthetic_batch(3001, BATCH, N_SAMPLES, SR, "flanger")
    extractor = load_spectral_2dcnn(str(R6), device="cuda", **PAPER, compute_dtype="bfloat16")
    return h160_task("cuda", extractor), make_synthetic_batch(3002, BATCH, N_SAMPLES, SR, "chorus")


def _ddp_rank_steps(names: tuple) -> dict:
    """One rank of the two-rank check: each step on this rank's rows of its
    global batch (of a sub-batched task, its shares of the sub-batches),
    counted, its global metrics and parameters returned; then one more step
    of the same batch, timed."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch
    from mod_extraction_tpu_torch.ops import lstm_kernels as lk
    from mod_extraction_tpu_torch.parallel.dist import shard_batch, to_numpy, world

    rank, size, _ = world()
    out = {}
    for name in names:
        task, batch = ddp_task(name)
        local = batch_to_torch(shard_batch(batch, rank, size, getattr(task, "sub_batch_size", None)), task.device)
        rows = local["dry"].shape[0] if "dry" in local else local["mod_sig"].shape[0]
        reset_launch_counts()
        metrics = task.train_step(local)
        torch.cuda.synchronize()
        launches = launch_counts()
        params = to_numpy(task.trained_model.state_dict())
        grads = {k: p.grad.detach().float().cpu().numpy() for k, p in task.trained_model.named_parameters()
                 if p.grad is not None}
        t0 = time.perf_counter()
        task.train_step(local)
        torch.cuda.synchronize()
        hid = getattr(getattr(task, "effect_model", None), "n_hidden", None)
        out[name] = dict(metrics={k: float(v) for k, v in metrics.items()}, params=params, grads=grads,
                         launches=launches,
                         rows=rows, second_step_ms=(time.perf_counter() - t0) * 1e3,
                         plans=None if hid is None else (lk.forward_kernel(hid, rows), lk.backward_kernel(hid, rows)))
    return out


def _ddp_timed_steps(tasks: dict, profile_tbptt: bool) -> dict:
    """Host-clock ms of N_DDP_TIMED fenced train steps of each task after one
    warm-up; with `profile_tbptt`, one H 64 step profiled: its wall, the
    card's busy time, the NCCL kernels' device time and the host time in the
    `dist.all_reduce` ranges, with their count."""
    from mod_extraction_tpu_torch.utils.timing import device_busy

    out = {}
    for name, (task, batch) in tasks.items():
        task.train_step(batch)
        torch.cuda.synchronize()
        ms = []
        for _ in range(N_DDP_TIMED):
            t0 = time.perf_counter()
            task.train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = ms
    if profile_tbptt:
        from torch.profiler import ProfilerActivity, profile

        task, batch = tasks["H 64"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            task.train_step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, events = device_busy(prof)
        ranges = [e for e in prof.key_averages() if e.key == "dist.all_reduce"
                  and e.device_type == torch.autograd.DeviceType.CPU]
        out["H 64 profile"] = dict(
            wall_ms=wall, busy_ms=busy,
            nccl_device_ms=sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3,
            all_reduce_host_ms=sum(e.cpu_time_total for e in ranges) / 1e3,
            all_reduces=sum(e.count for e in ranges))
        # the step's gradient all-reduces alone, unprofiled: 83 of the LSTM's
        # gradients and the 2 scalar ones, host clock to a fenced end
        from mod_extraction_tpu_torch.parallel.dist import all_reduce_grads, all_reduce_mean

        params = [p for p in task.effect_model.parameters() if p.grad is not None]
        one = torch.ones((), device=task.device)

        def reduces():
            for _ in range(task.updates_per_batch):
                all_reduce_grads(params)
            all_reduce_mean(one)
            all_reduce_mean(one)

        ms = []
        for _ in range(N_DDP_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduces()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["H 64 profile"]["step_all_reduces_ms"] = ms[1:]
    return out


def _ddp_world1(fit_cfgs: dict, out_root: str) -> dict:
    """The one rank of a real NCCL group: each shipped config's `cli.fit`
    under the group, then the same fits with no group in the same process
    (cuDNN deterministic for both), and the stage-1 and H 64 steps at batch
    32 timed in turns: group, no group, group, no group."""
    import copy
    import os

    import torch.distributed as dist

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch
    from mod_extraction_tpu_torch.parallel.dist import init_distributed, to_numpy

    torch.backends.cudnn.deterministic = True

    def fits(tag):
        res = {}
        for label, cfg in fit_cfgs.items():
            reset_launch_counts()
            out = os.path.join(out_root, f"{label.replace(' ', '_')}_{tag}")
            task = cli.fit(copy.deepcopy(cfg), out_dir=out, device="cuda", max_epochs=1)
            torch.cuda.synchronize()
            recs = fit_records(out)
            res[label] = dict(
                losses=[r["loss"] for r in recs if r["phase"] == "train_step"]
                + [r["val/loss"] for r in recs if r["phase"] == "epoch"],
                params=to_numpy(task.trained_model.state_dict()), launches=launch_counts())
        return res

    env = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE")}

    def leave():
        dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)

    def join(i):
        os.environ.update(env)
        init_distributed("cuda", init_method=f"file://{os.path.join(out_root, f'rendezvous{i}')}")

    group = fits("group")
    timing_tasks = {}
    for name in ("stage 1", "H 64"):
        task, batch = ddp_task(name)
        timing_tasks[name] = (task, batch_to_torch(batch, task.device))
    times = [("group", _ddp_timed_steps(timing_tasks, True))]
    leave()
    none = fits("none")
    times.append(("none", _ddp_timed_steps(timing_tasks, False)))
    join(1)
    times.append(("group", _ddp_timed_steps(timing_tasks, True)))
    leave()
    times.append(("none", _ddp_timed_steps(timing_tasks, False)))
    join(2)
    return dict(group=group, none=none, times=times)


def _params_close(got: dict, want: dict, atol: float, rtol: float) -> tuple:
    """(ok, worst |got - want|, worst excess over atol + rtol |want|)."""
    worst, excess = 0.0, -math.inf
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(w, np.float64))
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d - atol - rtol * np.abs(w)).max()))
    return excess <= 0.0, worst, excess


def add_ddp_launches(rows: list, launches: dict, tag: str, h160: bool = False) -> None:
    """Adds a run's launches to the kernels' rows (the LSTM launches of an
    H 160 run to the `_h160` rows), under `ddp_launches[tag]` too."""
    for row in rows:
        key = ROW_COUNTER.get(row["name"].removesuffix("_h160"))
        if not launches.get(key) or (key.startswith("lstm") and row["name"].endswith("_h160") != h160):
            continue
        row["launches"] += launches[key]
        ddp = row.setdefault("ddp_launches", {})
        ddp[tag] = ddp.get(tag, 0) + launches[key]


def ddp_world1(rows: list, summary: dict) -> None:
    """(a): `cli.fit` of the r7 extractor config (batch 99) and the r7
    flanger TBPTT config (batch 32) in one rank of a real NCCL group against
    the same fits with no group in that process: losses and final weights
    bit for bit, the launches those of the fit phases; then the stage-1 and
    H 64 steps at batch 32 timed with and without the group."""

    from mod_extraction_tpu_torch.data.synthetic import fit_config, write_synthetic_corpus, write_wet_corpus
    from mod_extraction_tpu_torch.parallel.dist import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_synthetic_corpus(str(tmp / "corpus"))
        write_wet_corpus(tmp / "corpus", tmp / "wet")
        n = (FIT_TRAIN_BATCHES, FIT_VAL_BATCHES)
        fit_cfgs = {"fit stage 1": fit_config(FIT_LFO_CONFIG, tmp / "corpus", None, *n),
                    "fit stage 2": fit_config(FIT_TBPTT_CONFIG, tmp / "corpus", tmp / "wet", *n)}
        t0 = time.perf_counter()
        (w1,) = run_ranks(_ddp_world1, 1, args=(fit_cfgs, str(tmp / "out")), device="cuda",
                          timeout=DDP_TIMEOUT)
        print(f"[ddp (a)] one NCCL rank and no group in one process: {time.perf_counter() - t0:.1f} s")
    n_batches = FIT_TRAIN_BATCHES + FIT_VAL_BATCHES
    eager = FIT_TRAIN_BATCHES * 83  # under a process group the chunk updates run the eager loop
    want_launches = {("fit stage 1", tag): dict(flanger=n_batches, phaser=n_batches,
                                                conv_wgrad=K6_A_BACKWARD * FIT_TRAIN_BATCHES)
                     for tag in ("group", "none")}
    want_launches.update({("fit stage 2", tag): dict(lstm_forward=n_batches, lstm_train_forward=n, lstm_backward=n)
                          for tag, n in (("group", eager), ("none", 2))})
    for label in fit_cfgs:
        g, n = w1["group"][label], w1["none"][label]
        diff = [k for k in n["params"] if not np.array_equal(g["params"][k], n["params"][k])]
        print(f"[ddp (a) {label}] losses with the NCCL group {g['losses']}, without {n['losses']}; "
              f"launches {g['launches']}")
        if g["losses"] != n["losses"] or diff:
            worst = max((float(np.abs(g["params"][k] - n["params"][k]).max()) for k in diff), default=0.0)
            fail(f"ddp (a) {label}: world 1 under NCCL differs from no group: losses {g['losses']} vs "
                 f"{n['losses']}, {len(diff)} parameter tensors differ (max |d| {worst:.3e}): {diff[:5]}")
        for tag, got in (("group", g["launches"]), ("none", n["launches"])):
            if {k: v for k, v in outside_k7(got).items() if v} != want_launches[label, tag]:
                fail(f"ddp (a) {label} ({tag}): launches {got}, expected {want_launches[label, tag]}")
        add_ddp_launches(rows, g["launches"], f"(a) {label}")
    print(f"[ddp (a)] world 1 under NCCL == no group, losses and final weights bit for bit, for "
          f"{FIT_LFO_CONFIG} and {FIT_TBPTT_CONFIG}")
    turns = w1["times"]
    for name in ("stage 1", "H 64"):
        per = [(tag, float(np.median(t[name]))) for tag, t in turns]
        print(f"[ddp (a) {name} step at batch {BATCH}, ms (median of {N_DDP_TIMED}) in turns] "
              + ", ".join(f"{tag} {ms:.3f}" for tag, ms in per)
              + f"; readings {[(tag, [round(x, 3) for x in t[name]]) for tag, t in turns]}")
        g_ms = float(np.mean([ms for tag, ms in per if tag == "group"]))
        n_ms = float(np.mean([ms for tag, ms in per if tag == "none"]))
        summary[f"{name} step ms"] = dict(group=g_ms, none=n_ms, overhead=g_ms / n_ms - 1.0)
    profs = [t["H 64 profile"] for tag, t in turns if "H 64 profile" in t]
    for p in profs:
        print(f"[ddp (a) H 64 step profiled under the group] wall {p['wall_ms']:.3f} ms, busy "
              f"{p['busy_ms']:.3f} ms; {p['all_reduces']} all-reduces: host {p['all_reduce_host_ms']:.3f} ms "
              f"({p['all_reduce_host_ms'] / p['wall_ms']:.4f} of the wall), NCCL kernels "
              f"{p['nccl_device_ms']:.3f} ms ({p['nccl_device_ms'] / p['busy_ms']:.4f} of the busy time); "
              f"the step's 85 all-reduces alone, unprofiled: {[round(x, 3) for x in p['step_all_reduces_ms']]} ms")
    summary["H 64 all-reduce"] = profs


def _diffs(got: dict, ref: dict, tol: tuple) -> dict:
    """A rank's step against a one-process step: loss |d|, the parameters'
    largest |d|, their excess over the tolerance and the elements past it,
    and the gradients' largest |d| over their leaf's largest |g|."""
    loss_tol, atol, rtol = tol
    ok, worst, excess = _params_close(got["params"], ref["params"], atol, rtol)
    return dict(
        loss=abs(got["metrics"]["loss"] - ref["metrics"]["loss"]), params=worst, params_ok=ok, excess=excess,
        outside=sum(int((np.abs(got["params"][k] - w) > atol + rtol * np.abs(w)).sum())
                    for k, w in ref["params"].items()),
        grads=max(float(np.abs(got["grads"][k] - g).max() / max(np.abs(g).max(), 1e-30))
                  for k, g in ref["grads"].items()),
        bits=all(np.array_equal(got["params"][k], w) for k, w in ref["params"].items()))


def _one_process_step(name: str, sub_batches: int = 1, first_rows_only: bool = False,
                      shares: bool = False) -> dict:
    """The one-process step of `name` on its whole batch (with
    `sub_batches`, the stage-1 task's `sub_batch_size` over the same halves
    the ranks take, with the same SpecAugment draws in each; with
    `first_rows_only`, on rank 0's rows alone, as that rank computes its
    gradient before the all-reduce: of a sub-batched task, its shares, each
    a sub-batch of its own; with `shares`, of a sub-batched task, each
    rank's gradient so, then their mean, as the all-reduce takes it, and
    one update), counted."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch
    from mod_extraction_tpu_torch.parallel.dist import shard_batch

    task, batch = ddp_task(name)
    if hasattr(task, "static_chunks"):  # the eager chunk loop, as under the ranks' group: their launches compare
        task.static_chunks = False
    sub = getattr(task, "sub_batch_size", None)
    if first_rows_only:
        batch = shard_batch(batch, 0, DDP_RANKS, sub)
        if sub is not None:
            task.sub_batch_size = sub // DDP_RANKS
    kw = {}
    if sub_batches > 1:
        task.sub_batch_size = BATCH // sub_batches
        kw["mask_draws"] = torch.rand(4, generator=torch.Generator().manual_seed(0)).expand(sub_batches, 4)
    reset_launch_counts()
    if shares:
        task.sub_batch_size = sub // DDP_RANKS
        draws = torch.rand(BATCH // sub, 4, generator=torch.Generator().manual_seed(0))  # the task's own
        task.model.train()
        params, per_rank, metrics = list(task.model.parameters()), [], []
        for r in range(DDP_RANKS):
            task.optimizer.zero_grad(set_to_none=True)
            local = batch_to_torch(shard_batch(batch, r, DDP_RANKS, sub), task.device)
            metrics.append(task._backward_subbatched(local, None, draws))
            per_rank.append([p.grad for p in params])
        for p, g0, g1 in zip(params, *per_rank):
            p.grad = (g0 + g1) / DDP_RANKS
        task._update()
        metrics = {k: (metrics[0][k] + metrics[1][k]) / DDP_RANKS for k in metrics[0]}
    else:
        metrics = task.train_step(batch_to_torch(batch, task.device), **kw)
    torch.cuda.synchronize()
    return dict(metrics={k: float(v) for k, v in metrics.items()}, launches=launch_counts(),
                params={k: v.detach().float().cpu().numpy() for k, v in task.trained_model.state_dict().items()},
                grads={k: p.grad.detach().float().cpu().numpy() for k, p in task.trained_model.named_parameters()
                       if p.grad is not None})


# what (b) holds of a step against each one-process reference, besides its
# loss: the parameters within the step's tolerance ("params", the default),
# the gradients within DDP_GRAD_BOUND ("grads"), the parameters bit for bit
# ("bits"), or nothing more ("loss")
DDP_HOLDS = {
    ("stage 1", "full batch"): "grads", ("stage 1", "two halves"): "bits",
    ("stage 1 sub-batched", "same shares"): "bits", ("stage 1 sub-batched", "sub-batched step"): "loss",
    ("stage 1 sub-batched f32", "sub-batched step"): "grads",
}


def ddp_two_ranks(rows: list, summary: dict) -> None:
    """(b): two ranks on the card (gloo over CUDA tensors: NCCL refuses two
    ranks on one device), each on 16 rows of a batch of 32, each rank's
    launches those of a whole step.  The H 64 and H 160 TBPTT steps are held
    against the one-process step on the full batch within the JAX oracle's
    tolerances.  The stage-1 step is held three ways: its all-reduced
    gradients against the full-batch gradient within `DDP_GRAD_BOUND` (and
    rank 0's own half-batch gradient, the control, outside it), its loss
    against the full-batch step's, and its parameters bit for bit against
    the one-process step over the same two halves (`sub_batch_size` 16: the
    mean of the two halves' gradients, one AdamW update).  Its parameters
    against the full-batch step are printed beside them, not held: cuDNN
    sums B 16 in another order than B 32, and AdamW's first update,
    lr * g / (|g| + eps), turns a gradient whose sign those sums flip into
    a 2 lr difference.

    The sub-batched stage-1 step (`sub_batch_size` DDP_SUB_BATCH, each rank
    its share of every sub-batch; K1 and K2 one launch a share a rank) is
    held the same way: its parameters and gradients bit for bit against the
    one-process step over the same shares (each rank's gradient computed so,
    their mean, one update), its loss against the one-process sub-batched
    step's.  Its gradients against that step are held in float32 convs
    ("stage 1 sub-batched f32"), and printed in bf16: cuDNN's bf16 convs at
    B 4 a share round otherwise than at B 8 a sub-batch, so even the
    forward differs there."""
    from mod_extraction_tpu_torch.parallel.dist import run_ranks, sub_batch_shares

    names = ("stage 1", "stage 1 sub-batched", "stage 1 sub-batched f32", "H 64", "H 160")
    t0 = time.perf_counter()
    ranks = run_ranks(_ddp_rank_steps, DDP_RANKS, args=(names,), device="cuda", backend="gloo",
                      local_ranks=[0] * DDP_RANKS, timeout=DDP_TIMEOUT)
    print(f"[ddp (b)] {DDP_RANKS} ranks on one card (gloo): {time.perf_counter() - t0:.1f} s")
    problems = []
    for name in names:
        tol = DDP_TOL[name.split(" sub-batched")[0]]
        sub_batched = "sub-batched" in name
        full = _one_process_step(name)
        refs = {"sub-batched step" if sub_batched else "full batch": full}
        if name == "stage 1":
            refs["two halves"] = _one_process_step(name, DDP_RANKS)
        if name == "stage 1 sub-batched":
            refs["same shares"] = _one_process_step(name, shares=True)
        if name.startswith("stage 1"):
            control = _diffs(_one_process_step(name, first_rows_only=True), full, tol)["grads"]
            print(f"[ddp (b) {name} control] rank 0's own rows' gradient (no all-reduce) vs the one-process "
                  f"gradient: max over leaves of max |d| / max |g| {control:.3e} (bound {DDP_GRAD_BOUND})")
            if not control > DDP_GRAD_BOUND:
                problems.append(f"ddp (b) {name}: the control reads {control}, within the gradient bound "
                                f"{DDP_GRAD_BOUND}: the bound cannot see a missing all-reduce")
            summary[f"(b) {name} gradients"] = dict(bound=DDP_GRAD_BOUND, control=control, ranks=[])
        for r, res in enumerate(ranks):
            got = res[name]
            for label, ref in refs.items():
                d = _diffs(got, ref, tol)
                grad_bits = all(np.array_equal(got["grads"][k], g) for k, g in ref["grads"].items())
                print(f"[ddp (b) {name} rank {r}, {got['rows']} rows, vs one process on the {label}] loss "
                      f"{got['metrics']['loss']:.7f} vs {ref['metrics']['loss']:.7f} (|d| {d['loss']:.3e}, "
                      f"tolerance {tol[0]}); parameters max |d| {d['params']:.3e} (atol {tol[1]}, rtol {tol[2]}: "
                      f"{d['outside']} of {sum(w.size for w in ref['params'].values())} outside; bit for bit "
                      f"{d['bits']}); gradients max |d| / max |g| {d['grads']:.3e} (bit for bit {grad_bits})")
                hold = DDP_HOLDS.get((name, label), "params")
                if name.startswith("stage 1") and label != "two halves" and label != "same shares":
                    summary[f"(b) {name} gradients"]["ranks"].append(d["grads"])
                held = dict(params=d["params_ok"], grads=d["grads"] <= DDP_GRAD_BOUND, loss=True,
                            bits=d["bits"] and grad_bits)[hold]
                if d["loss"] > tol[0] or not held:
                    problems.append(f"ddp (b) {name} rank {r} vs {label}: loss |d| {d['loss']}, parameters "
                                    f"excess {d['excess']}, bit for bit {d['bits']}, gradients {d['grads']} "
                                    f"(held: {hold})")
            print(f"[ddp (b) {name} rank {r}] launches {got['launches']}; LSTM plans {got['plans']}; a second "
                  f"step {got['second_step_ms']:.3f} ms (two ranks sharing the card: a correctness run, not a "
                  f"speed figure)")
            if got["rows"] != BATCH // DDP_RANKS or outside_k7(got["launches"]) != outside_k7(full["launches"]):
                problems.append(f"ddp (b) {name} rank {r}: {got['rows']} rows, launches {got['launches']}; the "
                                f"one-process step launched {full['launches']}")
            if sub_batched:
                shares = sub_batch_shares(BATCH, DDP_SUB_BATCH, r, DDP_RANKS)
                held_shares = sum(hi > lo for lo, hi in shares)
                print(f"[ddp (b) {name} rank {r}] shares (global rows) {shares}: K1 {got['launches']['flanger']}, "
                      f"K2 {got['launches']['phaser']} launches, one a share held ({held_shares})")
                if not got["launches"]["flanger"] == got["launches"]["phaser"] == held_shares:
                    problems.append(f"ddp (b) {name} rank {r}: K1 / K2 launched {got['launches']}, expected "
                                    f"{held_shares} each, one a share")
                # K6 takes the bf16 trunk's weight gradients, a backward a share
                k6 = 0 if name.endswith("f32") else K6_A_BACKWARD * held_shares
                if got["launches"]["conv_wgrad"] != k6:
                    problems.append(f"ddp (b) {name} rank {r}: K6 launched {got['launches']['conv_wgrad']}, "
                                    f"expected {k6}, {K6_A_BACKWARD} a share of a bf16 trunk")
            if not all(math.isfinite(v) for v in got["metrics"].values()):
                problems.append(f"ddp (b) {name} rank {r}: non-finite metrics {got['metrics']}")
            add_ddp_launches(rows, got["launches"], f"(b) {name}", h160=name == "H 160")
        summary[f"(b) {name}"] = dict(loss=full["metrics"]["loss"],
                                      second_step_ms=[res[name]["second_step_ms"] for res in ranks])
    for p in problems:
        print(f"FAIL: {p}")
    if problems:
        fail(f"ddp (b): {len(problems)} check(s) failed")


def ddp_resample(summary: dict) -> None:
    """(c): the resampler on the card against its CPU run, 44100 -> 48000
    and back, on a synthetic riff of two seconds."""
    from mod_extraction_tpu_torch.ops.resample import resample

    rng = np.random.default_rng(12)
    t = np.arange(int(SR) * 2) / SR
    riff = np.zeros(t.size, np.float32)
    for start, f in zip(rng.uniform(0, 1.8, 8), rng.uniform(80, 700, 8)):
        riff += (0.3 * np.exp(-(t - start) * 5.0) * np.sin(2 * np.pi * f * t) * (t >= start)).astype(np.float32)
    for orig, new in RESAMPLE_PAIRS:
        x = riff if orig == int(SR) else resample(riff, int(SR), orig, device="cpu").numpy()
        card = resample(x, orig, new, device="cuda").cpu()
        cpu = resample(x, orig, new, device="cpu")
        err = max_abs(card, cpu)
        print(f"[ddp (c) resample {orig} -> {new}] {x.shape[-1]} -> {card.shape[-1]} samples, card vs CPU "
              f"max_abs={err:.3e} (tolerance {RESAMPLE_TOL})")
        if card.shape != cpu.shape or card.shape[-1] != math.ceil(x.shape[-1] * new / orig) or not err <= RESAMPLE_TOL:
            fail(f"resample {orig} -> {new}: shape {tuple(card.shape)}, card vs CPU {err}")
        summary[f"resample {orig}->{new} max_abs"] = err


def run_ddp(rows: list) -> dict:
    """The data-parallel phase on the one card: (a) `ddp_world1`, (b)
    `ddp_two_ranks`, (c) `ddp_resample`."""
    t_phase = time.perf_counter()
    summary = {}
    ddp_world1(rows, summary)
    ddp_two_ranks(rows, summary)
    ddp_resample(summary)
    summary["s"] = time.perf_counter() - t_phase
    print(f"[ddp total] {summary['s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# variants: the TCN extractor's stage 1 and the TBPTT variants (param model
# latent, unfrozen extractor, stretch smoothing, train_steps): K1-K5 on new
# paths, K3/K4/K5 at in_dim 4
# ---------------------------------------------------------------------------

SPECTRAL_TCN_CONFIG = "configs/models/spectral_tcn.yml"
N_VARIANT_TCN_STEPS = 3
N_VARIANT_TBPTT_STEPS = 2
# the card-vs-CPU comparisons: batch 2 of 0.5 s clips (the CPU's plain LSTM
# walks a sample at a time: a 2 s TBPTT step takes it about a minute),
# run in spawned CPU processes beside the card's runs of the same size
VARIANT_CPU_BATCH = 2
VARIANT_CPU_SAMPLES = N_SAMPLES // 4
VARIANT_CPU_THREADS = 2
VARIANT_LOSS_TOL = (1e-6, 1e-4)  # atol, rtol: the TBPTT training loss (ROADMAP.md)
# the trained extractor's part ("lfo." keys) card vs CPU: a max-pool window
# whose two largest values lie within the two devices' float32 rounding
# sends its cotangent elsewhere (the eq-mask backward), so its first update's
# gradients read 1.7e-4 to 1.2e-3 of each tensor's max|g| over five batches
# (H100 80GB HBM3, 700 W), and AdamW's first steps move a weight by about
# +-lr whatever |g|, so a flipped sign of a near-zero gradient reads 2 lr in
# it: its gradients are held as the two-rank stage-1 step's
# (DDP_GRAD_BOUND), its weights printed
EXTRACTOR_PART = "lfo."
# the stretch's own 4-frame smoothing takes 3 more of the r7 extractor's 345
# frames: int(335 / 345 * 88200) = 85643 samples, 82 chunks after the warm-up
STRETCH_UPDATES = 82


def variant_config(name: str, n_samples: int = N_SAMPLES, cpu_check: bool = False) -> dict:
    """A shipped config with one `variants` item's change, composed in
    memory: "tcn" (configs/train_lfo_interwoven_all_live_r7.yml with
    configs/models/spectral_tcn.yml as its model), and on
    configs/train_em_sim_flanger_r7.yml "param" (a SpectralDSTCN at the JAX
    defaults, the LSTM-64's latent_dim 3), "unfrozen" (`freeze_lfo_model:
    false`) and "stretch" (`stretch_smooth_n_frames: 4`).  `cpu_check`: the
    card-vs-CPU form: the extractor's convs in float32, the param-model and
    stretch items on the ground-truth LFO (the subject there is the latent
    and the stretch, not the extractor, whose corners could flip between
    the two devices' roundings), and the unfrozen item keeping every
    example (the r7 extractor's LFO of a 0.5 s clip fails the validity
    rules, which would leave no gradient to compare)."""
    from mod_extraction_tpu_torch import cli

    if name == "tcn":
        cfg = cli.load_yaml_with_includes(str(ROOT / FIT_LFO_CONFIG))
        cfg["model"]["init_args"]["model"] = cli.load_yaml_with_includes(str(ROOT / SPECTRAL_TCN_CONFIG))
        cfg["data"]["init_args"]["shared_args"]["n_samples"] = n_samples
        return cfg
    cfg = cli.load_yaml_with_includes(str(ROOT / FIT_TBPTT_CONFIG))
    cfg["data"]["init_args"]["n_samples"] = n_samples
    args = cfg["model"]["init_args"]
    if name == "param":
        args["param_model"] = {"class_path": "SpectralDSTCN", "init_args": {}}
        args["effect_model"]["init_args"]["latent_dim"] = 3
    elif name == "unfrozen":
        args["freeze_lfo_model"] = False
    elif name == "stretch":
        args["stretch_smooth_n_frames"] = 4
    else:
        raise KeyError(name)
    if cpu_check:
        args["lfo_model"]["init_args"]["compute_dtype"] = "float32"
        if name in ("param", "stretch"):
            del args["lfo_model"], args["lfo_model_weights_path"]
        else:
            args["discard_invalid_lfos"] = False
    return cfg


def _variant_batch(name: str, seed: int, batch: int, n_samples: int, device: str) -> dict:
    """A batch of `name`'s item on `device`: interwoven rows for the
    extractor; for the TBPTT items the dry/wet pairs their config's data
    module yields, the wet rendered here through K1 (the flanger at stage
    2's delay line, as the fit phase writes its corpus), the ground-truth
    LFO kept."""
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_interwoven_batch, make_synthetic_batch
    from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch

    if name == "tcn":
        return batch_to_torch(make_interwoven_batch(seed, batch, n_samples, SR), device)
    b = batch_to_torch(make_synthetic_batch(seed, batch, n_samples, SR, "flanger"), device)
    with torch.no_grad():
        b["wet"] = render_batch(b, RenderConfig(sr=SR, n_samples=n_samples, effects=(2,), max_delay_samples=485))[1]
    return b


def variant_reference(name: str, device: str) -> dict:
    """One `val_step` and one `train_step` of a `variants` item at the
    card-vs-CPU size, on `device`: metrics, the first update's gradients and
    the trained parameters after the step (numpy)."""
    from mod_extraction_tpu_torch import cli

    if device == "cpu":
        torch.set_num_threads(VARIANT_CPU_THREADS)
    task = cli.RunConfig(variant_config(name, VARIANT_CPU_SAMPLES, cpu_check=True), device).task
    batch = _variant_batch(name, 4000, VARIANT_CPU_BATCH, VARIANT_CPU_SAMPLES, device)
    val = {k: v.item() for k, v in task.val_step(batch).items()}
    grads = {}

    def first_update(opt, args, kwargs):  # the optimizer's own hook: a replayed update calls no task method
        if not grads:
            grads.update({k: p.grad.detach().float().cpu().numpy()
                          for k, p in task.trained_model.named_parameters()})

    task.optimizer.register_step_pre_hook(first_update)
    train = {k: v.item() for k, v in task.train_step(batch).items()}
    params = {k: v.detach().float().cpu().numpy() for k, v in task.trained_model.state_dict().items()}
    return dict(val=val, train=train, grads=grads, params=params)


def check_variant_against_cpu(name: str, card: dict, cpu: dict, metric_tol: tuple) -> dict:
    """The card's `variant_reference` against the CPU's: the val and train
    losses (and a TBPTT step's valid fraction) within `metric_tol` (atol,
    rtol), the first update's gradients within 5e-4 of each tensor's largest
    |g|, the parameters after the step within PARAM_ATOL; a trained
    extractor's part as `EXTRACTOR_PART` says.  Returns the worst of each.
    (The zero-weight metrics esr and dc are printed only: a clip whose wet
    is near silence divides by its energy plus 1e-8.)"""
    atol, rtol = metric_tol
    worst_m = 0.0
    for what in ("val", "train"):
        for k in ("loss", "valid_fraction"):
            if k not in cpu[what]:
                continue
            a, b = card[what][k], cpu[what][k]
            worst_m = max(worst_m, abs(a - b) / (atol + rtol * abs(b)))
            if not abs(a - b) <= atol + rtol * abs(b):
                fail(f"variants {name}: {what} {k} card {a} vs CPU {b} (atol {atol}, rtol {rtol})")

    def grad_rel(k, g):
        return float(np.abs(card["grads"][k] - g).max()) / max(float(np.abs(g).max()), 1e-30)

    def param_abs(k, v):
        return float(np.abs(card["params"][k] - v).max())

    ext = {k for k in cpu["grads"] if k.startswith(EXTRACTOR_PART)}
    g_err = max(grad_rel(k, g) for k, g in cpu["grads"].items() if k not in ext)
    p_err = max(param_abs(k, v) for k, v in cpu["params"].items() if k not in ext)
    g_ext = max((grad_rel(k, cpu["grads"][k]) for k in ext), default=0.0)
    p_ext = max((param_abs(k, cpu["params"][k]) for k in ext), default=0.0)
    shown = " ".join(f"{what}/{k}={card[what][k]:.8g}/{cpu[what][k]:.8g}"
                     for what in ("val", "train") for k in sorted(cpu[what]))
    print(f"[variants {name} card vs CPU, b={VARIANT_CPU_BATCH}, {VARIANT_CPU_SAMPLES} samples] {shown} "
          f"(worst loss |d| / tolerance {worst_m:.3f}); first update's gradients max_rel={g_err:.3e} "
          f"(tolerance {GRAD_REL}); parameters after the step max_abs={p_err:.3e} (tolerance {PARAM_ATOL})"
          + (f"; the extractor's gradients max_rel={g_ext:.3e} (tolerance {DDP_GRAD_BOUND}), its parameters "
             f"max_abs={p_ext:.3e} (printed)" if ext else ""))
    if not g_err <= GRAD_REL:
        fail(f"variants {name}: the first update's gradients, card vs CPU: {g_err}")
    if not p_err <= PARAM_ATOL:
        fail(f"variants {name}: parameters after a train step, card vs CPU: {p_err}")
    if not g_ext <= DDP_GRAD_BOUND:
        fail(f"variants {name}: the extractor's first-update gradients, card vs CPU: {g_ext}")
    return dict(metric_over_tol=worst_m, grad_rel=g_err, param_abs=p_err, extractor_grad_rel=g_ext,
                extractor_param_abs=p_ext)


def _variant_steps(name: str, task, val_batch, train_batches, per_step: dict, val_want: dict) -> dict:
    """A `val_step` and the train steps of one item on the card, the val
    step's launches held to `val_want` and each train step's to `per_step`;
    returns the launches, the mean step ms after the first, and the last
    metrics.  A task whose chunk updates replay a CUDA graph has each train
    step profiled: K3-K5 are held by their device events, and K4's and K5's
    Python counters to its first update and its capture (step 0 alone)."""
    from torch.profiler import ProfilerActivity, profile

    graphs = getattr(task, "static_chunks", False)
    total = dict.fromkeys(per_step, 0)
    reset_launch_counts()
    val = {k: v.item() for k, v in task.val_step(val_batch).items()}
    got = launch_counts()
    if any(got[k] != v for k, v in val_want.items()):
        fail(f"variants {name}: val_step launched {got}, expected {val_want}")
    total = {k: total[k] + got[k] for k in total}
    step_s, metrics, valid = [], None, []
    for i, tb in enumerate(train_batches):
        reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if graphs else \
                contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            metrics = {k: v.item() for k, v in task.train_step(tb).items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        got = launch_counts()
        if graphs:
            first = 2 if i == 0 else 0
            python = dict(got, lstm_train_forward=first, lstm_backward=first)
            if any(got[k] != python[k] for k in per_step):
                fail(f"variants {name}: train_step {i} launched {got} from Python, expected {python}")
            got = dict(got, **lstm_device_launches(prof))
        if any(got[k] != v for k, v in per_step.items()):
            fail(f"variants {name}: train_step {i} launched {got}, expected {per_step}")
        total = {k: total[k] + got[k] for k in total}
        if i > 0:
            step_s.append(dt)
        valid.append(metrics.get("valid_fraction"))
        print(f"[variants {name} train_step {i}] loss={metrics['loss']:.6f} valid_fraction={valid[-1]} "
              f"wall={dt * 1e3:.2f} ms")
    if not all(math.isfinite(v) for v in (*val.values(), *metrics.values())):
        fail(f"variants {name}: non-finite metrics: val {val}, train {metrics}")
    if not all(torch.isfinite(p).all().item() for p in task.trained_model.parameters()):
        fail(f"variants {name}: non-finite parameters after the train steps")
    ms = float(np.mean(step_s)) * 1e3
    print(f"[variants {name}] val loss={val['loss']:.6f} valid_fraction={val.get('valid_fraction', 1.0)} "
          f"mean_step_ms={ms:.3f} (steps after the first{', profiled' if graphs else ''}) launches={total}"
          + (" (K3-K5: device events)" if graphs else ""))
    return dict(launches=total, step_ms=ms, val=val, train=metrics, valid_fractions=valid)


def lstm_plain_errors(lk, k3_args, k4_args, k5_args) -> tuple:
    """K3 and K4 (max-abs) and K5 (max-abs over each output's largest
    magnitude) against their plain versions on a path's arguments, and K5's
    (kernel, plain) outputs."""
    err3 = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(*k3_args), lk.lstm_forward_plain(*k3_args)))
    err4 = max(max_abs(x, y) for x, y in zip(lk.lstm_train_forward(*k4_args),
                                              lk.lstm_forward_plain(*k4_args, save_states=True)))
    got5, want5 = lk.lstm_backward(*k5_args), lk.lstm_backward_plain(*k5_args)
    return err3, err4, max(rel_err(x, y) for x, y in zip(got5, want5)), (got5, want5)


def check_in_dim4_kernels(lk, task, val_batch) -> dict:
    """K3, K4 and K5 on the param-model path's own arguments (in_dim 4: the
    audio, the LFO and the latent of 2), each against its plain version:
    K3/K4 within 1e-4, K5 within 5e-4 of each output's largest magnitude,
    dseq's latent rows (the param model's gradient) among them."""
    k3_args, k4_args, k5_args, _ = path_lstm_args(lk, task, val_batch)
    in_dim = k4_args[0].shape[1]
    if in_dim != 4:
        fail(f"variants param: the LSTM's input is {in_dim} wide, expected 4")
    err3, err4, err5, (got5, want5) = lstm_plain_errors(lk, k3_args, k4_args, k5_args)
    err_lat = rel_err(got5[0][:, :3], want5[0][:, :3])
    b, _, t = k4_args[0].shape
    print(f"[variants param kernels, B={b} T={t} H={k4_args[5].shape[0]} in_dim={in_dim}, "
          f"{lk.forward_kernel(64, b)[0]} / {lk.backward_kernel(64, b)[0]}] K3 max_abs={err3:.3e} "
          f"K4 max_abs={err4:.3e} (tolerance {KERNEL_TOL}); K5 max_rel={err5:.3e}, dseq latent rows "
          f"max_rel={err_lat:.3e} (tolerance {GRAD_REL})")
    if not (err3 <= KERNEL_TOL and err4 <= KERNEL_TOL):
        fail(f"variants param: K3/K4 at in_dim 4 disagree with their plain versions: {err3}, {err4}")
    if not (err5 <= GRAD_REL and err_lat <= GRAD_REL):
        fail(f"variants param: K5 at in_dim 4 disagrees with its plain version: {err5}, {err_lat}")
    return dict(k3=err3, k4=err4, k5=err5, dseq_latent=err_lat)


def run_variants(lk, rows: list) -> dict:
    """The `variants` phase, through `cli.RunConfig` and the tasks:
    (a) the SpectralTCN extractor's stage 1 (5 x 96, kernel 13, dilations
    1-16, n_fft 1024, hop 256) on interwoven batches of 32: a `val_step` and
    3 `train_step`s (K1, K2); (b) the param-model latent (SpectralDSTCN at
    the JAX defaults, LSTM-64 with latent_dim 3) on the frozen r7 extractor,
    dry/wet flanger pairs of 32 (the wet through K1), 83 chunks a step: a
    `val_step` and 2 `train_step`s (K3, K4, K5 at in_dim 4) and the kernels
    at the path's arguments; (c) the unfrozen r7 extractor, trained in
    every chunk: a `val_step` and 2 `train_step`s, its weights moved; (d)
    `stretch_smooth_n_frames: 4`: its updates a batch, a `val_step` and 2
    `train_step`s; (e) `train_steps` over 2 batches bit for bit 2
    `train_step`s.  Then (a)-(d) are each held against the CPU, the CPU
    runs in spawned processes (`variant_reference`)."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from mod_extraction_tpu_torch import cli

    t_phase = time.perf_counter()
    out = {}
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def batches(name, n, seed=5000):
        """n batches of 32 (the TBPTT items' wet through K1, counted)."""
        reset_launch_counts()
        out_ = [_variant_batch(name, seed + s, BATCH, N_SAMPLES, "cuda") for s in range(n)]
        add(launch_counts())
        return out_

    def tbptt_step(n_up):
        return dict(flanger=0, phaser=0, lstm_forward=1, lstm_train_forward=n_up, lstm_backward=n_up)

    tbptt_val = dict(flanger=0, phaser=0, lstm_forward=1, lstm_train_forward=0, lstm_backward=0)

    # (a) SpectralTCN, stage 1
    task = cli.RunConfig(variant_config("tcn"), "cuda").task
    m = task.model
    print(f"[variants tcn] {type(m).__name__}: {len(m.tcn.blocks)} x {m.tcn.blocks[0].conv.out_channels} "
          f"channels, kernel {m.tcn.kernel_size}, dilations {m.tcn.dilations}, n_fft {m.n_fft}, hop "
          f"{m.hop_len}, {sum(p.numel() for p in m.parameters())} parameters, batch {BATCH}")
    fx_once = dict(flanger=1, phaser=1)
    r = _variant_steps("tcn", task, batches("tcn", 1, 6000)[0], batches("tcn", N_VARIANT_TCN_STEPS),
                       fx_once, fx_once)
    add(r["launches"])
    out["tcn"] = r

    # (b) the param-model latent
    task = cli.RunConfig(variant_config("param"), "cuda").task
    n_up = task.updates_per_batch
    if n_up != 83:
        fail(f"variants param: updates_per_batch is {n_up}, expected 83")
    val_batch = batches("param", 1, 6000)[0]
    r = _variant_steps("param", task, val_batch, batches("param", N_VARIANT_TBPTT_STEPS), tbptt_step(n_up),
                       tbptt_val)
    add(r["launches"])
    r["kernels"] = check_in_dim4_kernels(lk, task, val_batch)
    out["param"] = r

    # (c) the unfrozen extractor
    task = cli.RunConfig(variant_config("unfrozen"), "cuda").task
    before = {k: v.clone() for k, v in task.lfo_model.state_dict().items()}
    train = batches("unfrozen", N_VARIANT_TBPTT_STEPS)
    untrained = [float(task._prepare(b)[4].mean()) for b in train]  # each batch under the untrained extractor
    r = _variant_steps("unfrozen", task, batches("unfrozen", 1, 6000)[0], train,
                       tbptt_step(task.updates_per_batch), tbptt_val)
    add(r["launches"])
    print(f"[variants unfrozen] valid LFO fraction of each train batch under the untrained extractor "
          f"{untrained}; in the steps, batch i under the extractor after i batches: {r['valid_fractions']}")
    r["untrained_valid_fractions"] = untrained
    moved = max(float((v - before[k]).abs().max()) for k, v in task.lfo_model.state_dict().items())
    print(f"[variants unfrozen] the extractor's largest weight change over the steps {moved:.3e}")
    if not moved > 0:
        fail("variants unfrozen: the extractor's weights did not move")
    r["extractor_moved"] = moved
    out["unfrozen"] = r

    # (d) the stretch's own smoothing
    task = cli.RunConfig(variant_config("stretch"), "cuda").task
    if task.updates_per_batch != STRETCH_UPDATES:
        fail(f"variants stretch: updates_per_batch {task.updates_per_batch}, expected {STRETCH_UPDATES}")
    r = _variant_steps("stretch", task, batches("stretch", 1, 6000)[0], batches("stretch", 2),
                       tbptt_step(STRETCH_UPDATES), tbptt_val)
    add(r["launches"])
    out["stretch"] = r

    # (e) train_steps against train_step in turn, bit for bit
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tb = batches("param", 2)
        many, single = (cli.RunConfig(variant_config("param"), "cuda").task for _ in range(2))
        reset_launch_counts()
        t0 = time.perf_counter()
        stacked = many.train_steps(tb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        add(launch_counts())
        reset_launch_counts()
        seq = [single.train_step(b) for b in tb]
        add(launch_counts())
    finally:
        torch.backends.cudnn.deterministic = prev
    same = all(torch.equal(stacked[k], torch.stack([s[k] for s in seq])) for k in stacked) and all(
        torch.equal(v, single.trained_model.state_dict()[k]) for k, v in many.trained_model.state_dict().items())
    print(f"[variants train_steps] 2 batches in {dt * 1e3:.1f} ms, losses {stacked['loss'].tolist()}; "
          f"bit for bit two train_step calls: {same}")
    if not same:
        fail("variants: train_steps differs from train_step called in turn")
    out["train_steps"] = dict(ms=dt * 1e3, bit_for_bit=same)

    # each item against the CPU at batch 2 of 0.5 s clips, the card's runs
    # of the same size beside the CPU's (after the card's paths are timed)
    t0 = time.perf_counter()
    names = ("tcn", "param", "unfrozen", "stretch")
    with ProcessPoolExecutor(len(names), mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {n: pool.submit(variant_reference, n, "cpu") for n in names}
        for name in names:
            tol = (0.0, VAL_RTOL) if name == "tcn" else VARIANT_LOSS_TOL
            out[name]["cpu"] = check_variant_against_cpu(
                name, variant_reference(name, "cuda"), cpu[name].result(), tol)
    print(f"[variants] card-vs-CPU checks {time.perf_counter() - t0:.1f} s")

    print(f"[variants] launches {launches}")
    for row in rows:
        key = ROW_COUNTER.get(row["name"])
        if key in launches and launches[key]:
            row["launches"] += launches[key]
            row["variants_launches"] = launches[key]
        if row["name"].startswith("lstm_effect_model") and not row["name"].endswith("_h160"):
            row["variants_in_dim4_err"] = out["param"]["kernels"]
    out["launches"] = launches
    out["s"] = time.perf_counter() - t_phase
    print(f"[variants total] {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# data preparation and the lineage tools: the port's last scripts, as a user
# runs them
# ---------------------------------------------------------------------------

PREP_CORPUS = (8, 4, 12.0)  # train riffs, val riffs, seconds each
PREP_CONFIGS = ("configs/data/gen_idmt_fl.yml", "configs/data/gen_idmt_ch.yml")
PREP_EXAMPLES = 256  # two batches of the configs' 128
PREP_WET_TOL, PREP_MOD_TOL = 1e-4, 1e-6  # the render, card against CPU, first batch's rows 0-1
PREP_CPU_ROWS = 2
PREP_WARMUP_BATCH = 64  # the JAX script's batch
PREP_WARMUP_CPU_BATCH = 2
PREP_RESUME = (2, 1)  # total epochs, epochs a process: two processes
PREP_EGFX = ("Chorus", "Clean", "Phaser")  # effect directories of 48 kHz files
PREP_EGFX_FILES, PREP_EGFX_SECONDS = 10, 1.0
PREP_EGFX_LSB = 1  # PCM16 steps, the card's resampling against the CPU's


def pcm16_roundtrip(x: np.ndarray) -> np.ndarray:
    """What `data/wav.py`'s PCM16 `wav_write` then `wav_read` give for x."""
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0


def check_preproc(gen, cfg: dict, out: Path, d: int) -> dict:
    """The triplets `generate` wrote to `out`, against the same draws (the
    loader is seeded) rendered again on the card: the file names, and every
    file read back through `PreprocessedDataset` and through the
    `random_preproc` module's sampler, exactly (the PCM16 round trip of the
    render, `mod_sig` and `fx_params` as rendered).  Rows 0-1 of the first
    batch are also rendered on the CPU (PREP_WET_TOL / PREP_MOD_TOL), and K1
    is timed on that batch.  These launches are comparisons, not counted."""
    import hashlib

    from mod_extraction_tpu_torch.data.datasets import PreprocessedDataset
    from mod_extraction_tpu_torch.data.modules import RandomPreprocessedDataModule
    from mod_extraction_tpu_torch.train.loop import _tree_map
    from mod_extraction_tpu_torch.train.render import render_batch

    dm, loader = gen.make_loader(cfg, PREP_EXAMPLES)
    sr, n = int(dm.render_cfg.sr), dm.render_cfg.n_samples
    want, res, first = {}, {}, None
    for b, batch in enumerate(loader.epoch(0)):
        on_card = gen.to_device(batch, "cuda")
        dry, wet, mod, fx = (a.cpu().numpy() if torch.is_tensor(a) else {k: v.cpu().numpy() for k, v in a.items()}
                             for a in render_batch(on_card, dm.render_cfg))
        if b == 0:
            first = on_card
            cpu = render_batch(gen.to_device(_tree_map(lambda a: a[:PREP_CPU_ROWS], batch), "cpu"), dm.render_cfg)
            res["wet_err"] = float(np.abs(wet[:PREP_CPU_ROWS] - cpu[1].numpy()).max())
            res["mod_err"] = float(np.abs(mod[:PREP_CPU_ROWS] - cpu[2].numpy()).max())
        for i in range(dry.shape[0]):
            h = hashlib.sha1(dry[i].tobytes()).hexdigest()[:16]
            want[h] = (dry[i], wet[i], mod[i], {k: np.asarray(v[i]).item() for k, v in fx.items()})
    names = sorted(p.name for p in out.iterdir())
    expect = sorted(f"{h}{s}" for h in want for s in (".npz", "_dry.wav", "_wet.wav"))
    if len(want) != PREP_EXAMPLES or names != expect:
        fail(f"prep {out.name}: {len(names)} files written, {len(expect)} expected, or other names")
    if not (res["wet_err"] <= PREP_WET_TOL and res["mod_err"] <= PREP_MOD_TOL):
        fail(f"prep {out.name}: the card's render against the CPU's: wet {res['wet_err']}, mod_sig {res['mod_err']}")

    ds = PreprocessedDataset(str(out), n, sr)
    by_dry, wet_dev = {}, 0.0
    for i, path in enumerate(ds.pt_paths):
        dry, wet, mod, fx = want[Path(path).stem]
        item = ds.getitem(0, i)
        with np.load(path, allow_pickle=True) as npz:
            exact = (np.array_equal(item["dry"], pcm16_roundtrip(dry)) and np.array_equal(item["wet"], pcm16_roundtrip(wet))
                     and np.array_equal(npz["mod_sig"], mod) and np.array_equal(item["mod_sig"], mod)
                     and npz["fx_params"].item() == fx)
        if not exact:
            fail(f"prep {out.name}: {Path(path).stem} does not read back as written")
        wet_dev = max(wet_dev, float(np.abs(item["wet"] - wet).max()))
        by_dry[item["dry"].tobytes()] = item
    rdm = RandomPreprocessedDataModule(dm.batch_size, dm.batch_size, dm.batch_size, str(out), str(out), n, sr)
    rdm.setup("fit")
    drawn = next(rdm.train_loader().epoch(0))
    for j in range(dm.batch_size):
        item = by_dry.get(drawn["dry"][j].tobytes())
        if item is None or not (np.array_equal(drawn["wet"][j], item["wet"])
                                and np.array_equal(drawn["mod_sig"][j], item["mod_sig"])
                                and all(float(drawn["fx"][k][j]) == float(v) for k, v in item["fx"].items())):
            fail(f"prep {out.name}: the random_preproc module's row {j} is not a written triplet")
    res["wet_readback_vs_render"] = wet_dev
    print(f"[prep {out.name}] {len(want)} triplets read back exactly (PreprocessedDataset, and a batch of "
          f"{dm.batch_size} from RandomPreprocessedDataModule); wet PCM16 vs render max {wet_dev:.3e} "
          f"({wet_dev * 32768:.2f} steps of 1/32768); card vs CPU (rows 0-{PREP_CPU_ROWS - 1}) wet "
          f"{res['wet_err']:.3e} (limit {PREP_WET_TOL}), mod_sig {res['mod_err']:.3e} (limit {PREP_MOD_TOL})")
    return res, k1_args(first, d)


def start_plain_on_cpu(name: str, calls: list, tmp: Path) -> tuple:
    """Starts a CPU process that runs `fx_kernels.<name>`, a kernel's plain
    version, on each argument tuple of `calls` (the card's inputs, copied),
    timing each call; returns (the process, the file its outputs and
    seconds go to)."""
    src, dst = tmp / f"{name}_in.pt", tmp / f"{name}_out.pt"
    torch.save([tuple(a.cpu() if torch.is_tensor(a) else a for a in args) for args in calls], src)
    code = ("import sys, time, torch; torch.set_num_threads(1); "
            "from mod_extraction_tpu_torch.ops import fx_kernels as f; "
            "out = []\nfor a in torch.load(sys.argv[1]):\n    t0 = time.perf_counter(); "
            f"out.append((f.{name}(*a), time.perf_counter() - t0))\ntorch.save(out, sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, str(src), str(dst)], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, dst


def plain_results(proc, dst: Path, outs: list, label: str) -> tuple:
    """(max-abs of each kernel output in `outs` (on the CPU) against the
    plain version's output that `start_plain_on_cpu`'s process wrote, the
    ms of each plain call there); fails above KERNEL_TOL."""
    _, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"{label}: the plain version on the CPU: rc {proc.returncode}: {stderr[-2000:]}")
    res = torch.load(dst)
    errs = [max_abs(o, r) for o, (r, _) in zip(outs, res)]
    if not all(e <= KERNEL_TOL for e in errs):
        fail(f"{label} disagrees with its plain version on the same inputs: {errs}")
    return errs, [sec * 1e3 for _, sec in res]


def plain_errors(proc, dst: Path, outs: list, label: str) -> list:
    """The errors of `plain_results`."""
    return plain_results(proc, dst, outs, label)[0]


def fabricate_egfx_48k(root: Path) -> None:
    """PREP_EGFX effect directories of the same PREP_EGFX_FILES names at 48 kHz."""
    from mod_extraction_tpu_torch.data.wav import wav_write

    rng = np.random.default_rng(21)
    t = np.arange(int(PREP_EGFX_SECONDS * 48000)) / 48000
    for effect in PREP_EGFX:
        (root / effect).mkdir(parents=True)
        for i in range(PREP_EGFX_FILES):
            x = 0.5 * np.sin(2 * np.pi * rng.uniform(80, 2000) * t) + 0.05 * rng.standard_normal(t.size)
            wav_write(str(root / effect / f"{i + 1}.wav"), x.astype(np.float32), 48000)


def run_prep(rows: list) -> dict:
    """(a) the riff corpus through `scripts/make_synthetic_corpus_torch.py`;
    (b) `scripts/generate_preproc_datasets_torch.py` on in-memory copies of
    `gen_idmt_fl.yml` and `gen_idmt_ch.yml` (batch 128, 88200 samples, K1)
    pointed at it, the triplets read back and K1 timed at 128 rows, and
    every row of K1's first batch against `flanger_plain` on the CPU;
    (c) `scripts/measure_phaser_warmup_delta_torch.py` at batch 64 (K2 and
    the shipped r5 extractor), both K2 calls ((64, 1, 88200) cold and
    (64, 1, 176400) warmed) against `phaser_plain` on the CPU on the same
    inputs, and card against CPU at batch 2 in float32 convs;
    (d) `scripts/train_resumable_torch.sh` on the fit phase's cut r7
    extractor config, two epochs in two processes, then
    `scripts/export_best_torch.sh` and the export loaded; (e) the EGFx split
    of `scripts/split_datasets_torch.py`, resampled on the card against the
    CPU."""
    import copy
    import os

    import yaml

    from mod_extraction_tpu_torch import cli
    from mod_extraction_tpu_torch.data.synthetic import fit_config
    from mod_extraction_tpu_torch.data.wav import wav_read
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops import fx_kernels as fxk
    from mod_extraction_tpu_torch.ops.fx import ms_to_samples

    t_phase = time.perf_counter()
    corpus_script = load_script("make_synthetic_corpus_torch")
    gen = load_script("generate_preproc_datasets_torch")
    warm = load_script("measure_phaser_warmup_delta_torch")
    split = load_script("split_datasets_torch")
    none = {k: 0 for k in outside_k7(launch_counts())}
    out = dict(launches=dict(none), configs={})
    cpu_ref, procs = None, []
    k1_calls, k1_outs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            # -- (a) the corpus
            t0 = time.perf_counter()
            corpus = tmp / "corpus"
            corpus_script.main([str(corpus), *(str(v) for v in PREP_CORPUS)])
            out["corpus_s"] = time.perf_counter() - t0
            print(f"[prep (a)] corpus {PREP_CORPUS[0]} + {PREP_CORPUS[1]} riffs of {PREP_CORPUS[2]} s in "
                  f"{out['corpus_s']:.1f} s")
            # the CPU side of (c) runs beside (b)-(e) in a process of its own
            code = ("import json, sys, torch; torch.set_num_threads(2); sys.path.insert(0, 'scripts'); "
                    "import measure_phaser_warmup_delta_torch as m; "
                    f"print(json.dumps(m.main({str(corpus / 'val')!r}, {PREP_WARMUP_CPU_BATCH}, 'cpu', 'float32')))")
            cpu_ref = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)

            # -- (b) preprocessed triplets, K1 on the card
            for path in PREP_CONFIGS:
                t0 = time.perf_counter()
                cfg = cli.load_yaml_with_includes(path)
                cfg["data"]["init_args"].update(train_dir=str(corpus / "train"), val_dir=str(corpus / "val"))
                fl = cfg["data"]["init_args"]["fx_config"]["flanger"]
                d = ms_to_samples(fl["max_min_delay_ms"], SR) + ms_to_samples(fl["max_lfo_delay_ms"], SR)
                dest = tmp / Path(path).stem
                reset_launch_counts()
                count = gen.generate(copy.deepcopy(cfg), str(dest), PREP_EXAMPLES, "cuda")
                torch.cuda.synchronize()
                launches = outside_k7(launch_counts())
                gen_s = time.perf_counter() - t0
                n_batches = PREP_EXAMPLES // cfg["data"]["init_args"]["batch_size"]
                if count != PREP_EXAMPLES or launches != dict(none, flanger=n_batches):
                    fail(f"prep {path}: {count} examples written, launches {launches}; expected "
                         f"{PREP_EXAMPLES} and {n_batches} K1 launches")
                out["launches"]["flanger"] += launches["flanger"]
                t0 = time.perf_counter()
                res, args = check_preproc(gen, cfg, dest, d)
                res.update(generate_s=gen_s, check_s=time.perf_counter() - t0, d=d, launches=launches["flanger"])
                k1 = check_k1_path(fxk, args, f"prep {Path(path).name}, {tuple(args[0].shape)}, d {d}")
                k1_calls.append(args)
                k1_outs.append(fxk.flanger(*args).cpu())
                res.update({f"k1_{k}": k1[k] for k in ("ms", "walk_ms", "bound_ms", "steps_max", "cycles_per_step")})
                out["configs"][Path(path).name] = res
                print(f"[prep (b)] {path}: {count} triplets at batch {cfg['data']['init_args']['batch_size']} x "
                      f"{N_SAMPLES} in {gen_s:.1f} s ({launches['flanger']} K1 launches), checked in "
                      f"{res['check_s']:.1f} s; K1 {k1['ms']:.4f} ms beside its bound {k1['bound_ms']:.4f} ms")

            # every row of K1's first batches against the plain version, on the CPU beside (c)-(e)
            procs.append(start_plain_on_cpu("flanger_plain", k1_calls, tmp))

            # -- (c) the phaser warm-up delta, K2 on the card; its inputs and outputs recorded
            t0 = time.perf_counter()
            val = str(corpus / "val")
            k2_calls, k2_outs = [], []
            reset_launch_counts()
            with recorded(fxk, "phaser", k2_calls, k2_outs):
                l1 = warm.main(val, PREP_WARMUP_BATCH, "cuda")
            torch.cuda.synchronize()
            launches = outside_k7(launch_counts())
            procs.append(start_plain_on_cpu("phaser_plain", k2_calls, tmp))
            if launches != dict(none, phaser=2) or not all(math.isfinite(v) and v > 0 for v in l1):
                fail(f"prep warm-up delta: l1 {l1}, launches {launches}; expected 2 K2 launches")
            out["launches"]["phaser"] += launches["phaser"]
            card32 = warm.main(val, PREP_WARMUP_CPU_BATCH, "cuda", "float32")
            out["warmup"] = dict(bf16_batch64=l1, card_f32=card32, s=time.perf_counter() - t0)
            print(f"[prep (c)] warm-up delta at batch {PREP_WARMUP_BATCH} (bf16 convs as shipped): cold {l1[0]:.6f} "
                  f"warm {l1[1]:.6f}; {launches['phaser']} K2 launches; {out['warmup']['s']:.1f} s")

            # -- (d) the lineage tools: two processes, the second resuming
            t0 = time.perf_counter()
            cfg = fit_config(FIT_LFO_CONFIG, corpus, None, FIT_TRAIN_BATCHES, FIT_VAL_BATCHES)
            cfg_path = tmp / "resume.yml"
            cfg_path.write_text(yaml.safe_dump(cfg))
            runs, log = tmp / "runs", tmp / "launches.jsonl"
            # the preflight's kernel checks are this script's stages above
            env = dict(os.environ, PYTHON=sys.executable, OUT_DIR=str(runs), MODX_LAUNCH_LOG=str(log),
                       SKIP_PARITY_GATE="1")
            proc = subprocess.run(["bash", str(ROOT / "scripts" / "train_resumable_torch.sh"), str(cfg_path),
                                   *(str(v) for v in PREP_RESUME)], cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=900)
            if proc.returncode != 0:
                fail(f"prep train_resumable_torch.sh rc {proc.returncode}: {proc.stderr[-3000:]}")
            records = fit_records(str(runs))
            epochs = [r["epoch"] for r in records if r["phase"] == "epoch"]
            steps = [r["step"] for r in records if r["phase"] == "train_step"]
            per_epoch = dict(none, flanger=FIT_TRAIN_BATCHES + FIT_VAL_BATCHES,
                             phaser=FIT_TRAIN_BATCHES + FIT_VAL_BATCHES,
                             conv_wgrad=K6_A_BACKWARD * FIT_TRAIN_BATCHES,
                             trunk_block_fwd=K7_A_PASS * (FIT_TRAIN_BATCHES + FIT_VAL_BATCHES),
                             trunk_block_bwd=K7_A_PASS * FIT_TRAIN_BATCHES)
            counts = read_launch_log(str(log))
            if epochs != [0, 1] or steps != list(range(1, 2 * FIT_TRAIN_BATCHES + 1)) or counts != [per_epoch] * 2:
                fail(f"prep train_resumable_torch.sh: epochs {epochs}, steps {steps}, launches a process {counts}")
            for k in ("flanger", "phaser"):
                out["launches"][k] += sum(c[k] for c in counts)
            run = next(runs.glob("*_metrics.jsonl")).name.removesuffix("_metrics.jsonl")
            npz = tmp / "export.npz"
            exp = subprocess.run(["bash", str(ROOT / "scripts" / "export_best_torch.sh"), run, str(npz)], cwd=ROOT,
                                 env=env, capture_output=True, text=True, timeout=300)
            ckpts = runs / f"{run}_ckpts"
            best = ckpts / "best.pt" if (ckpts / "best.pt").exists() else ckpts / "last.pt"
            if exp.returncode != 0 or not exp.stdout.startswith(f"exporting {run} from {best}"):
                fail(f"prep export_best_torch.sh rc {exp.returncode}: {exp.stdout[-2000:]} {exp.stderr[-2000:]}")
            model = load_spectral_2dcnn(str(npz), device="cuda", **PAPER, compute_dtype="bfloat16")
            state = torch.load(best, map_location="cpu", weights_only=False)["task"]["model"]
            same = all(torch.equal(v.cpu(), state[k].float()) for k, v in model.state_dict().items())
            wav, _ = wav_read(next((corpus / "val").glob("*.wav")))
            x = torch.from_numpy(np.stack([wav[:, :N_SAMPLES]] * 2, 1)).to("cuda")  # (1, 2, T): dry = wet
            with torch.no_grad():
                mod_hat, _ = model.eval()(x)
            if not (same and mod_hat.shape[:2] == (1, 1) and torch.isfinite(mod_hat).all()):
                fail(f"prep: the export of {best} does not hold its weights ({same}) or its forward fails")
            out["resume"] = dict(s=time.perf_counter() - t0, epochs=epochs, steps=steps)
            print(f"[prep (d)] train_resumable_torch.sh {PREP_RESUME[0]} epochs in chunks of {PREP_RESUME[1]}: "
                  f"epochs {epochs}, steps {steps}, launches a process {counts[0]}; export_best_torch.sh took "
                  f"{best.name}, its .npz loads in Spectral2DCNN bit for bit; {out['resume']['s']:.1f} s")

            # -- (e) the EGFx split, resampled on the card and on the CPU
            t0 = time.perf_counter()
            worst, trees = 0, {}
            for side, dev in (("card", "cuda"), ("cpu", "cpu")):
                root = tmp / f"egfx_{side}"
                fabricate_egfx_48k(root)
                split.split_egfx(str(root), device=dev)
                trees[side] = sorted(str(p.relative_to(root)) for p in root.rglob("*.wav")
                                    if p.parts[len(root.parts)] in ("train", "val", "test"))
            if trees["card"] != trees["cpu"] or len(trees["card"]) != len(PREP_EGFX) * PREP_EGFX_FILES:
                fail(f"prep EGFx split: {len(trees['card'])} files on the card, {len(trees['cpu'])} on the CPU")
            for f in trees["card"]:
                a, sr = wav_read(str(tmp / "egfx_card" / f))
                b, _ = wav_read(str(tmp / "egfx_cpu" / f))
                if sr != 44100 or a.shape != b.shape:
                    fail(f"prep EGFx split {f}: {sr} Hz, {a.shape} vs {b.shape}")
                worst = max(worst, int(round(float(np.abs(a - b).max()) * 32768)))
            if worst > PREP_EGFX_LSB:
                fail(f"prep EGFx split: the card's files are {worst} PCM16 steps from the CPU's")
            out["egfx"] = dict(files=len(trees["card"]), worst_lsb=worst, s=time.perf_counter() - t0)
            print(f"[prep (e)] EGFx split of {len(trees['card'])} files at 48 kHz -> 44.1 kHz: card vs CPU "
                  f"{worst} PCM16 steps at most (limit {PREP_EGFX_LSB}); {out['egfx']['s']:.1f} s")

            # -- (c), the CPU side
            t0 = time.perf_counter()
            stdout, stderr = cpu_ref.communicate(timeout=900)
            if cpu_ref.returncode != 0:
                fail(f"prep warm-up delta on the CPU: rc {cpu_ref.returncode}: {stderr[-2000:]}")
            cpu32 = json.loads(stdout.strip().splitlines()[-1])
            rel = max(abs(a - b) / abs(b) for a, b in zip(card32, cpu32))
            out["warmup"].update(cpu_f32=cpu32, rel=rel)
            print(f"[prep (c)] warm-up delta at batch {PREP_WARMUP_CPU_BATCH}, float32 convs: card {card32}, CPU "
                  f"{cpu32}, worst rel {rel:.3e} (limit {VAL_RTOL}); waited {time.perf_counter() - t0:.1f} s")
            if not rel <= VAL_RTOL:
                fail(f"prep warm-up delta: card {card32} against the CPU {cpu32}")

            # -- K1 of (b) and K2 of (c) against their plain versions on the same inputs
            t0 = time.perf_counter()
            k1_errs = plain_errors(*procs[0], k1_outs, "prep K1 at 128 rows")
            for res, err in zip(out["configs"].values(), k1_errs):
                res["k1_err"] = err
            k2_errs = plain_errors(*procs[1], k2_outs, "prep K2 (warm-up delta)")
            out["warmup"]["k2_err"] = {str(tuple(o.shape)): e for o, e in zip(k2_outs, k2_errs)}
            print(f"[prep plain] K1 at {[tuple(o.shape) for o in k1_outs]}, all rows: max_abs_err {k1_errs}; "
                  f"K2 of the warm-up delta: max_abs_err {out['warmup']['k2_err']} (limit {KERNEL_TOL}; "
                  f"flanger_plain / phaser_plain on the CPU); waited {time.perf_counter() - t0:.1f} s")
        finally:
            for proc in [cpu_ref, *(p for p, _ in procs)]:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()

    for row in rows:
        key = ROW_COUNTER.get(row["name"])
        if row["name"] in ("flanger_delay_line", "phaser_allpass"):
            row["launches"] += out["launches"][key]
            row["prep_launches"] = out["launches"][key]
        if row["name"] == "phaser_allpass":
            row["prep_err"] = out["warmup"]["k2_err"]
        if row["name"] == "flanger_delay_line":
            row["prep_128_rows"] = {name: {k.removeprefix("k1_"): v for k, v in res.items() if k.startswith("k1_")}
                                    | dict(d=res["d"]) for name, res in out["configs"].items()}
    out["s"] = time.perf_counter() - t_phase
    print(f"[prep total] {out['s']:.1f} s")
    return out


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
    sources = ("fx.cu", "lstm.cu", "conv_wgrad.cu", "trunk_block.cu")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = list(pool.map(lambda src: cuda_build.build(src, verbose=True), sources))
    print(f"[build] {' '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s")

    phases = {}

    def timed(name, fn, *args):
        """`fn(*args)`, its seconds kept in `phases` (printed at the end)."""
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    # the CPU sides of stage 2's and the H 160 phase's card-vs-CPU steps, each
    # in its own process from here on
    tmp = tempfile.TemporaryDirectory()
    cpu_sides = {fn: start_cpu_side(fn, tmp.name) for fn in ("stage2_cpu_reference", "h160_cpu_reference")}
    atexit.register(lambda: [(p.kill(), p.wait()) for p, _, _ in cpu_sides.values() if p.poll() is None])
    rows, k6_stage1 = timed("stage 1", run_stage1, fxk, rng)
    k7 = timed("trunk block", run_trunk_block)
    k7_row = kernel_row(
        "trunk_block", "mod_extraction_tpu_torch/csrc/trunk_block.cu",
        "none: the JAX package leaves this chain to XLA, which fuses it",
        K7_A_PASS * (1 + 2 * (N_TRAIN_STEPS + 1)), max(k7["worst"].values()), k7["ms"], k7["plain_ms"],
        k7["bytes"], 0, None,
    )
    k7_row.update(err_is="largest deviation over its tolerance (<= 1 holds)", fwd_ms=k7["fwd_ms"],
                  bound_fwd_ms=k7["bound_fwd_ms"], blocks=k7["blocks"], batch=K7_BATCH)
    rows += timed("stage 1 (wgrad=pallas)", run_stage1_kernel_wgrad, fxk, ck, rng)
    # K6's row: the default path's train steps in the stage-1 phase too
    rows[-1]["launches"] += k6_stage1
    rows[-1]["stage1_default_launches"] = k6_stage1
    h64 = {}
    rows += timed("stage 2", run_stage2, fxk, lk, rng, rows[0], h64, cpu_sides["stage2_cpu_reference"])
    h160_rows, k1_h160 = timed("stage 2 H 160", run_stage2_h160, fxk, lk, rng, h64,
                               cpu_sides["h160_cpu_reference"])
    tmp.cleanup()
    saved = {"stage 2": h64["cpu_saved_s"], "stage 2 H 160": h64["h160 cpu"]["cpu_saved_s"]}
    rows += h160_rows
    rows[0]["d1764_h160_path_launches"] = k1_h160
    serving = timed("serving", run_serving, lk, rng)
    k3_row = next(r for r in rows if r["name"] == "lstm_effect_model")
    k3_row["launches"] += serving["launches"][64]
    k3_row["serving"] = {k: v for k, v in serving.items() if k != "h160"}
    k3_h160 = next(r for r in rows if r["name"] == "lstm_effect_model_h160")
    k3_h160["launches"] += serving["launches"][160]
    k3_h160["serving"] = serving["h160"]
    bench_lines = timed("bench_torch", run_bench)

    counters = (fxk, ck, lk)
    none = {k: 0 for c in counters for k in c.LAUNCHES}
    n_batches = FIT_TRAIN_BATCHES + FIT_VAL_BATCHES
    fits = {
        "fit stage 1": timed("fit stage 1", run_fit,
            "fit stage 1", FIT_LFO_CONFIG, counters,
            lambda task: dict(none, flanger=n_batches, phaser=n_batches,
                              conv_wgrad=K6_A_BACKWARD * FIT_TRAIN_BATCHES), bench_lines[0], rows),
        "fit stage 2": timed("fit stage 2", run_fit,
            "fit stage 2", FIT_TBPTT_CONFIG, counters,
            lambda task: dict(none, lstm_forward=n_batches, **tbptt_python_launches(task, FIT_TRAIN_BATCHES)),
            bench_lines[1], rows),
    }
    print("[fits] " + json.dumps(fits))
    print("[eval] " + json.dumps(timed("eval", run_eval, fxk, lk, rows)))
    print("[reference] " + json.dumps(timed("reference", run_reference, fxk, lk, rows)))
    print("[ddp] " + json.dumps(timed("ddp", run_ddp, rows)))
    print("[variants] " + json.dumps(timed("variants", run_variants, lk, rows)))
    print("[prep] " + json.dumps(timed("prep", run_prep, rows)))

    print("[phases, s] " + json.dumps({k: round(v, 1) for k, v in phases.items()})
          + "; the CPU sides beside the card saved " + ", ".join(f"{k} {v:.1f} s" for k, v in saved.items()))
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows + [k7_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
