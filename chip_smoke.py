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
  a few `train_step`s (kernels K1, K3, K4, K5).

For each path it checks that every kernel of the path ran on it (launch
counts), that the outputs are finite, and that the path on the card agrees
with the same path on the CPU in float32 (plain kernel versions).

Prints the card's name and power limit, per-step times, a profile of one
step of each path, and on the last two lines a JSON object of per-kernel
measurements and a JSON status line.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
R7 = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
LSTM64 = ROOT / "models" / "lstm_64__lfo_2dcnn_r7__sim_flanger.npz"
SR, N_SAMPLES, BATCH = 44100.0, 88200, 32
N_TRAIN_STEPS = 4  # timed, after one warm-up step
LOSSES = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}
PAPER = dict(
    in_ch=2, n_samples=N_SAMPLES, sr=SR, n_fft=1024, hop_len=256, n_mels=256,
    kernel_size=(5, 13), out_channels=(64,) * 6,
    temp_dilations=(1, 1, 2, 4, 8, 16), pool_size=(2, 1),
    freq_mask_amount=0.25, time_mask_amount=0.25,
)
KERNEL_TOL = 1e-4  # max-abs, as scripts/tpu_parity_gate.py holds the TPU kernels
GRAD_REL = 5e-4  # gradient leaves, relative to the leaf's largest magnitude (same source)
LOSS_ATOL, LOSS_RTOL = 1e-6, 1e-4  # LSTM training loss (same source)
VAL_RTOL = 1e-3  # float32 val metrics, card vs CPU (reordered float32 sums)
# stage 2 (configs/train_em_sim_flanger_r7.yml; data and optimizer as bench.py's
# stage-2 bench)
TBPTT_CHUNK = 1024
TBPTT = dict(
    warmup_n_samples=TBPTT_CHUNK, step_n_samples=TBPTT_CHUNK, model_smooth_n_frames=8,
    should_stretch=True, max_n_corners=16, discard_invalid_lfos=True,
    loss_dict={"l1": 1.0, "esr": 0.0, "dc": 0.0},
)
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
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


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device ms per call of `fn`, by kernel name (torch.profiler)."""
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
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def kernel_short_name(key: str) -> str:
    """`lstm_bwd_walk_fast_kernel<64>` from the profiler's full signature."""
    m = re.search(r"(\w+)(<[^>(]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


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
    x, g = u(-0.9, 0.9, (b, c, t)), u(0.001, 30.0, (b, c, t))
    fb, mix = u(0, 0.7, (b, 1, 1)), u(0.2, 1, (b, 1, 1))
    err = max_abs(fxk.phaser(x, g, fb, mix, 6), fxk.phaser_plain(x, g, fb, mix, 6))
    print(f"[K2 phaser n={b * c} T={t}] max_abs_err={err:.3e}")
    if not err <= KERNEL_TOL:
        fail(f"K2 disagrees with its plain version: {err}")


def profile_train_step(task, batch, label: str, top: int = 15) -> None:
    """torch.profiler over one train step: device time by kernel (top
    entries) and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies only: a range the optimizer opens ("Optimizer.step#...")
    # is reported with the device time of the kernels inside it, a second time
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith("Optimizer.")
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile {label} train_step] wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")


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
    from mod_extraction_tpu_torch.train.render import (
        RenderConfig,
        flanger_delay_samples,
        phaser_params,
    )
    from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim

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
    mod_audio = linear_interpolate_last_dim(tb["mod_sig"], N_SAMPLES)[:, None, :]
    fl_args = (
        dry, flanger_delay_samples(fx, mod_audio, SR), fx["feedback"][:, None, None],
        fx["depth"][:, None, None], fx["mix"][:, None, None], d,
    )
    pp = phaser_params(fx, SR)
    g, _ = phaser_coefficients(N_SAMPLES, SR, pp["rate_hz"], pp["depth"],
                               pp["centre_frequency_hz"], pp["phase"])
    ph_args = (dry, g[:, None, :], pp["feedback"][:, None, None], pp["mix"][:, None, None], 6)
    n_lanes, t_len = dry.shape[0] * dry.shape[1], dry.shape[2]
    specs = [
        # name, launch key, wrapper, plain, args, replaces, bytes, f32 ops per sample
        ("flanger_delay_line", "flanger", fxk.flanger, fxk.flanger_plain, fl_args,
         "mod_extraction_tpu/ops/pallas_fx.py:45", 4 * (3 * n_lanes * t_len + 3 * n_lanes), 16),
        ("phaser_allpass", "phaser", fxk.phaser, fxk.phaser_plain, ph_args,
         "mod_extraction_tpu/ops/pallas_fx.py:156", 4 * (3 * n_lanes * t_len + 2 * n_lanes), 43),
    ]
    rows = []
    for name, key, kern, plain, args, replaces, n_bytes, ops_per in specs:
        out = kern(*args)
        ms = cuda_ms(lambda: kern(*args), 5)
        ref_out = []
        plain_ms = cuda_ms(lambda: ref_out.append(plain(*args)), 1)
        err = max_abs(out, ref_out[0])
        print(f"[{name} n={n_lanes} T={t_len}] max_abs_err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f}")
        if not err <= KERNEL_TOL:
            fail(f"{name} at the main-path shapes disagrees with its plain version: {err}")
        rows.append(kernel_row(
            name, "mod_extraction_tpu_torch/csrc/fx.cu", replaces, launches[key], err, ms,
            plain_ms, n_bytes, ops_per * n_lanes * t_len, None,
        ))
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
    layers = []
    for f, dil in WGRAD_LAYERS:
        x, g = rand(BATCH, TRUNK_CH, f, N_FRAMES), rand(BATCH, TRUNK_CH, f, N_FRAMES)
        label = f"B={BATCH} F={f} T={N_FRAMES} dil={dil}"
        err, plain_ms = check_wgrad(ck, x, g, dil, label)
        n_ops, n_bytes = wgrad_ops_bytes(BATCH, f, N_FRAMES, TRUNK_CH, TRUNK_CH)
        ms = cuda_ms(lambda: ck.conv2d_wgrad_tapcat(x, g, KF, KT, dil), 5)
        lib = library_wgrad(x, g, dil)
        lib()
        library_ms = cuda_ms(lib, 5)
        bound_ms = max(n_ops / BF16_OPS_S, n_bytes / HBM_BYTES_S) * 1e3
        print(f"[K6 {label}] ms={ms:.3f} bound_ms={bound_ms:.3f} (operations) "
              f"tflops={n_ops / ms / 1e9:.1f} library_ms={library_ms:.3f} plain_ms={plain_ms:.1f}")
        layers.append(dict(bins=f, dil=dil, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, err=err, n_ops=n_ops, n_bytes=n_bytes))
        del x, g, lib
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
    """K3, K4 (its saved gate activations too) and K5 against their plain
    versions on the same inputs, two K5 launches against each other, and the
    K4/K5 training pair against autograd through the plain forward."""
    ref = lk.lstm_forward_plain(**a, save_states=True)  # y, hn, cn, hs, cs, gates
    err3 = max(max_abs(x, y) for x, y in zip(lk.lstm_forward(**a), ref[:3]))
    out4 = lk.lstm_train_forward(**a)
    err4 = max(max_abs(x, y) for x, y in zip(out4[:5], ref[:5]))
    err_gates = max_abs(out4[5], ref[5])
    b, _, t = a["seq"].shape
    hid = a["w_hh"].shape[0]
    label = f"{label}, {'fast' if lk.fast_path(hid) else 'generic'} kernels"
    gen = torch.Generator(device="cuda").manual_seed(dh_seed)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=gen)
    dhn, dcn = (torch.randn(b, hid, device="cuda", generator=gen) for _ in range(2))
    bargs = (a["seq"], *ref[3:6], a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, dhn, dcn)
    got5, again5 = lk.lstm_backward(*bargs), lk.lstm_backward(*bargs)
    err5 = max(rel_err(x, y) for x, y in zip(got5, lk.lstm_backward_plain(*bargs)))
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


def run_stage2(fxk, lk, rng) -> list:
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.convert import load_lstm_effect_model, load_spectral_2dcnn
    from mod_extraction_tpu_torch.models.lstm import lstm_init_state
    from mod_extraction_tpu_torch.ops.corners import find_corners, smoothen
    from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    # -- kernels against their plain versions: the register-resident kernels
    #    (H 64, 16) and the generic ones (H 160, 48) at a T ragged against
    #    both chunk sizes and at a single step, then the main path's shapes
    #    with the shipped weights
    for hid in (64, 160, 16, 48):
        check_lstm_kernels(lk, lstm_inputs(rng, 5, 300, hid), hid, f"LSTM B=5 T=300 H={hid}")
        check_lstm_kernels(lk, lstm_inputs(rng, 1, 1, hid), hid + 1, f"LSTM B=1 T=1 H={hid}")
    if not (lk.fast_path(64) and lk.fast_path(16) and not lk.fast_path(160) and not lk.fast_path(48)):
        fail("the small-shape checks did not cover both kernel paths")
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

    # -- each kernel at the main path's shapes, on the path's own data
    dry, wet, mod_sr, _, weights = task._prepare(val_batch)
    em = task.effect_model
    w = [p.detach() for p in (em.w_ih, em.w_hh, em.b_gates, em.fc_kernel, em.fc_bias)]
    end = TBPTT["warmup_n_samples"] + n_up * TBPTT["step_n_samples"]
    h0, c0 = lstm_init_state(BATCH, 64, "cuda")
    seq_full = torch.cat([mod_sr[:, :, :end], dry[:, :, :end]], 1).contiguous()
    k3_args = (seq_full[:, :, :TBPTT_CHUNK].contiguous(), dry[:, :, :TBPTT_CHUNK].contiguous(),
               h0, c0, *w)  # the warm-up of every train step
    _, hw, cw = lk.lstm_forward(*k3_args)
    sl = slice(TBPTT_CHUNK, 2 * TBPTT_CHUNK)
    k4_args = (seq_full[:, :, sl].contiguous(), dry[:, :, sl].contiguous(), hw, cw, *w)
    y, _, _, hs, cs, gates = lk.lstm_train_forward(*k4_args)
    dz = torch.sign(y - wet[:, :, sl]) * weights[:, None, None] / (weights.sum().clamp(min=1e-8) * TBPTT_CHUNK)
    dz = dz * (1 - y * y)
    dh_in = torch.einsum("ho,bot->bth", w[3], dz).contiguous()
    zeros = torch.zeros_like(hw)
    k5_args = (k4_args[0], hs, cs, gates, hw, cw, *w[:2], dh_in, zeros, zeros)

    lib_lstm = torch.nn.LSTM(2, 64).to("cuda")
    with torch.no_grad():
        lib_lstm.weight_ih_l0.copy_(w[0].T)
        lib_lstm.weight_hh_l0.copy_(w[1].T)
        lib_lstm.bias_ih_l0.copy_(w[2])
        lib_lstm.bias_hh_l0.zero_()
    lib_state = (hw[None].contiguous(), cw[None].contiguous())
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

    rows, times = [], {}
    specs = [
        ("lstm_forward", "lstm_effect_model", lk.lstm_forward, lambda: lk.lstm_forward_plain(*k3_args),
         k3_args, "mod_extraction_tpu/ops/pallas_lstm.py:52", lambda: lib_fwd(warm_tbc),
         lstm_ops_bytes(BATCH, TBPTT_CHUNK, 64, 2, 1)),
        ("lstm_train_forward", "lstm_effect_model_train_fwd", lk.lstm_train_forward,
         lambda: lk.lstm_forward_plain(*k4_args, save_states=True), k4_args,
         "mod_extraction_tpu/ops/pallas_lstm.py:141", lambda: lib_fwd(chunk_tbc),
         lstm_ops_bytes(BATCH, TBPTT_CHUNK, 64, 2, 1, save_states=True)),
        ("lstm_backward", "lstm_effect_model_train_bwd", lk.lstm_backward,
         lambda: lk.lstm_backward_plain(*k5_args), k5_args,
         "mod_extraction_tpu/ops/pallas_lstm.py:198", lib_fwd_bwd,
         lstm_ops_bytes(BATCH, TBPTT_CHUNK, 64, 2, 1, backward=True)),
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
        t_len = args[0].shape[-1]
        print(f"[{name} B={BATCH} T={t_len} H=64] err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f} "
              f"library_ms={library_ms:.3f} (torch.nn.LSTM, no fc head; medians of 5 x 20 calls)")
        if not err <= tol:
            fail(f"{name} at the main-path shapes disagrees with its plain version: {err}")
        rows.append(kernel_row(
            name, "mod_extraction_tpu_torch/csrc/lstm.cu", replaces, total[key], err, ms,
            plain_ms, n_bytes, n_ops, library_ms,
        ))
    # the pair a training user pays for: the library's forward + backward call
    # holds its own forward, so it stands beside K4 + K5
    pair_ms = times["lstm_train_forward"][0] + times["lstm_backward"][0]
    print(f"[K4 + K5 B={BATCH} T={TBPTT_CHUNK} H=64] ms={pair_ms:.3f} beside torch.nn.LSTM forward + backward "
          f"{times['lstm_backward'][1]:.3f}; K3 {times['lstm_forward'][0]:.3f} and K4 "
          f"{times['lstm_train_forward'][0]:.3f} beside its forward {times['lstm_forward'][1]:.3f} / "
          f"{times['lstm_train_forward'][1]:.3f}")
    # cycles a step of the two walks: kernel time / T x the SM clock under load
    by_kernel = device_ms_by_kernel(lambda: lk.lstm_backward(*k5_args), 10)
    walk_ms = sum(v for k_, v in by_kernel.items() if "bwd_walk" in k_)
    mhz = sm_clock_mhz(lambda: lk.lstm_train_forward(*k4_args))
    print("[K5 by kernel, ms a launch] " + "  ".join(
        f"{k_}={v:.4f}" for k_, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"[cycles a step at {mhz:.0f} MHz (nvidia-smi clocks.sm under load)] "
          f"K4 walk {times['lstm_train_forward'][0] / TBPTT_CHUNK * mhz * 1e3:.0f}  "
          f"K5 walk {walk_ms / TBPTT_CHUNK * mhz * 1e3:.0f} (walk kernel {walk_ms:.4f} ms)")
    if not walk_ms > 0:
        fail(f"the profiler saw no K5 walk kernel: {sorted(by_kernel)}")

    # K3 over the whole val_step clip: timed at full length, held against
    # the plain version on its first 4096 steps (the plain loop is slow), and
    # its final state against a float64 plain walk of one batch row on the
    # CPU, where drift over the long walk would show
    k3_val = (seq_full, dry[:, :, :end].contiguous(), h0, c0, *w)
    val_ms = cuda_ms(lambda: lk.lstm_forward(*k3_val), 3)
    n_cmp = 4096
    head = [a[..., :n_cmp].contiguous() for a in k3_val[:2]]
    err = max(max_abs(x, y_) for x, y_ in zip(
        lk.lstm_forward(*head, *k3_val[2:]), lk.lstm_forward_plain(*head, *k3_val[2:])))
    if not err <= KERNEL_TOL:
        fail(f"K3 on the val_step clip's first {n_cmp} steps disagrees with its plain version: {err}")
    drift, drift_y = long_walk_drift(lk, k3_val)
    if not (drift <= KERNEL_TOL and drift_y <= KERNEL_TOL):
        fail(f"K3 after {end} steps is {drift} (state) / {drift_y} (y) from a float64 walk")
    try:
        full_tbc = seq_full.permute(2, 0, 1).contiguous()
        lib_fwd(full_tbc)
        lib_val = f"{cuda_ms(lambda: lib_fwd(full_tbc), 3):.3f}"
    except RuntimeError as e:  # a yardstick only: report what cuDNN refused
        lib_val = f"refused ({str(e).splitlines()[0][:80]})"
    val_ops, val_bytes = lstm_ops_bytes(BATCH, end, 64, 2, 1)
    print(f"[lstm_effect_model val_step B={BATCH} T={end} H=64] ms={val_ms:.3f} "
          f"err(first {n_cmp} steps)={err:.3e} (hn, cn) after {end} steps vs float64 CPU walk, row 0: "
          f"{drift:.3e}, y over the clip: {drift_y:.3e} "
          f"bound_ms={max(val_ops / F32_OPS_S, val_bytes / HBM_BYTES_S) * 1e3:.4f} library_ms={lib_val}")

    # -- where one full-width TBPTT train step spends the card's time
    profile_train_step(task, train_batches[1], "stage 2")
    return rows


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
    rows += run_stage2(fxk, lk, rng)
    print(f"[stage 2 total] {time.perf_counter() - t0:.1f} s")

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
