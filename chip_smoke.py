"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `mod_extraction_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives the stage-1
main path through the port's entry points at full width: the paper
Spectral2DCNN (6x64 channels, 256 mels, 2 s clips at 44.1 kHz, bf16 convs)
holding the shipped r7 extractor weights, a `val_step` and a few AdamW
`train_step`s on interwoven (flanger + chorus + phaser) synthetic batches of
32.  It checks that both kernels ran on that path, that the outputs are
finite, and that a float32 `val_step` on the card agrees with the same step
on the CPU (plain kernel versions).

Prints the card's name and power limit, per-step times, and on the last two
lines a JSON object of per-kernel measurements and a JSON status line.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
R7 = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
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
VAL_RTOL = 1e-3  # float32 val metrics, card vs CPU (reordered float32 sums)
# H100 SXM published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12


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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


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


def profile_train_step(task, batch, top: int = 15) -> None:
    """torch.profiler over one train step: device time by kernel (top
    entries) and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile train_step] wall_ms={wall_ms:.2f} device_busy_ms={busy_ms:.2f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from mod_extraction_tpu_torch.data.synthetic import (
        batch_to_torch,
        flanger_max_delay_samples,
        make_interwoven_batch,
    )
    from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
    from mod_extraction_tpu_torch.ops import fx_kernels as fxk
    from mod_extraction_tpu_torch.ops.fx import phaser_coefficients
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
    from mod_extraction_tpu_torch.train.render import (
        RenderConfig,
        flanger_delay_samples,
        phaser_params,
    )
    from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    rng = np.random.default_rng(0)

    # -- phase 1: build
    t0 = time.perf_counter()
    print(f"[build] {fxk.build(verbose=True).name} in {time.perf_counter() - t0:.1f} s")

    # -- phases 2-3: kernels against their plain versions, small regimes
    check_kernels_small(fxk, rng)

    # -- phases 4-5: the main path, counted
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
    print(f"[main path] launches={launches}")

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
    print(f"[train] batch={BATCH} steps={N_TRAIN_STEPS} mean_step_ms={step_mean * 1e3:.3f} "
          f"min_step_ms={min(step_s) * 1e3:.3f} audio_s_per_s={audio_s / step_mean:.2f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # -- phase 6: the whole path against the CPU (float32, plain kernels)
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

    # -- phase 7: each kernel at the main path's shapes (the last train batch)
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
        # name, wrapper, plain, args, replaces, bytes, f32 ops per sample
        ("flanger_delay_line", fxk.flanger, fxk.flanger_plain, fl_args,
         "mod_extraction_tpu/ops/pallas_fx.py:45", 4 * (3 * n_lanes * t_len + 3 * n_lanes), 16),
        ("phaser_allpass", fxk.phaser, fxk.phaser_plain, ph_args,
         "mod_extraction_tpu/ops/pallas_fx.py:156", 4 * (3 * n_lanes * t_len + 2 * n_lanes), 43),
    ]
    rows = []
    for name, kern, plain, args, replaces, n_bytes, ops_per in specs:
        key = "flanger" if kern is fxk.flanger else "phaser"
        out = kern(*args)
        ms = cuda_ms(lambda: kern(*args), 5)
        ref_out = []
        plain_ms = cuda_ms(lambda: ref_out.append(plain(*args)), 1)
        err = max_abs(out, ref_out[0])
        print(f"[{name} n={n_lanes} T={t_len}] max_abs_err={err:.3e} ms={ms:.3f} plain_ms={plain_ms:.1f}")
        if not err <= KERNEL_TOL:
            fail(f"{name} at the main-path shapes disagrees with its plain version: {err}")
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        t_ops = ops_per * n_lanes * t_len / F32_OPS_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": "mod_extraction_tpu_torch/csrc/fx.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        })
    # -- phase 8: where one full-width train step spends the card's time
    profile_train_step(task, train_batches[1])

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
