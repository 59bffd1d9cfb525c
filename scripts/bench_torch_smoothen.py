"""Time the stage-1 extractor train step on the GPU with three forms of the
LFO smoothing in its loss (`lfo_task._postprocess`), the rest of the step
unchanged:

* `port`: `ops/corners.py::smoothen` as shipped, the forward through
  `blocked_cumsum` (XLA's summation order) and a hand-written backward;
* `blocked_autograd`: the same forward with autograd through every op of
  `blocked_cumsum`;
* `torch_cumsum`: the forward through one `torch.cumsum`, autograd backward.

The variants take turns, step by step, in the order ABC CBA ..., each step
timed on the host clock fenced with `torch.cuda.synchronize()` after warm-up
steps.  Also times `smoothen` alone (forward + backward on (32, 345)) and
checks that the port's smoothing gives the same bits on the card as on the
CPU and the same gradient as autograd.

    python3 scripts/bench_torch_smoothen.py [--rounds 8] [--batch 32]

Needs a CUDA device; imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_interwoven_batch  # noqa: E402
from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn  # noqa: E402
from mod_extraction_tpu_torch.ops import corners  # noqa: E402
from mod_extraction_tpu_torch.train import lfo_task  # noqa: E402
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask  # noqa: E402
from mod_extraction_tpu_torch.train.render import RenderConfig  # noqa: E402

R7 = ROOT / "models" / "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
SR, N_SAMPLES = 44100.0, 88200
PAPER = dict(
    in_ch=2, n_samples=N_SAMPLES, sr=SR, n_fft=1024, hop_len=256, n_mels=256,
    kernel_size=(5, 13), out_channels=(64,) * 6,
    temp_dilations=(1, 1, 2, 4, 8, 16), pool_size=(2, 1),
    freq_mask_amount=0.25, time_mask_amount=0.25,
)
LOSSES = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}


def _window_diff(cs: torch.Tensor, w: int) -> torch.Tensor:
    cs = F.pad(cs, (1, 0))
    return (cs[..., w:] - cs[..., :-w]) / w


VARIANTS = {
    "port": corners.smoothen,
    "blocked_autograd": lambda x, w: _window_diff(corners.blocked_cumsum(x), w),
    "torch_cumsum": lambda x, w: _window_diff(torch.cumsum(x, dim=-1), w),
}


def host_ms(fn, reps: int) -> float:
    """Mean host-clock ms per call, fenced at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    # -- the port's smoothing: same bits on the card as on the CPU, and its
    #    backward against autograd through an unfold-mean
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 1, (args.batch, 345)).astype(np.float32))
    same = torch.equal(corners.smoothen(x.cuda(), 8).cpu(), corners.smoothen(x, 8))
    xg = x.cuda().requires_grad_()
    g = torch.randn(args.batch, 338, device="cuda")
    (got,) = torch.autograd.grad(corners.smoothen(xg, 8), xg, g)
    (ref,) = torch.autograd.grad(xg.unfold(-1, 8, 1).mean(-1), xg, g)
    grad_err = (got - ref).abs().max().item()
    print(f"[smoothen card vs CPU] bit_exact={same} grad_max_abs_vs_autograd={grad_err:.3e}")
    if not (same and grad_err <= 1e-6):
        return 1

    # -- smoothen alone, forward + backward at the stage-1 shape
    for name, fn in VARIANTS.items():
        def fwd_bwd(fn=fn):
            fn(xg, 8).backward(g)

        fwd_bwd()
        print(f"[smoothen fwd+bwd ({args.batch}, 345) {name}] host_ms={host_ms(fwd_bwd, 200):.4f}")

    # -- the stage-1 train step with each form, taking turns
    d = 1764  # the interwoven delay line
    cfg = RenderConfig(sr=SR, n_samples=N_SAMPLES, effects=(2, 3), max_delay_samples=d)
    model = load_spectral_2dcnn(str(R7), device="cuda", **PAPER, compute_dtype="bfloat16")
    task = LFOExtractionTask(model, cfg, loss_dict=LOSSES, device="cuda", seed=0)
    batches = [batch_to_torch(make_interwoven_batch(s, args.batch, N_SAMPLES, SR)) for s in range(4)]
    names = list(VARIANTS)
    step_ms = {n: [] for n in names}
    for r in range(args.rounds + 1):
        for name in names if r % 2 == 0 else names[::-1]:
            lfo_task.smoothen = VARIANTS[name]
            dt = host_ms(lambda: task.train_step(batches[r % len(batches)]), 1)
            if r > 0:  # round 0 warms up every variant
                step_ms[name].append(dt)
    lfo_task.smoothen = corners.smoothen
    for name in names:
        v = step_ms[name]
        print(f"[stage 1 train_step b={args.batch} {name}] steps={len(v)} mean_ms={np.mean(v):.3f} "
              f"median_ms={np.median(v):.3f} min_ms={min(v):.3f} all={[round(t, 3) for t in v]}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
