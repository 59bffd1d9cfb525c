"""Check and time the LSTM kernels K3 (no-gradient forward), K4 (training
forward) and K5 (backward) of `ops/lstm_kernels.py` on the GPU, alone: each
against its plain PyTorch version at small shapes on both kernel paths (the
register-resident kernels at H 16 / 64, the generic ones at H 48 / 160; the
checks are `chip_smoke.py`'s), then at the TBPTT path's shape (B 32, T 1024,
H 64) their times in turns with the generic kernels at the same width and
with one `torch.nn.LSTM` call (cuDNN; no fc head), K5's time by kernel, the
walks' cycles a step, and K3 over an 86016-step clip with its drift from a
float64 walk.  A kernel change can be judged in under a minute.

    python3 scripts/bench_torch_lstm.py [--batch 32] [--steps 1024] [--hidden 64] [--long 86016] [--skip-checks]

`--hidden 160` times the generic kernels at the width of the shipped chorus
model; `--long 0` leaves the long walk out.

Needs a CUDA device; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from mod_extraction_tpu_torch.ops import lstm_kernels as lk  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--steps", type=int, default=cs.TBPTT_CHUNK)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--long", type=int, default=86016, help="steps of the long K3 walk (0: skip)")
    ap.add_argument("--skip-checks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    lk.build(verbose=True)
    rng = np.random.default_rng(0)
    b, t, hid = args.batch, args.steps, args.hidden

    if not args.skip_checks:
        for h in (64, 160, 16, 48):
            cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, 5, 300, h), h, f"LSTM B=5 T=300 H={h}")
            cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, 1, 1, h), h + 1, f"LSTM B=1 T=1 H={h}")
        cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, b, t, hid), 7, f"LSTM B={b} T={t} H={hid}")

    a = cs.lstm_inputs(rng, b, t, hid)
    fwd_args = tuple(a.values())
    _, _, _, hs, cs_, gates = lk.lstm_train_forward(*fwd_args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=gen)
    zeros = torch.zeros(b, hid, device="cuda")
    bwd_args = (a["seq"], hs, cs_, gates, a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, zeros, zeros)

    lib = torch.nn.LSTM(a["seq"].shape[1], hid).to("cuda")
    with torch.no_grad():
        lib.weight_ih_l0.copy_(a["w_ih"].T)
        lib.weight_hh_l0.copy_(a["w_hh"].T)
        lib.bias_ih_l0.copy_(a["b"])
        lib.bias_hh_l0.zero_()
    state = (a["h0"][None].contiguous(), a["c0"][None].contiguous())
    seq_tbc = a["seq"].permute(2, 0, 1).contiguous()
    seq_grad = seq_tbc.clone().requires_grad_()

    def lib_fwd():
        with torch.no_grad():
            lib(seq_tbc, state)

    def lib_fwd_bwd():
        out, _ = lib(seq_grad, state)
        out.sum().backward()

    def timed(fast: bool):
        lk.ALLOW_FAST = fast
        try:
            return (cs.cuda_ms_median(lambda: lk.lstm_forward(*fwd_args)),
                    cs.cuda_ms_median(lambda: lk.lstm_train_forward(*fwd_args)),
                    cs.cuda_ms_median(lambda: lk.lstm_backward(*bwd_args)))
        finally:
            lk.ALLOW_FAST = True

    # in turns: kernels, generic kernels, library, kernels again
    first = timed(True)
    generic = timed(False) if lk.fast_path(hid) else None
    lib_f, lib_fb = cs.cuda_ms_median(lib_fwd), cs.cuda_ms_median(lib_fwd_bwd)
    again = timed(True)
    shape = f"B={b} T={t} H={hid}"
    path = "fast" if lk.fast_path(hid) else "generic"
    for name, i in (("K3", 0), ("K4", 1), ("K5", 2)):
        line = f"[{name} {shape}, {path} kernels] ms={first[i]:.4f} (again {again[i]:.4f})"
        if generic is not None:
            line += f"  generic kernels at the same width: {generic[i]:.4f}"
        print(line)
    k4, k5 = min(first[1], again[1]), min(first[2], again[2])
    print(f"[torch.nn.LSTM {shape}] forward {lib_f:.4f}  forward + backward {lib_fb:.4f}  "
          f"(K4 + K5 = {k4 + k5:.4f})")
    for ops_bytes, label in (
        (cs.lstm_ops_bytes(b, t, hid, 2, 1), "K3"),
        (cs.lstm_ops_bytes(b, t, hid, 2, 1, save_states=True), "K4"),
        (cs.lstm_ops_bytes(b, t, hid, 2, 1, backward=True), "K5"),
    ):
        n_ops, n_bytes = ops_bytes
        print(f"[{label} bound] operations {n_ops / cs.F32_OPS_S * 1e3:.4f} ms  bytes {n_bytes / cs.HBM_BYTES_S * 1e3:.4f} ms")

    by_kernel = cs.device_ms_by_kernel(lambda: lk.lstm_backward(*bwd_args), 10)
    walk_ms = sum(v for k, v in by_kernel.items() if "bwd_walk" in k)
    mhz = cs.sm_clock_mhz(lambda: lk.lstm_train_forward(*fwd_args))
    print("[K5 by kernel, ms a launch] " + "  ".join(
        f"{k}={v:.4f}" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"[cycles a step at {mhz:.0f} MHz] K4 walk {k4 / t * mhz * 1e3:.0f}  K5 walk {walk_ms / t * mhz * 1e3:.0f}")

    if args.long:
        la = cs.lstm_inputs(rng, b, args.long, hid)
        la.update({k: a[k] for k in ("w_ih", "w_hh", "b", "fc_k", "fc_b")})
        long_args = tuple(la.values())
        ms = cs.cuda_ms(lambda: lk.lstm_forward(*long_args), 3)
        drift = cs.long_walk_drift(lk, long_args)
        lk.ALLOW_FAST = False
        try:
            ms_g = cs.cuda_ms(lambda: lk.lstm_forward(*long_args), 2)
            drift_g = cs.long_walk_drift(lk, long_args)
        finally:
            lk.ALLOW_FAST = True
        print(f"[K3 B={b} T={args.long} H={hid}] ms={ms:.3f} (state, y) max-abs from a float64 CPU walk of "
              f"row 0: {drift[0]:.3e}, {drift[1]:.3e};  generic kernels: ms={ms_g:.3f} drift {drift_g[0]:.3e}, {drift_g[1]:.3e}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
