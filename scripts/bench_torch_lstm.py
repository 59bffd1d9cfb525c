"""Check and time the LSTM kernels K3 (no-gradient forward), K4 (training
forward) and K5 (backward) of `ops/lstm_kernels.py` on the GPU, alone: each
against its plain PyTorch version at small shapes on every kernel path (the
register-resident kernels at H 16 / 64, the cluster forward at H 160, the
generic kernels at H 48 and at H 160 with `ALLOW_FAST` off; the checks are
`chip_smoke.py`'s), then at the TBPTT
path's shape (B 32, T 1024, H 64) their times in turns with the generic
kernels at the same width and with one `torch.nn.LSTM` call (cuDNN; no fc
head), K5's time by kernel, the walks' cycles a step, and K3 over an
86016-step clip with its drift from a float64 walk.  A kernel change can be
judged in under a minute.

    python3 scripts/bench_torch_lstm.py [--batch 32] [--steps 1024] [--hidden 64] [--long 86016] [--skip-checks]

`--hidden 160` checks and times the cluster kernels at the width of the
shipped chorus model in each of their cluster shapes
(`lstm_kernels.CLUSTER_SHAPES`, each launched at every batch, the one
`cluster_shape` picks timed twice): the forward (K3, K4) beside the generic
kernels and the library at the TBPTT shape and at the serving shapes (2,
128 / 512 / 2048, queued: calls issued behind a spin, so that the events
time the card), and K5 with its cluster walk at B 2, 3 and the TBPTT batch
(T 1024) beside the generic walk (`ALLOW_FAST` off) and the library's
forward + backward and backward alone, with the walk's device time and
cycles a step, and at the TBPTT batch K5's weight-gradient partial sums
beside one `torch.mm` of the same operands (float32, TF32 off); it also
prints ptxas's registers and spills of the cluster kernels and how many
clusters of each shape the card holds at once.
`--long 0` leaves the long walk out.

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
from mod_extraction_tpu_torch.ops import cuda_build  # noqa: E402
from mod_extraction_tpu_torch.ops import lstm_kernels as lk  # noqa: E402
from mod_extraction_tpu_torch.utils.device import set_float32_numerics  # noqa: E402
from mod_extraction_tpu_torch.utils.timing import cuda_ms_queued  # noqa: E402

SERVE_BUFFERS = (128, 512, 2048)


def variant(fast: bool):
    """Set the benchmark switch: `fast` False sends every width to the
    generic kernels."""
    lk.ALLOW_FAST = fast


def launch(args: tuple, shape: tuple | None, save: bool):
    """K4 (`save`) or K3 on the cluster forward of `shape` (CTAs, rows), or
    on the generic kernels with `shape` None."""
    plan = ("cluster", *shape) if shape else ("generic", 1, 1)
    return lk._forward_launch("lstm_train_forward" if save else "lstm_forward", *args, save, plan=plan)


def queued_ms(fn) -> float:
    """The card's ms a call of `fn`, 5-50 calls queued behind a spin."""
    call_ms = cs.cuda_ms_median(fn, reps=5, batches=3)
    reps = max(5, min(50, int(200 / max(call_ms, 1e-3))))
    return cuda_ms_queued(fn, reps, spin_ms=2 * reps * call_ms)


def cluster_report(rng, b: int, t: int) -> None:
    """ptxas's registers and spills of the cluster kernels, the clusters the
    card holds at once, and the cluster forward checked in each cluster
    shape against the plain version at the small shapes, at the path's shape
    and with in_dim 3 (the kernel that reads in_dim at run time)."""
    for line in cuda_build.ptxas_report("lstm.cu"):
        if "cluster" in line:
            print(f"[ptxas] {line}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in lk.CLUSTER_SHAPES:
        occ = {save: lk.cluster_occupancy(*shape, save) for save in (False, True)}
        picked = [bb for bb in range(1, 257) if lk.cluster_shape(bb, n_sms) == shape]
        print(f"[cluster occupancy, {shape[0]} CTAs x {shape[1]} rows] at most {occ[False]} clusters (K3) / "
              f"{occ[True]} (K4) / {lk.backward_cluster_occupancy(*shape)} (K5's walk) at once on {n_sms} SMs; "
              f"the rule picks it for B {picked[0]}-{picked[-1]}")
    cases = [(5, 300, 2), (1, 1, 2), (2, 2048, 2), (b, t, 2), (3, 130, 3), (31, 65, 3)]
    inputs = [cs.lstm_inputs(rng, bb, tt, 160, in_dim=i) for bb, tt, i in cases]
    for shape in lk.CLUSTER_SHAPES:
        for (bb, tt, i), a in zip(cases, inputs):
            args = tuple(a.values())
            ref = lk.lstm_forward_plain(*args, save_states=True)
            err = max(max(cs.max_abs(x, y) for x, y in zip(launch(args, shape, False), ref[:3])),
                      max(cs.max_abs(x, y) for x, y in zip(launch(args, shape, True), ref)))
            print(f"[LSTM B={bb} T={tt} H=160 in_dim={i}, cluster {shape}] K3/K4 max_abs={err:.3e}")
            if not err <= cs.KERNEL_TOL:
                cs.fail(f"the cluster forward {shape} at B={bb} T={tt} in_dim={i} disagrees with its "
                        f"plain version: {err}")
    # K5's cluster walk in each shape: every output and the walk's gate
    # cotangents within 5e-4 of their largest magnitude, two launches the same bits
    for shape in lk.CLUSTER_SHAPES:
        for (bb, tt, i), a in zip(cases, inputs):
            bargs = backward_args(a)
            got = lk._backward_launch(*bargs, plan=("cluster", *shape))
            again = lk._backward_launch(*bargs, plan=("cluster", *shape))
            err = max(cs.rel_err(x, y) for x, y in zip(got, lk.lstm_backward_plain(*bargs, with_dgates=True)))
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            print(f"[LSTM B={bb} T={tt} H=160 in_dim={i}, cluster {shape}] K5 max_rel={err:.3e} "
                  f"relaunch bit-identical: {same}")
            if not (err <= cs.GRAD_REL and same):
                cs.fail(f"K5's cluster walk {shape} at B={bb} T={tt} in_dim={i}: {err}, same bits {same}")


def backward_args(a: dict, seed: int = 0) -> tuple:
    """K5's arguments for K3/K4 inputs `a`: K4's saved tensors and random
    cotangents."""
    b, _, t = a["seq"].shape
    hid = a["w_hh"].shape[0]
    _, _, _, hs, cs_, gates = lk.lstm_train_forward(**a)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=gen)
    dhn, dcn = (torch.randn(b, hid, device="cuda", generator=gen) for _ in range(2))
    return (a["seq"], hs, cs_, gates, a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, dhn, dcn)


def time_cluster_backward(rng, t: int, batches: tuple) -> None:
    """K5 at H 160, T `t`, for each batch: the cluster walk in each shape
    (the rule's twice), the generic walk and `torch.nn.LSTM`'s forward +
    backward and backward alone, in turns (medians of 5 x 20 calls); then
    the rule's walk kernel by device time and its cycles a step beside the
    multiply-adds' floor."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = None
    for bb in batches:
        a = cs.lstm_inputs(rng, bb, t, 160)
        bargs = backward_args(a)
        lib = cs.library_lstm(a["w_ih"], a["w_hh"], a["b"])
        state = (a["h0"][None].contiguous(), a["c0"][None].contiguous())
        seq_grad = a["seq"].permute(2, 0, 1).contiguous().requires_grad_()

        def lib_fwd_bwd():
            out, _ = lib(seq_grad, state)
            out.sum().backward()

        kept, _ = lib(seq_grad, state)
        leaves, ones = [seq_grad, *lib.parameters()], torch.ones_like(kept)

        def lib_bwd():
            torch.autograd.grad(kept, leaves, ones, retain_graph=True)

        rule = lk.cluster_shape(bb, n_sms)
        turns = [(f"{rule} (rule)", ("cluster", *rule))] + \
            [(str(sh), ("cluster", *sh)) for sh in lk.CLUSTER_SHAPES if sh != rule] + \
            [("generic", ("generic", 1, 1)), (f"{rule} (rule) again", ("cluster", *rule))]
        ms = {name: cs.cuda_ms_median(lambda: lk._backward_launch(*bargs, plan=plan)) for name, plan in turns}
        lib_fb, lib_b = cs.cuda_ms_median(lib_fwd_bwd), cs.cuda_ms_median(lib_bwd)
        by_kernel = cs.device_ms_per_launch(lambda: lk._backward_launch(*bargs, plan=("cluster", *rule)), 10)
        walk = sum(v for k, v in by_kernel.items() if "bwd_cluster" in k)
        if mhz is None:
            mhz = cs.sm_clock_mhz(lambda: lk._backward_launch(*bargs, plan=("cluster", *rule)), 300)
        best = min(ms[turns[0][0]], ms[turns[-1][0]])
        print(f"[K5 H 160 B={bb} T={t}, medians of 5 x 20, ms] " + "; ".join(f"{k}: {v:.4f}" for k, v in ms.items())
              + f"; torch.nn.LSTM forward + backward {lib_fb:.4f}, backward alone {lib_b:.4f}; K5 / library "
              f"backward {best / lib_b:.3f}")
        print(f"[K5 H 160 B={bb} T={t}, {rule} by kernel, ms a launch] " + "  ".join(
            f"{k}={v:.4f}" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1]))
            + f"; walk {walk / t * mhz * 1e3:.0f} cycles a step at {mhz:.0f} MHz, the multiply-adds' floor "
            f"{cs.h160_fma_cycles(*rule)}")
        if bb == batches[-1]:
            time_wgrad_partials(by_kernel, bb, t)


def time_wgrad_partials(by_kernel: dict, b: int, t: int, hid: int = 160, in_dim: int = 2) -> None:
    """K5's weight-gradient partial sums (`lstm_wgrad_partial_kernel` +
    `lstm_wgrad_final_kernel`, device ms a launch from `by_kernel`) beside
    their library call: one `torch.mm` in float32 with TF32 off of the same
    operands, [x_t, h_{t-1}, 1] (B*T, H + in + 1) transposed times the
    gate cotangents (B*T, 4H), by device time and by CUDA events back to
    back; and the operations' bound."""
    set_float32_numerics()
    parts = {k: v for k, v in by_kernel.items() if "wgrad_partial" in k or "wgrad_final" in k}
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(b * t, hid + in_dim + 1, device="cuda", generator=gen)
    g = torch.randn(b * t, 4 * hid, device="cuda", generator=gen)

    def mm():
        return torch.mm(a.t(), g)

    lib_device = cs.device_ms_per_launch(mm, 10)
    lib_events = cs.cuda_ms_median(mm)
    n_ops = 2 * b * t * (hid + in_dim + 1) * 4 * hid
    kernel = sum(parts.values())
    lib = sum(lib_device.values())
    print(f"[K5 H {hid} B={b} T={t}, weight-gradient partial sums, ms a launch] "
          + "  ".join(f"{k}={v:.4f}" for k, v in parts.items())
          + f"; together {kernel:.4f}; torch.mm (float32, TF32 off) device {lib:.4f} ("
          + ", ".join(f"{k}={v:.4f}" for k, v in lib_device.items())
          + f"), CUDA events {lib_events:.4f}; kernel / torch.mm {kernel / lib:.3f}; bound "
          f"{n_ops / cs.F32_OPS_S * 1e3:.4f} ({n_ops / 1e9:.3f} GFLOP at {cs.F32_OPS_S / 1e12:.0f} TFLOP/s)")


def time_cluster(rng, b: int, t: int) -> None:
    """K3 and K4 at H 160: the cluster forward in each shape (the rule's
    twice), the generic kernels and `torch.nn.LSTM`, in turns; at (b, t)
    back to back and at the serving shapes queued."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bb, tt, timer in [(b, t, cs.cuda_ms_median)] + [(2, s, queued_ms) for s in SERVE_BUFFERS]:
        a = cs.lstm_inputs(rng, bb, tt, 160)
        args = tuple(a.values())
        lib = cs.library_lstm(a["w_ih"], a["w_hh"], a["b"])
        state = (a["h0"][None].contiguous(), a["c0"][None].contiguous())
        seq_tbc = a["seq"].permute(2, 0, 1).contiguous()

        def lib_fwd():
            with torch.no_grad():
                lib(seq_tbc, state)

        rule = lk.cluster_shape(bb, n_sms)
        turns = [(f"{rule} (rule)", rule)] + [(str(sh), sh) for sh in lk.CLUSTER_SHAPES if sh != rule] + \
            [("generic", None), (f"{rule} (rule) again", rule)]
        rows = {name: (timer(lambda: launch(args, shape, False)), timer(lambda: launch(args, shape, True)))
                for name, shape in turns}
        lib_ms = timer(lib_fwd)
        how = "back to back, medians of 5 x 20" if timer is cs.cuda_ms_median else "queued"
        best = min(rows[turns[0][0]][0], rows[turns[-1][0]][0])
        print(f"[H 160 B={bb} T={tt}, {how}, ms] " + "; ".join(
            f"{name}: K3 {k3:.4f} K4 {k4:.4f}" for name, (k3, k4) in rows.items())
            + f"; torch.nn.LSTM forward {lib_ms:.4f}; K3 / library {best / lib_ms:.3f}")


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
    lk.build()
    rng = np.random.default_rng(0)
    b, t, hid = args.batch, args.steps, args.hidden
    cluster = hid == lk.CLUSTER_HIDDEN

    if not args.skip_checks:
        for h in (64, 160, 16, 48):
            cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, 5, 300, h), h, f"LSTM B=5 T=300 H={h}")
            cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, 1, 1, h), h + 1, f"LSTM B=1 T=1 H={h}")
        cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, b, t, hid), 7, f"LSTM B={b} T={t} H={hid}")
        variant(False)
        try:
            cs.check_lstm_kernels(lk, cs.lstm_inputs(rng, 5, 300, 160), 8, "LSTM B=5 T=300 H=160")
        finally:
            variant(True)
    if cluster:
        cluster_report(rng, b, t)
        time_cluster(rng, b, t)
        time_cluster_backward(rng, t, (2, 3, b))

    a = cs.lstm_inputs(rng, b, t, hid)
    fwd_args = tuple(a.values())
    _, _, _, hs, cs_, gates = lk.lstm_train_forward(*fwd_args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=gen)
    zeros = torch.zeros(b, hid, device="cuda")
    bwd_args = (a["seq"], hs, cs_, gates, a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, zeros, zeros)

    lib = cs.library_lstm(a["w_ih"], a["w_hh"], a["b"])
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
        variant(fast)
        try:
            return (cs.cuda_ms_median(lambda: lk.lstm_forward(*fwd_args)),
                    cs.cuda_ms_median(lambda: lk.lstm_train_forward(*fwd_args)),
                    cs.cuda_ms_median(lambda: lk.lstm_backward(*bwd_args)))
        finally:
            variant(True)

    # in turns: kernels, generic kernels, library, kernels again
    first = timed(True)
    path = lk.forward_kernel(hid, b)[0]
    generic = timed(False) if path != "generic" else None
    lib_f, lib_fb = cs.cuda_ms_median(lib_fwd), cs.cuda_ms_median(lib_fwd_bwd)
    again = timed(True)
    shape = f"B={b} T={t} H={hid}"
    for name, i in (("K3", 0), ("K4", 1), ("K5", 2)):
        line = f"[{name} {shape}, {path if i < 2 else lk.backward_kernel(hid, b)[0]} kernel] " \
               f"ms={first[i]:.4f} (again {again[i]:.4f})"
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

    by_kernel = cs.device_ms_per_launch(lambda: lk.lstm_backward(*bwd_args), 10)
    walk_ms = sum(v for k, v in by_kernel.items() if "bwd_walk" in k or "bwd_cluster" in k)
    mhz = cs.sm_clock_mhz(lambda: lk.lstm_train_forward(*fwd_args))
    print("[K5 by kernel, ms a launch] " + "  ".join(
        f"{k}={v:.4f}" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    k3 = min(first[0], again[0])
    print(f"[cycles a step at {mhz:.0f} MHz] K3 walk {k3 / t * mhz * 1e3:.0f}  K4 walk {k4 / t * mhz * 1e3:.0f}  "
          f"K5 walk {walk_ms / t * mhz * 1e3:.0f}")

    if args.long:
        la = cs.lstm_inputs(rng, b, args.long, hid)
        la.update({k: a[k] for k in ("w_ih", "w_hh", "b", "fc_k", "fc_b")})
        long_args = tuple(la.values())
        ms = cs.cuda_ms(lambda: lk.lstm_forward(*long_args), 3)
        drift = cs.long_walk_drift(lk, long_args)
        variant(False)
        try:
            ms_g = cs.cuda_ms(lambda: lk.lstm_forward(*long_args), 2)
            drift_g = cs.long_walk_drift(lk, long_args)
        finally:
            variant(True)
        lib_l = cs.library_lstm(la["w_ih"], la["w_hh"], la["b"])
        long_tbc = la["seq"].permute(2, 0, 1).contiguous()
        long_state = (la["h0"][None].contiguous(), la["c0"][None].contiguous())

        def lib_long():
            with torch.no_grad():
                lib_l(long_tbc, long_state)

        try:
            lib_long()
            lib_ms = f"{cs.cuda_ms(lib_long, 2):.3f}"
        except RuntimeError as e:  # a yardstick only: report what cuDNN refused
            lib_ms = f"refused ({str(e).splitlines()[0][:80]})"
        print(f"[K3 B={b} T={args.long} H={hid}, {path} kernel] ms={ms:.3f} (state, y) max-abs from a float64 "
              f"CPU walk of row 0: {drift[0]:.3e}, {drift[1]:.3e};  generic kernels: ms={ms_g:.3f} drift "
              f"{drift_g[0]:.3e}, {drift_g[1]:.3e};  torch.nn.LSTM forward {lib_ms}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
