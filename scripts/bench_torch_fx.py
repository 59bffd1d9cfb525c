"""Check and time the render kernels of `csrc/fx.cu` on the GPU at the
stage-1 shape (32 rows of 88200 samples).  Prints ptxas's registers and
spills of every kernel in the file first.

K1 (the flanger/chorus delay line, `ops/fx_kernels.py::flanger`), on the
batches `chip_smoke.py` runs: stage 1's timed batch (interwoven seed 4, d
1764) and stage 2's (flanger seed 2, d 485).  For each: the stepped kernel
against the sequential walk (`walk=True`) bit for bit and against
`flanger_plain` (1e-4 max-abs, K1's tolerance), its per-row step counts
against `fx_kernels.flanger_step_counts`, the times its walker found the
next chunk not yet staged, then the two kernels timed in turns (walk,
steps, steps, walk), the worst row's steps and the cycles a step at the
SM clock under load.  Then the stepped kernel with every step fixed at 32,
16, 8 and 1 samples (`fixed_step`; wrong output): if staging set the pace,
the fixed-32 time would sit above 2757 steps' worth of walker time.

K2 (the phaser cascade, `ops/fx_kernels.py::phaser`, 6 stages) across the
chunk lengths its affine scan is built for, beside the sequential walk
(chunk 0).  Inputs are the scan's hardest: feedback 0.7 and g swept over
[0.001, 32].  For each chunk length: the time, the device time of each of
its kernels (torch.profiler), max|P_c|, max|z_c|, the entry states'
distance from a float64 walk, and the error against `phaser_plain` (1e-4).

Times are CUDA-event medians of 5 x 20 calls after a warm-up.

    python3 scripts/bench_torch_fx.py [--stages 6] [--no-plain] [--only k1|k2]

`--no-plain` skips the plain versions (about 12 s a K1 batch, 30 s for K2).
Needs a CUDA device; imports torch, numpy and the port only.
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
from mod_extraction_tpu_torch.ops import fx_kernels as fxk  # noqa: E402

CHUNKS = (0, 32, 64, 128, 256, 512)
FIXED_STEPS = (32, 16, 8, 1)


def bench_k1(no_plain: bool) -> None:
    for label, args in cs.k1_path_batches():
        d = args[-1]
        n_rows, t_len = args[0].shape[0] * args[0].shape[1], args[0].shape[2]
        res = cs.check_k1_path(fxk, args, label, plain=not no_plain)
        print(f"[K1 {label}] steps worst row {res['steps_max']} median {res['steps_median']:.0f} "
              f"total {res['steps_total']} (walk {t_len} a row)  walker waits {res['waits']}  "
              f"ms={res['ms']:.4f} walk_ms={res['walk_ms']:.4f} ({res['walk_ms'] / res['ms']:.1f}x)  "
              f"{res['cycles_per_step']:.1f} cycles a step at {res['mhz']:.0f} MHz  "
              f"bound_ms={res['bound_ms']:.4f} (bytes)")
        for fixed in FIXED_STEPS:
            if fixed > d:
                continue
            stats = fxk.flanger(*args, step_counts=True, fixed_step=fixed)[1]
            ms = cs.cuda_ms_median(lambda: fxk.flanger(*args, fixed_step=fixed))
            print(f"    [fixed step {fixed}] {stats[:, 0].max().item()} steps a row  ms={ms:.4f}  "
                  f"{ms * 1e-3 * res['mhz'] * 1e6 / stats[:, 0].max().item():.1f} cycles a step  "
                  f"walker waits {stats[:, 1].sum().item()} over {n_rows} rows")


def bench_k2(n: int, no_plain: bool) -> None:
    rng = np.random.default_rng(0)
    ph = cs.phaser_extremes(rng, cs.BATCH, cs.N_SAMPLES)
    ref = None if no_plain else fxk.phaser_plain(*ph, n)
    z64 = cs.walk64_chunk_states(ph[0], ph[1], ph[2], n, 32)  # every chunk length's boundaries
    n_bytes = 4 * (3 * cs.BATCH * cs.N_SAMPLES + 2 * cs.BATCH)
    print(f"[K2 B={cs.BATCH} T={cs.N_SAMPLES} n={n}, fb 0.7, g 0.001-32] bound_ms="
          f"{n_bytes / cs.HBM_BYTES_S * 1e3:.4f} (bytes)")
    for chunk in CHUNKS if n == 6 else (0, fxk.PHASER_CHUNK):
        def kern():
            return fxk.phaser(*ph, n, chunk=chunk)

        out = kern()
        ms = cs.cuda_ms_median(kern)
        by_kernel = cs.device_ms_by_kernel(kern, 10)
        err = "not compared" if ref is None else f"{cs.max_abs(out, ref):.3e}"
        line = f"[chunk {chunk or 'walk'}] ms={ms:.4f} max_abs_err={err}"
        if chunk:
            max_p, max_z, z_err = cs.phaser_scan_numerics(fxk, ph, n, chunk, z64[:, :: chunk // 32])
            line += f" max|P_c|={max_p:.4f} max|z_c|={max_z:.4f} z_c vs float64 walk {z_err:.3e}"
        print(line)
        print("    " + "  ".join(f"{k}={v:.4f}" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--no-plain", action="store_true", help="skip the plain versions")
    ap.add_argument("--only", choices=("k1", "k2"), help="one kernel's section")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    print("[ptxas, csrc/fx.cu]")
    for line in cuda_build.ptxas_report("fx.cu"):
        print(f"  {line}")
    if args.only != "k2":
        bench_k1(args.no_plain)
    if args.only != "k1":
        bench_k2(args.stages, args.no_plain)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
