"""Check and time K2 (the phaser cascade, `ops/fx_kernels.py::phaser`) on
the GPU at the stage-1 shape (32 rows of 88200 samples, 6 stages), across
the chunk lengths its affine scan is built for, beside the sequential walk
(chunk 0) in the same run.  Inputs are the scan's hardest: feedback 0.7 and
g swept over [0.001, 32].  For each chunk length: the time (CUDA events,
median of 5 x 20 calls), the device time of each of its kernels
(torch.profiler), max|P_c|, max|z_c|, the entry states' distance from a
float64 walk, and the error against `phaser_plain` (1e-4 max-abs, K2's
tolerance).  Also prints ptxas's registers and spills of `csrc/fx.cu`.

    python3 scripts/bench_torch_fx.py [--stages 6] [--no-plain]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=6)
    ap.add_argument("--no-plain", action="store_true", help="skip the plain version (30 s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    print("[ptxas, csrc/fx.cu]")
    for line in cuda_build.ptxas_report("fx.cu"):
        print(f"  {line}")
    rng = np.random.default_rng(0)
    ph = cs.phaser_extremes(rng, cs.BATCH, cs.N_SAMPLES)
    n = args.stages
    ref = None if args.no_plain else fxk.phaser_plain(*ph, n)
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
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
