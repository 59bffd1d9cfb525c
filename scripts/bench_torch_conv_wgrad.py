"""Check and time K6 (the hand-written conv weight-gradient kernel,
`ops/conv_kernels.py::conv2d_wgrad_tapcat`) on the GPU, per trunk layer of
the paper config: against its plain PyTorch version (1e-3 of the largest
|dW|) and the float32 reference (2e-2), bit-identical across two launches,
and its time beside the bound (operations over the card's dense bf16 tensor
rate, bytes over its memory rate) and beside one library call that computes
the same function (`aten.convolution_backward`, weight gradient only, bf16,
dilated layers in the time-phase form).  K6 is timed as the trunk's default
conv on the card calls it (`conv2d_same_phases_kernel_wgrad`): the input
as it is, the cotangent in the dilated layers' time-phase form, which K6's
channels-last copy reads; the result is held bit for bit against K6 on the
unphased cotangent.  Prints ptxas's registers and spills of
`csrc/conv_wgrad.cu` first.  The checks and the counting are
`chip_smoke.py`'s; this script runs them alone, kernel first and last, so a
kernel change can be judged in half a minute.

    python3 scripts/bench_torch_conv_wgrad.py [--batch 32] [--reps 10]

(`--batch 99` is the shipped stage-1 batch.)

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
from mod_extraction_tpu_torch.ops import conv_kernels as ck  # noqa: E402
from mod_extraction_tpu_torch.ops import cuda_build  # noqa: E402
from mod_extraction_tpu_torch.ops.conv import time_phases  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[ptxas, csrc/conv_wgrad.cu]")
    for line in cuda_build.ptxas_report("conv_wgrad.cu"):
        print(f"  {line}")
    rng = np.random.default_rng(0)

    def rand(*shape):
        a = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        return torch.as_tensor(a, device="cuda").to(torch.bfloat16)

    cs.check_wgrad(ck, rand(2, 16, 6, 57), rand(2, 8, 6, 57), 4, "small B=2 ci=16 co=8 F=6 T=57 dil=4")
    total = dict(ms=0.0, bound=0.0, lib=0.0, copy=0.0)
    for f, dil in cs.WGRAD_LAYERS:
        x, g = (rand(args.batch, cs.TRUNK_CH, f, cs.N_FRAMES) for _ in range(2))
        label = f"B={args.batch} F={f} T={cs.N_FRAMES} dil={dil}"
        _, plain_ms = cs.check_wgrad(ck, x, g, dil, label)
        n_ops, n_bytes = cs.wgrad_ops_bytes(args.batch, f, cs.N_FRAMES, cs.TRUNK_CH, cs.TRUNK_CH)
        bound = max(n_ops / cs.BF16_OPS_S, n_bytes / cs.HBM_BYTES_S) * 1e3

        # the cotangent as the trunk's default route hands it to K6
        g_ph = time_phases(g, dil).contiguous() if dil > 1 else g

        def kernel():
            return ck.conv2d_wgrad_tapcat(x, g_ph, cs.KF, cs.KT, dil, dy_phases=dil)

        if not torch.equal(kernel(), ck.conv2d_wgrad_tapcat(x, g, cs.KF, cs.KT, dil)):
            cs.fail(f"[{label}] K6 on the phase-form cotangent differs from K6 on the unphased one")
        lib = cs.library_wgrad(x, g, dil)
        lib()
        k_ms = cs.cuda_ms(kernel, args.reps)
        lib_ms = cs.cuda_ms(lib, args.reps)
        k_ms2 = cs.cuda_ms(kernel, args.reps)
        copy_ms = cs.cuda_ms(lambda: (ck.channels_last_bf16(x), ck.channels_last_bf16(g_ph, dil, cs.N_FRAMES)),
                             args.reps)
        print(f"[{label}] kernel_ms={k_ms:.3f} (again {k_ms2:.3f}; of which the channels-last copies "
              f"{copy_ms:.3f}) bound_ms={bound:.3f} (operations) tflops={n_ops / min(k_ms, k_ms2) / 1e9:.1f} "
              f"library_ms={lib_ms:.3f} library/kernel={lib_ms / min(k_ms, k_ms2):.2f} "
              f"plain_ms={plain_ms:.1f}", flush=True)
        total["copy"] += copy_ms
        total["ms"] += min(k_ms, k_ms2)
        total["bound"] += bound
        total["lib"] += lib_ms
    print(f"[five layers] kernel_ms={total['ms']:.3f} (copies {total['copy']:.3f}) "
          f"bound_ms={total['bound']:.3f} library_ms={total['lib']:.3f} "
          f"library/kernel={total['lib'] / total['ms']:.2f}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
