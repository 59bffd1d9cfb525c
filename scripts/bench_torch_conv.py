"""Time the Spectral2DCNN trunk convs on the GPU: forward + backward of each
layer of the paper config at batch 32, computed (a) by one dilated
`torch.nn.functional.conv2d` call (cuDNN's dilated path) and (b) by the
port's `ops/conv.py::conv2d_same` (time-dilated layers as an undilated conv
over the time phases).  Also prints the max-abs difference of the two
forwards.

    python3 scripts/bench_torch_conv.py [--batch 32] [--reps 3]

Needs a CUDA device; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mod_extraction_tpu_torch.ops.conv import conv2d_same  # noqa: E402

# (in channels, mel bins entering the layer, time dilation): the paper
# config, 256 mels pooled by 2 per layer, 345 frames per 2 s clip
LAYERS = [(2, 256, 1), (64, 128, 1), (64, 64, 2), (64, 32, 4), (64, 16, 8), (64, 8, 16)]
FRAMES, CO = 345, 64


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    bf = dict(device="cuda", dtype=torch.bfloat16)
    for ci, h, d in LAYERS:
        x = torch.randn(args.batch, ci, h, FRAMES, **bf, requires_grad=True)
        w = torch.randn(CO, ci, 5, 13, **bf, requires_grad=True)
        b = torch.randn(CO, **bf, requires_grad=True)
        g = torch.randn(args.batch, CO, h, FRAMES, **bf)

        def direct():
            F.conv2d(x, w, b, padding=(2, 6 * d), dilation=(1, d)).backward(g)

        def port():
            conv2d_same(x, w, b, 1, d).backward(g)

        with torch.no_grad():
            err = (F.conv2d(x, w, b, padding=(2, 6 * d), dilation=(1, d)).float()
                   - conv2d_same(x, w, b, 1, d).float()).abs().max().item()
        print(f"layer ci={ci} bins={h} dil={d}: fwd+bwd direct_dilated_ms={ms(direct, args.reps):.3f} "
              f"port_ms={ms(port, args.reps):.3f} fwd_max_abs_diff={err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
