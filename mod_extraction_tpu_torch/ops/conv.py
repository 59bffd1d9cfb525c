"""'same'-padded dilated conv for the Spectral2DCNN trunk (port of
`mod_extraction_tpu/ops/conv.py::conv2d_same` / `same_pads_1d`).

The JAX package computes this conv outside any Pallas kernel (lax conv), so
the port leaves it to `torch.nn.functional.conv2d`.  Layout is NCHW with
OIHW weights; the compute dtype is the inputs' dtype (bf16 on the main
path, with the output in bf16 as in the JAX trunk).

A time-dilated layer is computed as an undilated conv over the d time
phases of its input (t = q*d + r: phase r, position q), folded into the
batch.  This is the same sum over the same products — the forward is
bit-identical — but cuDNN's path for dilated bf16 convs is 24-44x slower
in forward + backward at the trunk's shapes on the H100 (449 ms against
12 ms over the four dilated layers at batch 32; scripts/bench_torch_conv.py,
PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads_1d(k: int, d: int) -> tuple[int, int]:
    span = (k - 1) * d
    return (span // 2, span - span // 2)


def _time_phases(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*d, C, H, ceil(W/d)), zero-padding W at the end."""
    b, c, h, w = x.shape
    wq = -(-w // d)
    x = F.pad(x, (0, wq * d - w))
    return x.reshape(b, c, h, wq, d).permute(0, 4, 1, 2, 3).reshape(b * d, c, h, wq)


def _from_time_phases(y: torch.Tensor, d: int, w: int) -> torch.Tensor:
    bd, c, h, wq = y.shape
    y = y.reshape(bd // d, d, c, h, wq).permute(0, 2, 3, 4, 1)
    return y.reshape(bd // d, c, h, wq * d)[..., :w]


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, bin_dil: int, temp_dil: int
) -> torch.Tensor:
    """x (B, I, H, W), w (O, I, kh, kw) -> (B, O, H, W)."""
    fl, fr = same_pads_1d(w.shape[2], bin_dil)
    if fl != fr:
        x = F.pad(x, (0, 0, fl, fr))
        fl = 0
    kt = w.shape[3]
    if temp_dil > 1 and kt % 2 == 1:
        # symmetric time padding (kt-1)/2 * d becomes (kt-1)/2 per phase
        y = F.conv2d(
            _time_phases(x, temp_dil), w, b,
            padding=(fl, (kt - 1) // 2), dilation=(bin_dil, 1),
        )
        return _from_time_phases(y, temp_dil, x.shape[3])
    tl, tr = same_pads_1d(kt, temp_dil)
    if tl != tr:
        x = F.pad(x, (tl, tr))
        tl = 0
    return F.conv2d(x, w, b, padding=(fl, tl), dilation=(bin_dil, temp_dil))
