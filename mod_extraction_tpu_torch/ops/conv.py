"""Conv formulations for the Spectral2DCNN trunk (port of
`mod_extraction_tpu/ops/conv.py`): the 'same'-padded dilated conv, its
frequency-folded and row-pair forms, and two explicit framings of its
weight gradient.

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

`conv2d_freq_folded` and `conv2d_pair_rows` compute the same (5, kt) conv
with doubled channel counts (2.4x and 1.2x the multiply-adds).  The JAX
package has them to fill its matrix unit; the port keeps them so that a
model config written for it loads unchanged, and PERF.md records what they
cost on the card.  `conv2d_wgrad_convform` and `conv2d_wgrad_s2b` write the
weight gradient as one convolution with the roles of batch and channels
exchanged.  All of it is plain tensor code, as in the JAX package; the
hand-written weight-gradient kernel is in `ops/conv_kernels.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads_1d(k: int, d: int) -> tuple[int, int]:
    span = (k - 1) * d
    return (span // 2, span - span // 2)


def time_phases(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*d, C, H, ceil(W/d)), zero-padding W at the end."""
    b, c, h, w = x.shape
    wq = -(-w // d)
    x = F.pad(x, (0, wq * d - w))
    return x.reshape(b, c, h, wq, d).permute(0, 4, 1, 2, 3).reshape(b * d, c, h, wq)


def from_time_phases(y: torch.Tensor, d: int, w: int) -> torch.Tensor:
    bd, c, h, wq = y.shape
    y = y.reshape(bd // d, d, c, h, wq).permute(0, 2, 3, 4, 1)
    return y.reshape(bd // d, c, h, wq * d)[..., :w]


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, bin_dil: int, temp_dil: int
) -> torch.Tensor:
    """x (B, I, H, W), w (O, I, kh, kw) -> (B, O, H, W)."""
    y, d = conv2d_same_phases(x, w, b, bin_dil, temp_dil)
    return y if d == 1 else from_time_phases(y, d, x.shape[3])


def conv2d_same_phases(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, bin_dil: int, temp_dil: int
) -> tuple[torch.Tensor, int]:
    """`conv2d_same` before its time phases are put back: (y, d), y the
    conv over d time phases, (B*d, O, H, ceil(W/d)) as `time_phases` lays
    them out; d = 1 (a layer without them): y is the (B, O, H, W) conv."""
    fl, fr = same_pads_1d(w.shape[2], bin_dil)
    if fl != fr:
        x = F.pad(x, (0, 0, fl, fr))
        fl = 0
    kt = w.shape[3]
    if temp_dil > 1 and kt % 2 == 1:
        # symmetric time padding (kt-1)/2 * d becomes (kt-1)/2 per phase
        y = F.conv2d(
            time_phases(x, temp_dil), w, b,
            padding=(fl, (kt - 1) // 2), dilation=(bin_dil, 1),
        )
        return y, temp_dil
    tl, tr = same_pads_1d(kt, temp_dil)
    if tl != tr:
        x = F.pad(x, (tl, tr))
        tl = 0
    return F.conv2d(x, w, b, padding=(fl, tl), dilation=(bin_dil, temp_dil)), 1


def conv2d_same_backward(x, w, g, temp_dil: int, want_dx: bool, want_dw: bool):
    """The library's own backward passes of `conv2d_same(x, w, None, 1,
    temp_dil)` for an odd kernel, without running its forward again: (dx or
    None, dw or None) for the output cotangent g, in the same time-phase
    form as the forward."""
    kf, kt = w.shape[2], w.shape[3]
    assert kf % 2 == 1 and kt % 2 == 1, "odd kernels only"
    t = x.shape[3]
    if temp_dil > 1:
        x, g = time_phases(x, temp_dil), time_phases(g, temp_dil)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [kf // 2, kt // 2], [1, 1], False, [0, 0], 1,
        [want_dx, want_dw, False],
    )
    if want_dx and temp_dil > 1:
        dx = from_time_phases(dx, temp_dil, t)
    return (dx if want_dx else None), (dw if want_dw else None)


def _conv2d_freq_strided(x, w, b, pad_f: int, stride_f: int, temp_dil: int):
    """Bin-dilation-1 conv with symmetric frequency padding `pad_f`,
    frequency stride `stride_f` and 'same' time padding; time-dilated layers
    with an odd kt go through the time phases, as in `conv2d_same`."""
    kt = w.shape[3]
    if temp_dil > 1 and kt % 2 == 1:
        y = F.conv2d(
            time_phases(x, temp_dil), w, b,
            stride=(stride_f, 1), padding=(pad_f, (kt - 1) // 2),
        )
        return from_time_phases(y, temp_dil, x.shape[3])
    tl, tr = same_pads_1d(kt, temp_dil)
    if tl != tr:
        x = F.pad(x, (tl, tr))
        tl = 0
    return F.conv2d(
        x, w, b, stride=(stride_f, 1), padding=(pad_f, tl), dilation=(1, temp_dil)
    )


def fold_freq(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) -> (B, 2C, F/2, T); row parity r -> channels [rC, rC+C)."""
    b, c, f, t = x.shape
    assert f % 2 == 0, f"freq dim {f} must be even to fold"
    x = x.reshape(b, c, f // 2, 2, t).permute(0, 3, 1, 2, 4)
    return x.reshape(b, 2 * c, f // 2, t)


def unfold_freq(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `fold_freq`: (B, 2C, F/2, T) -> (B, C, F, T)."""
    b, c2, g, t = x.shape
    c = c2 // 2
    x = x.reshape(b, 2, c, g, t).permute(0, 2, 3, 1, 4)
    return x.reshape(b, c, 2 * g, t)


def fold_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 5, kt) -> (2Co, 2C, 3, kt).

    Output subrow r_out of folded row g is original row 2g + r_out; its
    freq tap delta reads original row 2g + r_out + delta, i.e. folded row
    offset floor((r_out + delta) / 2) and input channel block
    (r_out + delta) mod 2."""
    co, c, kf, kt = w.shape
    assert kf == 5, f"freq folding is specialized to kernel 5, got {kf}"
    wf = w.new_zeros(2 * co, 2 * c, 3, kt)
    for r_out in (0, 1):
        for delta in range(-2, 3):
            d = r_out + delta
            kr = d // 2 + 1
            r_in = d % 2
            wf[r_out * co : (r_out + 1) * co, r_in * c : (r_in + 1) * c, kr] += w[:, :, delta + 2]
    return wf


def conv2d_freq_folded(x, w, b, bin_dil: int, temp_dil: int) -> torch.Tensor:
    """(5, kt) 'same' conv computed in the freq-folded layout.  Requires
    bin_dil == 1 and an even freq dim; equals `conv2d_same(x, w, b, 1,
    temp_dil)` up to the order of the sums."""
    assert bin_dil == 1, "freq folding requires bin dilation 1"
    y = unfold_freq(conv2d_same(fold_freq(x), fold_weights(w), None, 1, temp_dil))
    return y if b is None else y + b.to(y.dtype)[None, :, None, None]


def foldable(w_shape, bin_dil: int, f: int) -> bool:
    """True when the freq-folded path computes this conv (w_shape OIHW)."""
    return w_shape[2] == 5 and bin_dil == 1 and f % 2 == 0


def pair_weights(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 5, kt) -> (2Co, C, 6, kt) for the row-pair strided conv.

    Output channel block r (row parity) gets the original taps shifted down
    by r: w2[r*Co + o, c, a', j] = w[o, c, a' - r, j] where valid."""
    co, c, kf, kt = w.shape
    assert kf == 5, f"row pairing is specialized to kernel 5, got {kf}"
    w2 = w.new_zeros(2 * co, c, 6, kt)
    w2[:co, :, 0:5] = w
    w2[co:, :, 1:6] = w
    return w2


def conv2d_pair_rows(x, w, b, bin_dil: int, temp_dil: int) -> torch.Tensor:
    """(5, kt) 'same' conv as ONE freq-stride-2 conv with 2*Co channels: 6
    freq taps x 2Co output channels at F/2 output rows, 1.2x the
    multiply-adds.  y[2p + r] is output-channel block r of strided-conv row
    p.  Requires bin_dil == 1 and an even freq dim; equals `conv2d_same` up
    to the order of the sums."""
    assert bin_dil == 1, "row pairing requires bin dilation 1"
    bsz, _, f, t = x.shape
    assert f % 2 == 0, f"freq dim {f} must be even to pair"
    co = w.shape[0]
    b2 = None if b is None else torch.cat([b, b])
    y2 = _conv2d_freq_strided(x, pair_weights(w), b2, 2, 2, temp_dil)
    y2 = y2.reshape(bsz, 2, co, f // 2, t).permute(0, 2, 3, 1, 4)
    return y2.reshape(bsz, co, f, t)


def _wgrad_as_conv(xp: torch.Tensor, dy: torch.Tensor, stride_t: int) -> torch.Tensor:
    """sum_{b,f,t} xp[b, ci, a + f, j*stride_t + t] dy[b, co, f, t] as one
    conv: batch <- ci, contracted channels <- b, kernel <- dy's (F, T)
    plane.  Returns (Co, Ci, kf, kt) in float32."""
    dw = F.conv2d(xp.transpose(0, 1), dy.transpose(0, 1), stride=(1, stride_t))
    return dw.transpose(0, 1).to(torch.float32)


def conv2d_wgrad_convform(x, dy, kf: int, kt: int, dil: int) -> torch.Tensor:
    """Weight gradient of `conv2d_same(x, w, None, 1, dil)` written as ONE
    strided conv:

        dW[co, ci, a, j] = sum_{b,f,t} xp[b, ci, f+a, t+j*dil] * dy[b, co, f, t]

    x (B, Ci, F, T), dy (B, Co, F, T) -> (Co, Ci, kf, kt) float32 (the sums
    run in the inputs' dtype, as any torch conv).  The dense core that
    `conv2d_wgrad_s2b` calls, and a control beside the library's own
    weight gradient."""
    fl, fr = same_pads_1d(kf, 1)
    tl, tr = same_pads_1d(kt, dil)
    return _wgrad_as_conv(F.pad(x, (tl, tr, fl, fr)), dy, dil)


def conv2d_wgrad_s2b(x, dy, kf: int, kt: int, dil: int) -> torch.Tensor:
    """`conv2d_wgrad_convform` with the time dilation folded into the batch
    (space-to-batch): t = u*dil + r maps (b, r) -> batch B*dil, turning the
    stride-`dil` contraction into a dense stride-1 one over a time length of
    about T/dil.  Same contraction up to the order of the sums; selectable
    as `wgrad_impl="s2b"` on the trunk convs."""
    if dil == 1:
        return conv2d_wgrad_convform(x, dy, kf, kt, 1)
    t = x.shape[3]
    tp = -(-t // dil) * dil  # T padded up to a dilation multiple
    fl, fr = same_pads_1d(kf, 1)
    tl, tr = same_pads_1d(kt, dil)
    xp = F.pad(x, (tl, tr + tp - t, fl, fr))
    dyp = F.pad(dy, (0, tp - t))
    # after padding both lengths are dilation multiples: (tp/dil + kt - 1)
    # and tp/dil positions per phase
    return _wgrad_as_conv(time_phases(xp, dil), time_phases(dyp, dil), 1)
