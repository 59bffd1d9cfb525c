"""Spectral2DCNN — the paper's LFO extractor (port of
`mod_extraction_tpu/models/spectral_2dcnn.py`).

Mel spectrogram -> (train-time) SpecAugment -> log -> stack of
[LayerNorm(bins, frames, no affine) -> dilated Conv2d 'same' -> MaxPool ->
per-channel PReLU] -> mean over frequency -> linear latent -> sigmoid.

Numerics match the JAX main path: float32 frontend, LayerNorm statistics
and activation I/O in float32, convs in `compute_dtype` (bfloat16 on the
main path) with bf16 outputs and bias, float32 head.  The trunk runs NCHW
internally; the public input and output shapes are those of the JAX module.
Between two convs the block (bias, pool, PReLU, LayerNorm, cast) is one
call, `ops/trunk_kernels.py::trunk_block`: K7 on the card, the eager chain
on the CPU.
Parameters live in float32; the bf16 casts sit inside the forward, so
gradients arrive in float32.

The compute-path options keep the JAX package's names and values, so a
model config written for it loads unchanged: `conv_impl` "lax" /
"freq_folded" / "pair", `wgrad_impl` "xla" (the default route: on the card
K6 where it covers the layer, else the library's weight gradient) /
"pallas" (K6, the hand-written CUDA kernel of `ops/conv_kernels.py`, through
the explicit backward of `make_conv2d_custom`) / "s2b",
`grad_barrier` False / True / "all" / "l0", `stft_impl`, `act_io_dtype`.
None of them changes a parameter's name or shape.  So "xla" does not mean
the library's weight gradient on the card's 64-channel bf16 layers: there
only `grad_barrier` (`make_conv2d_custom`'s "xla") still reaches it, and
"pallas" gives the default's weight gradient by a slower route (it runs the
forward again for the data gradient).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mod_extraction_tpu_torch.models.common import PReLU, layer_norm_no_affine, lecun_normal_
from mod_extraction_tpu_torch.ops.conv import conv2d_freq_folded, conv2d_same_phases, foldable
from mod_extraction_tpu_torch.ops.conv_kernels import (
    conv2d_same_phases_kernel_wgrad,
    make_conv2d_custom,
    pair_supported,
    wgrad_supported,
)
from mod_extraction_tpu_torch.ops.stft import mel_spectrogram, spec_augment
from mod_extraction_tpu_torch.ops.trunk_kernels import Block, trunk_block

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def trunk_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bin_dil: int,
    temp_dil: int,
    conv_impl: str = "lax",
    wgrad_impl: str = "xla",
    grad_barrier: bool = False,
) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """One trunk conv on the selected compute path (the JAX `_TrunkConv`):
    x (B, I, F, T), w OIHW in the compute dtype, b the float32 bias
    parameter.  A layer that an option does not cover takes the plain
    `conv2d_same`.  Returns (y, d, bias): the conv over d time phases
    (`ops/conv.py::conv2d_same_phases`; d = 1: the (B, O, F, T) conv) and
    the bias still to add, None where the conv added it.

    On the default path the card's library adds the bias in a pass of its
    own after the product; that pass moves into the block after the conv
    (`ops/trunk_kernels.py`), which adds it as the library did.  The CPU's
    library adds it inside its sums, so there the conv keeps it, and a CPU
    run is what it was.  On the card, where the conv runs in bf16 (K6 sums
    bf16 products; a float32 trunk keeps the library's float32 weight
    gradient) and K6 covers the layer (`wgrad_supported`: the 64-channel
    layers), the weight gradient is K6's (`conv2d_same_phases_kernel_wgrad`:
    the same forward and data gradient, bit for bit); a forward that records
    no gradient runs that same library call alone and launches no K6.

    Without "pair" the data gradient is autograd of the forward conv, the
    library's own backward-data pass.  (The JAX module names "lax" there,
    which XLA lowers to the same transposed conv as autodiff does; in
    PyTorch the explicit flipped-kernel conv that "lax" means in
    `make_conv2d_custom` is another sum order than the library's pass.)"""
    f, ci = x.shape[2], x.shape[1]
    pair_ok = conv_impl == "pair" and pair_supported(w.shape, bin_dil, f)
    wgrad_ok = wgrad_impl == "pallas" and wgrad_supported(w.shape, bin_dil, ci)
    # the s2b framing only reshapes and strides: any bin-dilation-1 layer
    s2b_ok = wgrad_impl == "s2b" and bin_dil == 1
    if conv_impl == "freq_folded" and foldable(w.shape, bin_dil, f):
        return conv2d_freq_folded(x, w, b.to(x.dtype), bin_dil, temp_dil), 1, None
    if (pair_ok or wgrad_ok or s2b_ok or grad_barrier) and bin_dil == 1:
        conv = make_conv2d_custom(
            temp_dil,
            fwd_impl="pair" if pair_ok else "lax",
            dgrad_impl="pair" if pair_ok else "autodiff",
            wgrad_impl="pallas" if wgrad_ok else ("s2b" if s2b_ok else "xla"),
            with_bias=True,
        )
        return conv(x, w, b.to(x.dtype)), 1, None
    if x.is_cuda:
        if x.dtype == torch.bfloat16 and wgrad_supported(w.shape, bin_dil, ci):
            return (*conv2d_same_phases_kernel_wgrad(x, w, temp_dil), b)
        return (*conv2d_same_phases(x, w, None, bin_dil, temp_dil), b)
    return (*conv2d_same_phases(x, w, b.to(x.dtype), bin_dil, temp_dil), None)


class Spectral2DCNN(nn.Module):
    def __init__(
        self,
        in_ch: int = 1,
        n_samples: int = 88200,
        sr: float = 44100,
        n_fft: int = 1024,
        hop_len: int = 256,
        n_mels: int = 256,
        kernel_size: Tuple[int, int] = (5, 13),
        out_channels: Optional[Sequence[int]] = None,
        bin_dilations: Optional[Sequence[int]] = None,
        temp_dilations: Optional[Sequence[int]] = None,
        pool_size: Tuple[int, int] = (3, 1),
        latent_dim: int = 1,
        freq_mask_amount: float = 0.0,
        time_mask_amount: float = 0.0,
        use_ln: bool = True,
        eps: float = 1e-7,
        compute_dtype: str = "float32",
        conv_impl: str = "lax",
        wgrad_impl: str = "xla",
        grad_barrier: bool | str = False,
        stft_impl: str = "auto",
        act_io_dtype: str = "float32",
        seed: int = 0,
    ):
        super().__init__()
        assert conv_impl in ("lax", "freq_folded", "pair"), conv_impl
        assert wgrad_impl in ("xla", "pallas", "s2b"), wgrad_impl
        assert grad_barrier in (False, True, "none", "all", "l0"), grad_barrier
        assert act_io_dtype in ("float32", "compute"), act_io_dtype
        chans = list(out_channels) if out_channels else [64] * 5
        self.bin_dil = list(bin_dilations) if bin_dilations else [1] * len(chans)
        self.temp_dil = (
            list(temp_dilations) if temp_dilations else [2**i for i in range(len(chans))]
        )
        assert len(chans) == len(self.bin_dil) == len(self.temp_dil)
        assert pool_size[1] == 1
        self.in_ch, self.n_samples, self.sr = in_ch, n_samples, sr
        self.n_fft, self.hop_len, self.n_mels = n_fft, hop_len, n_mels
        self.pool_size = tuple(pool_size)
        self.freq_mask_amount = freq_mask_amount
        self.time_mask_amount = time_mask_amount
        self.use_ln, self.eps = use_ln, eps
        self.compute_dtype = _DTYPES[compute_dtype]
        self.conv_impl, self.wgrad_impl = conv_impl, wgrad_impl
        self.grad_barrier = grad_barrier
        self.stft_impl = stft_impl
        # activation I/O of LayerNorm and PReLU: float32, or the compute
        # dtype with float32 statistics
        self.act_compute = act_io_dtype == "compute"

        gen = torch.Generator().manual_seed(seed)
        kf, kt = kernel_size
        self.convs = nn.ModuleList()
        self.prelus = nn.ModuleList()
        prev = in_ch
        for c in chans:
            conv = nn.Conv2d(prev, c, (kf, kt))
            lecun_normal_(conv.weight.data, kf * kt * prev, gen)
            nn.init.zeros_(conv.bias)
            self.convs.append(conv)
            self.prelus.append(PReLU(c, keep_dtype=self.act_compute))
            prev = c
        self.out = nn.Linear(prev, latent_dim)
        lecun_normal_(self.out.weight.data, prev, gen)
        nn.init.zeros_(self.out.bias)

    def forward(
        self,
        x: torch.Tensor,
        mask_draws: Optional[Sequence[float]] = None,
        features: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, in_ch, n_samples) audio.  Returns (mod_hat (B, latent_dim,
        F), latent (B, C, F)).

        `mask_draws` (four U[0, 1) numbers) turns on SpecAugment — the
        training path.  `features` (B, in_ch, mels, frames) bypasses the
        Mel frontend."""
        assert x.ndim == 3
        if features is not None:
            spec = features
        else:
            spec = mel_spectrogram(
                x, int(self.sr), self.n_fft, self.hop_len, self.n_mels,
                impl=self.stft_impl,
            )
        n_frames = spec.shape[-1]
        if mask_draws is not None and (
            self.freq_mask_amount > 0 or self.time_mask_amount > 0
        ):
            spec = spec_augment(
                spec,
                int(self.freq_mask_amount * self.n_mels),
                int(self.time_mask_amount * n_frames),
                mask_draws,
            )

        h = torch.log(torch.clamp(spec, min=self.eps))  # (B, C, mels, frames)
        cd = self.compute_dtype
        if self.act_compute:
            h = h.to(cd)
        if self.use_ln:
            h = layer_norm_no_affine(
                h, dims=(2, 3), stat_dtype=torch.float32 if self.act_compute else None
            )
        n = len(self.convs)
        for i, (conv, prelu, b_dil, t_dil) in enumerate(
            zip(self.convs, self.prelus, self.bin_dil, self.temp_dil)
        ):
            barrier = self.grad_barrier in (True, "all") or (self.grad_barrier == "l0" and i == 0)
            y, phases, bias = trunk_conv(
                h.to(cd), conv.weight.to(cd), conv.bias, b_dil, t_dil,
                self.conv_impl, self.wgrad_impl, barrier,
            )
            # bias, pool, PReLU, then the next conv's LayerNorm and cast; the
            # last block hands PReLU's output to the frequency mean
            last = i == n - 1
            h = trunk_block(y, bias, prelu.alpha, Block(
                phases=phases, width=n_frames, pool=self.pool_size[0],
                ln=self.use_ln and not last, narrow=self.act_compute,
                out_dtype=cd if self.act_compute or not last else torch.float32,
            ))

        latent = h.to(torch.float32).mean(dim=2)  # freq mean -> (B, C, frames)
        out = torch.sigmoid(self.out(latent.transpose(1, 2)))  # (B, frames, L)
        return out.transpose(1, 2), latent
