"""Spectral2DCNN — the paper's LFO extractor (port of
`mod_extraction_tpu/models/spectral_2dcnn.py`).

Mel spectrogram -> (train-time) SpecAugment -> log -> stack of
[LayerNorm(bins, frames, no affine) -> dilated Conv2d 'same' -> MaxPool ->
per-channel PReLU] -> mean over frequency -> linear latent -> sigmoid.

Numerics match the JAX main path: float32 frontend, LayerNorm statistics
and activation I/O in float32, convs in `compute_dtype` (bfloat16 on the
main path) with bf16 outputs and bias, float32 head.  The trunk runs NCHW
internally; the public input and output shapes are those of the JAX module.
Parameters live in float32; the bf16 casts sit inside the forward, so
gradients arrive in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mod_extraction_tpu_torch.models.common import (
    PReLU,
    layer_norm_no_affine,
    lecun_normal_,
    max_pool_floor,
)
from mod_extraction_tpu_torch.ops.conv import conv2d_same
from mod_extraction_tpu_torch.ops.stft import mel_spectrogram, spec_augment

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        seed: int = 0,
    ):
        super().__init__()
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
            self.prelus.append(PReLU(c))
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
                x, int(self.sr), self.n_fft, self.hop_len, self.n_mels
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
        for conv, prelu, b_dil, t_dil in zip(
            self.convs, self.prelus, self.bin_dil, self.temp_dil
        ):
            if self.use_ln:
                h = layer_norm_no_affine(h, dims=(2, 3))
            h = conv2d_same(
                h.to(cd), conv.weight.to(cd), conv.bias.to(cd), b_dil, t_dil
            )
            h = max_pool_floor(h, self.pool_size)
            h = prelu(h)

        latent = h.to(torch.float32).mean(dim=2)  # freq mean -> (B, C, frames)
        out = torch.sigmoid(self.out(latent.transpose(1, 2)))  # (B, frames, L)
        return out.transpose(1, 2), latent
