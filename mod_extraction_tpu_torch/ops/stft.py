"""Mel frontend and SpecAugment (port of `mod_extraction_tpu/ops/stft.py`).

torchaudio `MelSpectrogram(sr, n_fft, hop, n_mels, center=True)` defaults:
periodic hann window, reflect padding of n_fft//2, power spectrum, HTK mel
scale with unnormalised triangular filters, and a float32 projection onto
the mels.

The DFT has the JAX package's implementations (`impl=`): "rfft"
(`torch.fft.rfft`), "dft" (an explicit real DFT as two float32 matrix
products, TF32 off, which matches rfft to float tolerance) and "dft_bf16"
(the same two products with bf16 inputs and float32 accumulation: the
windowed frames round to 8 bits of mantissa, about 0.5 % relative noise on
the power spectrum, for the training path only).  "auto" means "rfft" in
the port: the JAX package picks "dft" on its TPU because the FFT lowers
badly there, which says nothing about this card.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))).astype(
        np.float32
    )


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, f_min: float = 0.0, f_max: float | None = None
) -> np.ndarray:
    """Triangular HTK mel filterbank (torchaudio `melscale_fbanks`,
    norm=None): (n_freqs, n_mels) float32."""
    if f_max is None:
        f_max = sr / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> tuple:
    """Real-DFT basis: (n_fft, n_freqs) cos / -sin float32 matrices."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _matmul_f32_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 matrix product with TF32 off, whatever the global switch."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _power_frames(frames: torch.Tensor, n_fft: int, impl: str) -> torch.Tensor:
    """|DFT(frames)|^2 over the last axis: (..., n_fft) -> (..., n_freqs)."""
    if impl in ("auto", "rfft"):
        spec = torch.fft.rfft(frames, dim=-1)
        return spec.real**2 + spec.imag**2
    cos_b, sin_b = (torch.as_tensor(b, device=frames.device) for b in _dft_basis(n_fft))
    if impl == "dft":
        re = _matmul_f32_exact(frames, cos_b)
        im = _matmul_f32_exact(frames, sin_b)
    elif impl == "dft_bf16":
        # operands rounded to bf16, exact float32 products, float32 sums:
        # the numbers of a bf16 product that accumulates in float32
        fr = frames.to(torch.bfloat16).to(torch.float32)
        re = _matmul_f32_exact(fr, cos_b.to(torch.bfloat16).to(torch.float32))
        im = _matmul_f32_exact(fr, sin_b.to(torch.bfloat16).to(torch.float32))
    else:
        raise ValueError(f"unknown stft impl {impl!r}")
    return re * re + im * im


def _frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-padded (reflect) framing: (B, C, T) -> (B, C, n_frames, n_fft)."""
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode="reflect")
    return x.unfold(-1, n_fft, hop)


def mel_spectrogram(
    x: torch.Tensor,
    sr: int = 44100,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 256,
    impl: str = "auto",
) -> torch.Tensor:
    """Mel power spectrogram: (B, C, T) -> (B, C, n_mels, n_frames), f32."""
    frames = _frame(x.to(torch.float32), n_fft, hop)
    win = torch.as_tensor(hann_window(n_fft), device=x.device)
    mag2 = _power_frames(frames * win, n_fft, impl)  # (B, C, n_frames, n_freqs)
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=x.device)
    return torch.matmul(mag2, fb).transpose(-1, -2)


def spec_augment(
    spec: torch.Tensor,
    freq_mask_param: int,
    time_mask_param: int,
    draws: Sequence[float] | torch.Tensor,
) -> torch.Tensor:
    """SpecAugment frequency + time masking (torchaudio defaults): one mask
    of each kind, shared across the batch, width ~ U[0, param), start ~
    U[0, size - width).  `draws` holds the four U[0, 1) numbers (freq
    width, freq start, time width, time start), from a `torch.Generator`
    or — in the tests — the numbers JAX drew.  Mask bounds are computed in
    float32, as the JAX package does."""
    u = torch.as_tensor(draws, dtype=torch.float32).cpu()
    n_mels, n_frames = spec.shape[-2], spec.shape[-1]
    out = spec
    if freq_mask_param > 0:
        width = u[0] * freq_mask_param
        start = u[1] * (n_mels - width)
        f = torch.arange(n_mels, dtype=torch.float32)
        mask = ((f >= start) & (f < start + width)).to(spec.device)
        out = torch.where(mask[:, None], 0.0, out)
    if time_mask_param > 0:
        width = u[2] * time_mask_param
        start = u[3] * (n_frames - width)
        t = torch.arange(n_frames, dtype=torch.float32)
        mask = ((t >= start) & (t < start + width)).to(spec.device)
        out = torch.where(mask[None, :], 0.0, out)
    return out
