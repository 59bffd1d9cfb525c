"""Losses (port of `mod_extraction_tpu/losses/losses.py`): l1, mse, fdl1 and
sdl1 for the stage-1 extractor, esr and dc for the stage-2 effect model, the
two spectral losses (log_mel_l1, mrstft), and the weighted loss dict.  Every
loss is `(y_hat, y, weights=None) -> scalar`, with `weights` an optional
(B,) per-example weight.

`mr_stft_loss` is auraloss's `MultiResolutionSTFTLoss` with its default
resolutions: fft (1024, 2048, 512), hop (120, 240, 50), win (600, 1200,
240), spectral-convergence + log-magnitude terms, torch.stft center=False
semantics; like the JAX function it ignores `weights`."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mod_extraction_tpu_torch.ops.stft import hann_window, mel_spectrogram


def _wmean(per_example: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over examples (axis 0); extra axes are averaged first."""
    if per_example.ndim > 1:
        per_example = per_example.reshape(per_example.shape[0], -1).mean(dim=-1)
    if weights is None:
        return per_example.mean()
    w = weights.to(per_example.dtype)
    return (per_example * w).sum() / torch.clamp(w.sum(), min=1e-8)


def l1_loss(y_hat, y, weights=None):
    return _wmean(torch.abs(y_hat - y), weights)


def mse_loss(y_hat, y, weights=None):
    return _wmean((y_hat - y) ** 2, weights)


def esr_loss(y_hat, y, weights=None, eps: float = 1e-8):
    """Error-to-signal ratio: per (B, C) the error energy over the target
    energy along the last dim, then the mean."""
    num = ((y - y_hat) ** 2).sum(dim=-1)
    denom = (y**2).sum(dim=-1) + eps
    return _wmean(num / denom, weights)


def dc_loss(y_hat, y, weights=None, eps: float = 1e-8):
    """DC offset: squared mean error over the mean target energy."""
    num = (y - y_hat).mean(dim=-1) ** 2
    denom = (y**2).mean(dim=-1) + eps
    return _wmean(num / denom, weights)


def _central_diff(x):
    return (x[..., 2:] - x[..., :-2]) / 2.0


def first_derivative_l1_loss(y_hat, y, weights=None):
    """L1 of central differences."""
    return _wmean(torch.abs(_central_diff(y_hat) - _central_diff(y)), weights)


def second_derivative_l1_loss(y_hat, y, weights=None):
    """L1 of twice-applied central differences."""
    d2h = _central_diff(_central_diff(y_hat))
    d2 = _central_diff(_central_diff(y))
    return _wmean(torch.abs(d2h - d2), weights)


def log_mel_l1_loss(
    y_hat, y, weights=None, sr=44100, n_fft=1024, hop=256, n_mels=256, eps=1e-7
):
    """L1 between log mel spectrograms of (B, C, T) audio."""
    sh = torch.log(torch.clamp(mel_spectrogram(y_hat, int(sr), n_fft, hop, n_mels), min=eps))
    st = torch.log(torch.clamp(mel_spectrogram(y, int(sr), n_fft, hop, n_mels), min=eps))
    return _wmean(torch.abs(sh - st), weights)


def _stft_mag(x, n_fft: int, hop: int, win_length: int):
    """torch.stft(center=False) magnitude with a centred hann(win) padded to
    n_fft, as auraloss's STFT: (N, T) -> (N, n_frames, n_freqs)."""
    win = np.zeros(n_fft, np.float32)
    off = (n_fft - win_length) // 2
    win[off : off + win_length] = hann_window(win_length)
    frames = x.unfold(-1, n_fft, hop) * torch.as_tensor(win, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    mag2 = spec.real**2 + spec.imag**2
    return torch.sqrt(torch.clamp(mag2, min=1e-8))


def mr_stft_loss(
    y_hat,
    y,
    weights=None,
    fft_sizes=(1024, 2048, 512),
    hop_sizes=(120, 240, 50),
    win_lengths=(600, 1200, 240),
):
    """Multi-resolution STFT loss: mean over resolutions of (spectral
    convergence + log-magnitude L1)."""
    yh = y_hat.reshape(-1, y_hat.shape[-1])
    yt = y.reshape(-1, y.shape[-1])
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        mh = _stft_mag(yh, n_fft, hop, win)
        mt = _stft_mag(yt, n_fft, hop, win)
        sc = torch.linalg.norm(mt - mh) / torch.clamp(torch.linalg.norm(mt), min=1e-8)
        log_mag = torch.mean(torch.abs(torch.log(mt) - torch.log(mh)))
        total = total + sc + log_mag
    return total / len(fft_sizes)


LossFn = Callable[..., torch.Tensor]

_LOSS_REGISTRY: Dict[str, LossFn] = {
    "l1": l1_loss,
    "fdl1": first_derivative_l1_loss,
    "sdl1": second_derivative_l1_loss,
    "mse": mse_loss,
    "esr": esr_loss,
    "dc": dc_loss,
    "mrstft": mr_stft_loss,
    "log_mel_l1": log_mel_l1_loss,
}


class WeightedLossDict:
    """Every named loss is computed and returned as a metric (zero-weight
    ones too); the total sums the positive-weight terms."""

    def __init__(self, loss_dict: Optional[Dict[str, float]] = None):
        if loss_dict is None:
            loss_dict = {"l1": 1.0, "mse": 0.0}
        unknown = set(loss_dict) - set(_LOSS_REGISTRY)
        if unknown:
            raise KeyError(f"Unknown loss: {sorted(unknown)}")
        self.loss_dict = dict(loss_dict)

    def __call__(
        self, y_hat, y, weights=None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        metrics = {}
        total = torch.zeros((), dtype=torch.float32, device=y_hat.device)
        for name, weight in self.loss_dict.items():
            val = _LOSS_REGISTRY[name](y_hat, y, weights)
            metrics[name] = val
            if weight > 0:
                total = total + weight * val
        metrics["loss"] = total
        return total, metrics
