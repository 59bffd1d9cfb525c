"""Plain PyTorch Spectral2DCNN (arXiv:2305.13262, the paper's LFO
extractor) as a function of a parameter dict:

log-Mel power spectrogram (periodic Hann, reflect padding of n_fft / 2,
HTK mel scale, unnormalised triangles) -> SpecAugment (one frequency and
one time mask, from four given uniforms) -> log(max(., 1e-7)) -> six of
[affine-free LayerNorm over (mels, frames) -> dilated 'same' conv ->
max pool (2, 1) -> per-channel PReLU] -> mean over mels -> linear ->
sigmoid.

Precision follows the configuration: the frontend, LayerNorm and head in
float32, each conv's operands and output in `conv_dtype` (bf16 as shipped)
with float32 accumulation.  A conv dilated in time is computed on the
input's d time phases (the same sum of the same products).  The max pool
sends its cotangent to every element equal to the window's maximum (the
JAX package's rule; bf16 ties are common).  `quantize` stands in for a
lower conv precision in the control (operands rounded to it, per tensor).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) HTK triangles, float32."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(x: torch.Tensor, ex: dict, sr: int, draws: Optional[Sequence[float]]) -> torch.Tensor:
    """(B, C, T) audio -> (B, C, mels, frames) log-Mel, masked when `draws`."""
    n_fft, hop, n_mels = ex["n_fft"], ex["hop_len"], ex["n_mels"]
    b, c, t = x.shape
    xp = F.pad(x.reshape(b * c, 1, t), (n_fft // 2, n_fft // 2), mode="reflect").reshape(b, c, -1)
    frames = xp.unfold(-1, n_fft, hop)  # (B, C, frames, n_fft)
    win = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(n_fft, dtype=torch.float64) / n_fft))
    spec = torch.fft.rfft(frames * win.to(torch.float32).to(x.device), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=x.device)
    mel = torch.matmul(power, fb).transpose(-1, -2)  # (B, C, mels, frames)
    if draws is not None:
        u = np.asarray(draws, np.float32)
        nm, nf = mel.shape[-2], mel.shape[-1]
        for axis, (param, size, w_u, s_u) in enumerate(
            ((int(ex["freq_mask_amount"] * n_mels), nm, u[0], u[1]),
             (int(ex["time_mask_amount"] * nf), nf, u[2], u[3]))):
            if param <= 0:
                continue
            width = np.float32(w_u * np.float32(param))
            start = np.float32(s_u * np.float32(size - width))
            pos = np.arange(size, dtype=np.float32)
            keep = torch.as_tensor(~((pos >= start) & (pos < start + width)), device=x.device)
            mel = mel * (keep[:, None] if axis == 0 else keep[None, :])
    return torch.log(torch.clamp(mel, min=1e-7))


class _EqMaskMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k: int):
        b, c, h, w = x.shape
        y = x[:, :, : h // k * k].reshape(b, c, h // k, k, w).amax(dim=3)
        ctx.save_for_backward(x, y)
        ctx.k = k
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        k = ctx.k
        h = x.shape[2] // k * k
        up = y.repeat_interleave(k, dim=2)
        gx = torch.zeros_like(x)
        gx[:, :, :h] = torch.where(x[:, :, :h] == up, g.repeat_interleave(k, dim=2), 0).to(x.dtype)
        return gx, None


def conv_same(x, w, b, dil: int) -> torch.Tensor:
    """'same' conv, odd kernel (kf, kt), time dilation `dil`, by time phases."""
    kf, kt = w.shape[2], w.shape[3]
    if dil == 1:
        return F.conv2d(x, w, b, padding=(kf // 2, kt // 2))
    bsz, c, h, t = x.shape
    tq = -(-t // dil)
    xp = F.pad(x, (0, tq * dil - t)).reshape(bsz, c, h, tq, dil).permute(0, 4, 1, 2, 3)
    y = F.conv2d(xp.reshape(bsz * dil, c, h, tq), w, b, padding=(kf // 2, kt // 2))
    o = y.shape[1]
    y = y.reshape(bsz, dil, o, h, tq).permute(0, 2, 3, 4, 1).reshape(bsz, o, h, tq * dil)
    return y[..., :t]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, ex: dict, sr: int,
            draws: Optional[Sequence[float]], conv_dtype: torch.dtype,
            quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """(B, in_ch, T) audio -> (B, frames) LFO in [0, 1]."""
    h = log_mel(x, ex, sr, draws)
    q = quantize or (lambda v: v)
    for i, dil in enumerate(ex["temp_dilations"]):
        h = h.to(torch.float32)
        mean = h.mean(dim=(2, 3), keepdim=True)
        var = h.var(dim=(2, 3), keepdim=True, unbiased=False)
        h = (h - mean) / torch.sqrt(var + 1e-5)
        h = conv_same(q(h.to(conv_dtype)), q(params[f"convs.{i}.weight"].to(conv_dtype)),
                      params[f"convs.{i}.bias"].to(conv_dtype), dil)
        h = _EqMaskMaxPool.apply(h, ex["pool_size"][0])
        a = params[f"prelus.{i}.alpha"].reshape(1, -1, 1, 1)
        h = torch.where(h >= 0, h, a * h)
    latent = h.to(torch.float32).mean(dim=2)  # (B, C, frames)
    out = torch.sigmoid(latent.transpose(1, 2) @ params["out.weight"].t() + params["out.bias"])
    return out[:, :, 0]


def npz_params(path: str) -> Dict[str, torch.Tensor]:
    """A shipped extractor `.npz` (flax layout) as this module's dict."""
    with np.load(path) as z:
        flat = {k: np.array(z[k], np.float32) for k in z.files}
    out = {}
    n = sum(1 for k in flat if k.startswith("Conv_") and k.endswith("/kernel"))
    for i in range(n):
        out[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(flat[f"Conv_{i}/kernel"].transpose(3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = torch.from_numpy(flat[f"Conv_{i}/bias"])
        out[f"prelus.{i}.alpha"] = torch.from_numpy(flat[f"PReLU_{i}/alpha"])
    out["out.weight"] = torch.from_numpy(np.ascontiguousarray(flat["Dense_0/kernel"].T))
    out["out.bias"] = torch.from_numpy(flat["Dense_0/bias"])
    return out
