"""LFO-driven audio effects (port of `mod_extraction_tpu/ops/fx.py`).

Rendering is data generation: nothing here needs a gradient.  The two
recurrences run in `ops/fx_kernels.py`: K1 (`flanger`, the counterpart of
the JAX `flanger_delay_line`) for the flanger/chorus delay line and K2 for
the phaser cascade launch the CUDA kernels on CUDA tensors and use their
plain versions on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from mod_extraction_tpu_torch.ops import fx_kernels

#: JUCE `dsp::Phaser` cutoff-sweep bounds: 20 Hz .. min(20 kHz, 0.49*fs)
PHASER_FREQ_MIN = 20.0
#: JUCE `dsp::Phaser` updates the filter cutoff every 4 samples.
PHASER_UPDATE_EVERY = 4


def _param_bc(p, batch_size: int, device) -> torch.Tensor:
    """Broadcast a scalar or (B,) param to (B, 1, 1) float32."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    if p.ndim == 0:
        p = p.expand(batch_size)
    return p.reshape(batch_size, 1, 1)


def apply_tremolo(x: torch.Tensor, mod_sig: torch.Tensor, mix=1.0) -> torch.Tensor:
    """Amplitude modulation: (1-mix)*x + mix*mod*x.

    x: (B, C, T); mod_sig: (B, T) or (B, C, T); mix: scalar or (B,)."""
    assert x.ndim == 3
    if mod_sig.ndim == 2:
        mod_sig = mod_sig[:, None, :]
    mix = _param_bc(mix, x.shape[0], x.device)
    return (1.0 - mix) * x + mix * mod_sig * x


def phaser_freq_max(sr: float) -> float:
    return min(20000.0, 0.49 * sr)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def map_from_log10(f, f_min: float = PHASER_FREQ_MIN, f_max: float = 20000.0):
    """Normalized log-position of frequency f in [f_min, f_max] (JUCE)."""
    f = torch.as_tensor(f, dtype=torch.float32)
    return torch.log10(f / f_min) / torch.log10(_f32(f_max / f_min, f.device))


def map_to_log10(x: torch.Tensor, f_min: float = PHASER_FREQ_MIN, f_max: float = 20000.0):
    """Inverse of `map_from_log10`."""
    return f_min * torch.pow(_f32(f_max / f_min, x.device), x)


def phaser_coefficients(
    n_samples: int, sr: float, rate_hz, depth, centre_frequency_hz, phase
) -> tuple[torch.Tensor, torch.Tensor]:
    """The phaser's prologue: (g (B, T), GT mod signal (B, T)).

    GT: (sin(2*pi*f*(i+1)/sr + phase) + 1) / 2.  Cutoff sweep: the JUCE
    oscillator runs at sr/4 and emits -sin(2*pi*f*t + phase), held for 4
    samples; the cutoff is mapped log-scale over 20 .. min(20k, 0.49 sr),
    and g = tan(pi * fc / sr) is the TPT prewarp.  The sweep is antiphase
    to the GT signal, as in the reference pipeline."""
    rate_hz = torch.as_tensor(rate_hz, dtype=torch.float32).reshape(-1)
    device = rate_hz.device
    b = rate_hz.shape[0]
    phase = torch.as_tensor(phase, dtype=torch.float32, device=device).expand(b)
    depth_b = _param_bc(depth, b, device)
    centre = torch.as_tensor(centre_frequency_hz, dtype=torch.float32, device=device)
    centre = centre.reshape(-1)
    f_max = phaser_freq_max(sr)
    w = _f32(2.0 * math.pi / sr, device) * rate_hz[:, None]  # (B, 1)

    i = torch.arange(1, n_samples + 1, dtype=torch.float32, device=device)
    mod_sig = (torch.sin(w * i[None, :] + phase[:, None]) + 1.0) / 2.0

    upd = PHASER_UPDATE_EVERY
    n_upd = -(-n_samples // upd)
    k4 = torch.arange(n_upd, dtype=torch.float32, device=device) * float(upd)
    lfo_u = -torch.sin(w * k4[None, :] + phase[:, None])  # (B, n_upd)
    norm_centre = map_from_log10(centre, f_max=f_max)[:, None]
    swing = 0.5 * depth_b[:, :, 0]  # oscVolume = depth / 2
    pos01 = torch.clamp(norm_centre + swing * lfo_u, 0.0, 1.0)
    fc = map_to_log10(pos01, f_max=f_max)
    g_u = torch.tan(_f32(math.pi, device) * fc / sr)
    g = torch.repeat_interleave(g_u, upd, dim=1)[:, :n_samples]
    return g, mod_sig


def apply_phaser(
    x: torch.Tensor,
    sr: float,
    rate_hz,
    depth=0.5,
    centre_frequency_hz=1300.0,
    feedback=0.0,
    mix=0.5,
    phase=0.0,
    n_stages: int = 6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-varying 6-stage allpass-cascade phaser (JUCE topology).

    Returns (wet (B, C, T) clipped to [-1, 1], GT mod_sig (B, T) in [0, 1])."""
    assert x.ndim == 3
    b, c, t = x.shape
    rate_hz = torch.as_tensor(rate_hz, dtype=torch.float32, device=x.device)
    g, mod_sig = phaser_coefficients(t, sr, rate_hz, depth, centre_frequency_hz, phase)
    wet = fx_kernels.phaser(
        x,
        g[:, None, :],
        _param_bc(feedback, b, x.device),
        _param_bc(mix, b, x.device),
        n_stages,
    )
    return torch.clamp(wet, -1.0, 1.0), mod_sig
