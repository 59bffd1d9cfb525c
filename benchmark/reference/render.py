"""Plain NumPy rendering of a batch: the flanger/chorus delay line with
feedback and the six-stage allpass phaser (JUCE topology), each a walk over
the samples in float32, rows side by side.

Semantics, as the reference pipeline and the JAX package define them
(`mod_extraction_tpu/ops/fx.py`, `train/render.py`):

* the frame-rate LFO is resampled to audio rate with align_corners=True;
* flanger/chorus delay (samples) = round(max_lfo_ms) * width * lfo +
  min_delay_width * round(max_min_ms), on a line of `max_delay` slots; the
  read position ((t mod d) - delay + d) mod d is interpolated linearly
  between its two slots; the line holds x + feedback * read, the output is
  x + depth * read, then (1 - mix) x + mix out, clipped to [-1, 1];
* phaser: the cutoff sweeps log-scale about the centre by -sin at a
  quarter of the sample rate (held 4 samples), g = tan(pi fc / sr); each
  stage is a TPT one-pole allpass, the cascade's output fed back into its
  input; (1 - mix) x + mix out, clipped; its ground-truth LFO is
  (sin(2 pi f (i + 1) / sr + phase) + 1) / 2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

F32 = np.float32
FLANGER_CHORUS, PHASER = 2, 3


def resample_aligned(x: np.ndarray, n: int) -> np.ndarray:
    """Linear resampling of the last axis to n points, align_corners=True;
    positions in float64, the blend in float32."""
    n_in = x.shape[-1]
    if n_in == n:
        return x.astype(F32)
    src = np.arange(n, dtype=np.float64) * (n_in - 1) / (n - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (src - lo).astype(F32)
    a, b = x[..., lo].astype(F32), x[..., hi].astype(F32)
    return a + (b - a) * frac


def flanger(x, delay, feedback, depth, mix, max_delay: int) -> np.ndarray:
    """x, delay (R, T) float32; feedback, depth, mix (R,).  Returns (R, T)."""
    r, t = x.shape
    d = int(max_delay)
    write = (np.arange(t) % d).astype(F32)
    read = np.remainder(write[None, :] - delay + F32(d), F32(d)).astype(F32)
    prev_f = np.floor(read)
    prev = prev_f.astype(np.int64)
    nxt = (prev + 1) % d
    frac = (read - prev_f).astype(F32)
    buf = np.zeros((r, d), F32)
    rows = np.arange(r)
    fb, dp = feedback.astype(F32), depth.astype(F32)
    out = np.empty_like(x)
    for i in range(t):
        f = frac[:, i]
        rd = f * buf[rows, nxt[:, i]] + (F32(1.0) - f) * buf[rows, prev[:, i]]
        xi = x[:, i]
        buf[:, i % d] = xi + fb * rd
        out[:, i] = xi + dp * rd
    m = mix.astype(F32)[:, None]
    return np.clip((F32(1.0) - m) * x + m * out, -1.0, 1.0).astype(F32)


def phaser_coefficients(t: int, sr: float, rate, depth, centre, phase) -> Tuple[np.ndarray, np.ndarray]:
    """(g (R, T), ground-truth LFO (R, T)) in float32."""
    rate = np.maximum(rate.astype(F32), F32(1e-3))
    f_max = min(20000.0, 0.49 * sr)
    centre = np.clip(centre.astype(F32), F32(20.0), F32(f_max))
    w = F32(2.0 * math.pi / sr) * rate[:, None]
    i = np.arange(1, t + 1, dtype=F32)
    mod = ((np.sin(w * i[None, :] + phase.astype(F32)[:, None]) + F32(1.0)) / F32(2.0)).astype(F32)
    n_upd = -(-t // 4)
    k4 = np.arange(n_upd, dtype=F32) * F32(4.0)
    lfo_u = -np.sin(w * k4[None, :] + phase.astype(F32)[:, None])
    span = F32(np.log10(F32(f_max / 20.0)))
    norm_centre = (np.log10(centre / F32(20.0)) / span)[:, None]
    pos = np.clip(norm_centre + F32(0.5) * depth.astype(F32)[:, None] * lfo_u, 0.0, 1.0).astype(F32)
    fc = F32(20.0) * np.power(F32(f_max / 20.0), pos)
    g_u = np.tan(F32(math.pi) * fc / F32(sr)).astype(F32)
    return np.repeat(g_u, 4, axis=1)[:, :t], mod


def phaser(x, g, feedback, mix, n_stages: int) -> np.ndarray:
    """x, g (R, T) float32; feedback, mix (R,).  Returns (R, T), clipped."""
    r, t = x.shape
    big_g = (g / (F32(1.0) + g)).astype(F32)
    fb = feedback.astype(F32)
    s = [np.zeros(r, F32) for _ in range(n_stages)]
    last = np.zeros(r, F32)
    out = np.empty_like(x)
    two = F32(2.0)
    for i in range(t):
        gi = big_g[:, i]
        u = x[:, i] + fb * last
        for n in range(n_stages):
            v = gi * (u - s[n])
            lp = v + s[n]
            s[n] = lp + v
            u = two * lp - u
        last = u
        out[:, i] = u
    m = mix.astype(F32)[:, None]
    return np.clip((F32(1.0) - m) * x + m * out, -1.0, 1.0).astype(F32)


def render_batches(batches: List[Dict], corpus: np.ndarray, n_samples: int, sr: float,
                   effects: Tuple[int, ...], max_delay: int, n_stages: int) -> List[Tuple]:
    """(dry (B, 1, T), wet (B, 1, T), LFO frames (B, F)) for each batch; the
    rows of all batches walk side by side."""
    drys, flat = [], []
    for b in batches:
        idx = b["dry_idx"].astype(np.int64)[:, None] + np.arange(n_samples)
        dry = (corpus[idx].astype(F32) / F32(32768.0)) * b["dry_gain"].astype(F32)[:, None]
        drys.append(dry.astype(F32))
    dry_all = np.concatenate(drys)
    fx = {k: np.concatenate([b["fx"][k] for b in batches]) for k in batches[0]["fx"]}
    mods = np.concatenate([b["mod_sig"] for b in batches]).astype(F32)
    eff = fx["effect_idx"]
    wet = np.zeros_like(dry_all)
    n_frames = n_samples // 100
    sel = np.nonzero(eff == FLANGER_CHORUS)[0] if FLANGER_CHORUS in effects else np.zeros(0, int)
    if sel.size:
        lfo = resample_aligned(mods[sel], n_samples)
        mmd = np.round(fx["max_min_delay_ms"][sel].astype(F32) / F32(1000.0) * F32(sr))
        mld = np.round(fx["max_lfo_delay_ms"][sel].astype(F32) / F32(1000.0) * F32(sr))
        delay = (mld[:, None] * fx["width"][sel].astype(F32)[:, None] * lfo
                 + fx["min_delay_width"][sel].astype(F32)[:, None] * mmd[:, None]).astype(F32)
        wet[sel] = flanger(dry_all[sel], delay, fx["feedback"][sel], fx["depth"][sel],
                           fx["mix"][sel], max_delay)
    sel = np.nonzero(eff == PHASER)[0] if PHASER in effects else np.zeros(0, int)
    if sel.size:
        g, gt = phaser_coefficients(n_samples, sr, fx["rate_hz"][sel], fx["depth"][sel],
                                    fx["centre_frequency_hz"][sel], fx["phase"][sel])
        wet[sel] = phaser(dry_all[sel], g, fx["feedback"][sel], fx["mix"][sel], n_stages)
        mods[sel] = resample_aligned(gt, n_frames)
    out, at = [], 0
    for d in drys:
        n = d.shape[0]
        out.append((dry_all[at:at + n, None], wet[at:at + n, None], mods[at:at + n]))
        at += n
    return out
