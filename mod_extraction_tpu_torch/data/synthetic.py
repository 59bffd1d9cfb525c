"""Synthetic data (no recorded audio needed) for tests, the chip smoke run
and the bench: the numpy copy of `mod_extraction_tpu/data/synthetic.py::
make_synthetic_batch`, the interwoven (flanger + chorus + phaser) batch the stage-1 path trains
on, and `write_synthetic_corpus`, the port's copy of the riff corpus that
`scripts/make_synthetic_corpus.py` writes (same files, byte for byte)."""

from __future__ import annotations

from typing import Dict

import os

import numpy as np
import torch

from mod_extraction_tpu_torch.data.constants import (
    EFFECT_FLANGER_CHORUS,
    EFFECT_PHASER,
    EFFECT_TREMOLO,
    MOD_SIG_DIVISOR,
    default_fx,
)
from mod_extraction_tpu_torch.data.loader import collate
from mod_extraction_tpu_torch.data.mods import LFO_SHAPES, np_make_mod_signal
from mod_extraction_tpu_torch.data.wav import wav_write
from mod_extraction_tpu_torch.utils.device import resolve_device

CORPUS_SR = 44100
# E-standard guitar fretboard, lowest octave-and-a-bit (Hz)
_E2 = 82.41
SEMITONE = 2.0 ** (1.0 / 12.0)

# Delay-line ranges of the interwoven config's two delay effects
# (configs/data/interwoven_idmt_all_live.yml): (max_min_delay_ms,
# max_lfo_delay_ms).
FLANGER_DELAYS_MS = (1.0, 10.0)
CHORUS_DELAYS_MS = (30.0, 10.0)


def flanger_max_delay_samples(
    max_min_delay_ms: float, max_lfo_delay_ms: float, sr: float
) -> int:
    """Delay-line length for one flanger/chorus config (round half up, as
    `mod_extraction_tpu/data/modules.py` sizes it): 485 for the flanger and
    1764 for the chorus at 44.1 kHz."""
    mmd = int(max_min_delay_ms / 1000.0 * sr + 0.5)
    mld = int(max_lfo_delay_ms / 1000.0 * sr + 0.5)
    return mmd + mld


def make_synthetic_batch(
    seed: int, batch_size: int, n_samples: int, sr: float, effect: str = "flanger"
) -> Dict:
    """Filtered-noise dry audio, frame-rate LFOs and fx params drawn from
    the reference's training ranges; same draws as the JAX package's
    `make_synthetic_batch` for the same seed."""
    rng = np.random.default_rng(seed)
    items = []
    n_frames = n_samples // MOD_SIG_DIVISOR
    for _ in range(batch_size):
        white = rng.standard_normal(n_samples + 64).astype(np.float32)
        dry = np.convolve(white, np.ones(64, np.float32) / 16.0, "valid")[:n_samples]
        dry = (0.5 * dry / max(1e-6, np.abs(dry).max()))[None, :].astype(np.float32)

        rate = float(np.exp(rng.uniform(np.log(0.5), np.log(3.0))))
        phase = float(rng.uniform(0, 2 * np.pi))
        shape = int(rng.integers(0, 6))
        mod = np_make_mod_signal(
            n_frames, sr / MOD_SIG_DIVISOR, rate, phase, LFO_SHAPES[shape]
        )
        fx = default_fx()
        fx.update(rate_hz=rate, phase=phase, shape=shape, exp=1.0)
        if effect in ("flanger", "chorus"):
            chorus = effect == "chorus"
            mmd_ms, mld_ms = CHORUS_DELAYS_MS if chorus else FLANGER_DELAYS_MS
            fx.update(
                effect_idx=EFFECT_FLANGER_CHORUS,
                feedback=float(rng.uniform(0.0, 0.7)),
                min_delay_width=float(rng.uniform(0.367 if chorus else 0.0, 1.0)),
                width=float(rng.uniform(0.25, 1.0)),
                depth=float(rng.uniform(0.25, 1.0)),
                mix=float(rng.uniform(0.25, 1.0)),
                max_min_delay_ms=mmd_ms,
                max_lfo_delay_ms=mld_ms,
            )
        elif effect == "phaser":
            fx.update(
                effect_idx=EFFECT_PHASER,
                depth=float(rng.uniform(0.2, 1.0)),
                centre_frequency_hz=float(
                    np.exp(rng.uniform(np.log(70.0), np.log(18000.0)))
                ),
                feedback=float(rng.uniform(0.0, 0.7)),
                mix=float(rng.uniform(0.2, 1.0)),
            )
        elif effect == "tremolo":
            fx.update(effect_idx=EFFECT_TREMOLO, mix=float(rng.uniform(0.2, 1.0)))
        else:
            raise ValueError(f"unknown effect {effect!r}")
        items.append({"dry": dry, "mod_sig": mod, "fx": fx})
    return collate(items)


def make_interwoven_batch(
    seed: int, batch_size: int, n_samples: int, sr: float
) -> Dict:
    """One interwoven batch: flanger, chorus and phaser rows in thirds
    (the remainder goes to the first effects), each third drawn by
    `make_synthetic_batch` from its own seed and the three concatenated."""
    names = ("flanger", "chorus", "phaser")
    counts = [batch_size // 3 + (i < batch_size % 3) for i in range(3)]
    parts = [
        make_synthetic_batch(seed * 3 + i, n, n_samples, sr, name)
        for i, (name, n) in enumerate(zip(names, counts))
        if n > 0
    ]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0] if k != "fx"}
    out["fx"] = {
        k: np.concatenate([p["fx"][k] for p in parts]) for k in parts[0]["fx"]
    }
    return out


def batch_to_torch(batch: Dict, device: str | torch.device = "cuda") -> Dict:
    """numpy batch dict -> torch tensors on `device` (CUDA unless asked)."""
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.as_tensor(np.asarray(v)).to(device)

    return conv(batch)


def karplus_strong(
    rng: np.random.Generator, freq: float, n: int, damp: float
) -> np.ndarray:
    """Plucked string: noise burst through the KS averaging loop."""
    period = max(2, int(round(CORPUS_SR / freq)))
    buf = rng.uniform(-1.0, 1.0, period).astype(np.float64)
    out = np.empty(n)
    # vectorize per period block: y[t] = damp * 0.5 * (y[t-p] + y[t-p-1])
    prev_last = buf[-1]
    pos = 0
    while pos < n:
        take = min(period, n - pos)
        prev = np.concatenate(([prev_last], buf[:-1]))
        buf = damp * 0.5 * (buf + prev)
        out[pos : pos + take] = buf[:take]
        prev_last = buf[-1]
        pos += take
    return out


def render_riff(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """Random pentatonic riff with rests; soft-clipped body resonance."""
    out = np.zeros(n_samples + CORPUS_SR)
    beat = 60.0 / bpm
    # random pentatonic scale rooted in the low register
    root = _E2 * SEMITONE ** rng.integers(0, 12)
    scale = [0, 3, 5, 7, 10, 12, 15, 17]
    t = rng.uniform(0.0, 0.5) * beat
    while t * CORPUS_SR < n_samples:
        dur_beats = rng.choice([0.5, 0.5, 1.0, 1.0, 2.0])
        if rng.uniform() < 0.12:  # rest
            t += dur_beats * beat
            continue
        n_notes = 2 if rng.uniform() < 0.25 else 1  # occasional double-stop
        for _ in range(n_notes):
            freq = root * SEMITONE ** rng.choice(scale)
            dur = dur_beats * beat * rng.uniform(1.0, 1.8)  # let notes ring
            n = int(dur * CORPUS_SR)
            damp = rng.uniform(0.994, 0.999)
            note = karplus_strong(rng, freq, n, damp)
            note *= rng.uniform(0.4, 0.9) * np.exp(-np.arange(n) / (dur * CORPUS_SR))
            i = int(t * CORPUS_SR)
            out[i : i + n] += note[: max(0, len(out) - i)]
        t += dur_beats * beat
    out = out[:n_samples]
    out = np.tanh(1.5 * out)  # gentle body/amp saturation
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


def write_synthetic_corpus(
    out_root: str, n_train: int = 32, n_val: int = 8, dur_s: float = 12.0
) -> list:
    """Karplus-Strong guitar riffs as PCM16 wavs under `out_root/{train,val}`,
    named `riffs_<seed>_<bpm>bpm.wav` (the idmt split convention), each file
    drawn from its own seed: the corpus `scripts/make_synthetic_corpus.py
    [out_root] [n_train] [n_val] [dur_s]` writes, byte for byte.  Returns
    the paths written."""
    n_samples = int(dur_s * CORPUS_SR)
    paths = []
    for split, count, seed0 in (("train", n_train, 1000), ("val", n_val, 2000)):
        if count <= 0:
            continue
        d = os.path.join(out_root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            rng = np.random.default_rng(seed0 + i)
            bpm = int(rng.choice([80, 95, 100, 110, 120, 130, 140]))
            path = os.path.join(d, f"riffs_{seed0 + i}_{bpm}bpm.wav")
            wav_write(path, render_riff(rng, n_samples, bpm), CORPUS_SR)
            paths.append(path)
    return paths
