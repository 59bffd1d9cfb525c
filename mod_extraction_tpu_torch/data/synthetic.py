"""Synthetic data (no recorded audio needed) for tests, the chip smoke run
and the bench: the numpy copy of `mod_extraction_tpu/data/synthetic.py::
make_synthetic_batch`, the interwoven (flanger + chorus + phaser) batch the stage-1 path trains
on, and `write_synthetic_corpus`, the port's copy of the corpora that
`scripts/make_synthetic_corpus.py` writes (the riffs and the unseen-audio
styles; same files, byte for byte), with `write_wet_corpus` and
`fit_config`, which point a shipped training config at such a corpus
(`chip_smoke.py`, `scripts/fit_ddp_torch.py`)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

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


def render_pads(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """Sustained additive-synthesis chords (vocal/pad-like): slow attacks,
    steady harmonics, slight detune shimmer — spectral statistics far from
    the plucked KS riffs, for the UNSEEN-AUDIO generalization eval
    (reference uses MedleyDB/VocalSet there)."""
    out = np.zeros(n_samples)
    bar = 4 * 60.0 / bpm
    t_axis = np.arange(n_samples) / CORPUS_SR
    t = 0.0
    while t < n_samples / CORPUS_SR:
        dur = bar * rng.choice([1.0, 1.0, 2.0])
        root = 110.0 * SEMITONE ** rng.integers(0, 24)
        intervals = rng.choice([0, 3, 4, 7, 10, 12], rng.integers(3, 6),
                               replace=False)
        seg = np.zeros(n_samples)
        for iv in intervals:
            f0 = root * SEMITONE ** iv
            for h in range(1, 9):
                if f0 * h > 0.45 * CORPUS_SR:
                    break
                detune = 1.0 + rng.normal(0.0, 3e-4)
                amp = rng.uniform(0.5, 1.0) / h**1.5
                ph = rng.uniform(0, 2 * np.pi)
                seg += amp * np.sin(2 * np.pi * f0 * h * detune * t_axis + ph)
        # slow attack/release envelope gated to [t, t+dur]
        env = np.clip((t_axis - t) / 0.4, 0, 1) * np.clip((t + dur - t_axis) / 0.6, 0, 1)
        out += seg * np.clip(env, 0, 1) * rng.uniform(0.2, 0.5)
        t += dur
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


def render_vocal(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """Solo voice-like line: harmonic source with formant-shaped partials,
    5-6 Hz vibrato, portamento between notes and breathy phrase gaps —
    the VocalSet stand-in for the unseen-audio eval."""
    out = np.zeros(n_samples)
    beat = 60.0 / bpm
    # a singer's comfortable register + 2-3 formant resonances
    root = 196.0 * SEMITONE ** rng.integers(0, 10)
    scale = [0, 2, 4, 5, 7, 9, 11, 12]
    formants = rng.uniform([450, 1100, 2400], [750, 1600, 3000])
    fwidths = rng.uniform([80, 120, 250], [140, 220, 400])
    t = rng.uniform(0.0, 0.3) * beat
    prev_f0 = root
    while t * CORPUS_SR < n_samples:
        dur_beats = rng.choice([1.0, 1.0, 2.0, 2.0, 4.0])
        if rng.uniform() < 0.15:  # breath pause
            t += dur_beats * beat
            prev_f0 = root
            continue
        f0_target = root * SEMITONE ** rng.choice(scale)
        dur = dur_beats * beat
        n = min(int(dur * CORPUS_SR), n_samples - int(t * CORPUS_SR))
        if n <= 0:
            break
        tt = np.arange(n) / CORPUS_SR
        # portamento from the previous pitch + vibrato ramping in
        glide = f0_target + (prev_f0 - f0_target) * np.exp(-tt / 0.06)
        vib_rate = rng.uniform(4.5, 6.0)
        vib_depth = 2.0 ** (rng.uniform(15, 40) / 1200.0) - 1.0  # cents
        vib_env = np.clip((tt - 0.15) / 0.25, 0, 1)
        f0_t = glide * (1.0 + vib_depth * vib_env * np.sin(2 * np.pi * vib_rate * tt))
        phase = 2 * np.pi * np.cumsum(f0_t) / CORPUS_SR
        seg = np.zeros(n)
        for h in range(1, 24):
            fh = f0_target * h
            if fh > 0.45 * CORPUS_SR:
                break
            # formant envelope: sum of gaussian resonances + tilt
            fenv = sum(
                a * np.exp(-0.5 * ((fh - fc) / fw) ** 2)
                for a, fc, fw in zip((1.0, 0.6, 0.35), formants, fwidths)
            ) + 0.08 / h
            seg += fenv * np.sin(h * phase)
        # breath noise, weakly high-passed by differencing
        breath = np.diff(rng.uniform(-1, 1, n + 1)) * 0.01
        env = np.clip(tt / 0.08, 0, 1) * np.clip((dur - tt) / 0.12, 0, 1)
        i = int(t * CORPUS_SR)
        out[i : i + n] += (seg * 0.25 + breath) * np.clip(env, 0, 1)
        prev_f0 = f0_target
        t += dur_beats * beat
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


def render_drums(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """Kick/snare/hat groove (idmt_drums stand-in): pitch-dropping sine
    kicks, noise-burst snares, short HF hats on a 16th grid with ring-out
    so 2 s chunks stay above the silence threshold."""
    out = np.zeros(n_samples + CORPUS_SR)
    step = 60.0 / bpm / 4.0  # 16th notes

    def kick(n):
        tt = np.arange(n) / CORPUS_SR
        f = 50.0 + 90.0 * np.exp(-tt / 0.03)
        return np.sin(2 * np.pi * np.cumsum(f) / CORPUS_SR) * np.exp(-tt / 0.18)

    def snare(n):
        tt = np.arange(n) / CORPUS_SR
        noise = rng.uniform(-1, 1, n)
        # crude bandpass: difference (HP) then 2-tap average (LP)
        noise = np.diff(noise, prepend=0.0)
        noise = 0.5 * (noise + np.concatenate(([0.0], noise[:-1])))
        tone = 0.4 * np.sin(2 * np.pi * 190.0 * tt)
        return (noise + tone) * np.exp(-tt / 0.09)

    def hat(n):
        tt = np.arange(n) / CORPUS_SR
        noise = np.diff(rng.uniform(-1, 1, n), prepend=0.0)  # high-passed
        return noise * np.exp(-tt / 0.025)

    n_steps = int(n_samples / CORPUS_SR / step) + 1
    for s in range(n_steps):
        i = int(s * step * CORPUS_SR)
        beat_in_bar = s % 16
        if beat_in_bar in (0, 8) or rng.uniform() < 0.08:
            n = int(0.5 * CORPUS_SR)
            out[i : i + n] += 0.9 * kick(n)[: len(out) - i]
        if beat_in_bar in (4, 12) or rng.uniform() < 0.06:
            n = int(0.35 * CORPUS_SR)
            out[i : i + n] += 0.6 * snare(n)[: len(out) - i]
        if beat_in_bar % 2 == 0 or rng.uniform() < 0.3:
            n = int(0.12 * CORPUS_SR)
            out[i : i + n] += rng.uniform(0.15, 0.35) * hat(n)[: len(out) - i]
    out = out[:n_samples]
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


def render_bass(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """Low monophonic KS bassline (mdb_bass stand-in): one octave below
    the guitar register, longer sustains, heavier damping filter."""
    out = np.zeros(n_samples + CORPUS_SR)
    beat = 60.0 / bpm
    root = (_E2 / 2.0) * SEMITONE ** rng.integers(0, 7)
    scale = [0, 3, 5, 7, 10, 12]
    t = rng.uniform(0.0, 0.25) * beat
    while t * CORPUS_SR < n_samples:
        dur_beats = rng.choice([1.0, 1.0, 2.0, 2.0, 4.0])
        if rng.uniform() < 0.08:
            t += dur_beats * beat
            continue
        freq = root * SEMITONE ** rng.choice(scale)
        dur = dur_beats * beat * rng.uniform(1.2, 1.8)
        n = int(dur * CORPUS_SR)
        note = karplus_strong(rng, freq, n, rng.uniform(0.997, 0.9995))
        # mellow the pluck: 4-tap moving average (gentle lowpass)
        k = np.ones(4) / 4.0
        note = np.convolve(note, k, mode="same")
        note *= rng.uniform(0.5, 0.9) * np.exp(-np.arange(n) / (dur * CORPUS_SR))
        i = int(t * CORPUS_SR)
        out[i : i + n] += note[: max(0, len(out) - i)]
        t += dur_beats * beat
    out = np.tanh(1.2 * out[:n_samples])
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


def render_keys(rng: np.random.Generator, n_samples: int, bpm: int) -> np.ndarray:
    """FM electric-piano comping (keys stand-in, 5th unseen-audio
    domain): percussive bell-like attacks from a fast-decaying FM
    modulation index plus a 'tine' partial, chords on a half/whole-beat
    grid — transient-rich but pitched, unlike pads (slow attack), drums
    (unpitched), or bass/riffs (plucked KS)."""
    out = np.zeros(n_samples + CORPUS_SR)
    beat = 60.0 / bpm
    root = 220.0 * SEMITONE ** rng.integers(0, 12)
    scale = [0, 2, 4, 5, 7, 9, 11]
    t = rng.uniform(0.0, 0.25) * beat
    while t * CORPUS_SR < n_samples:
        dur_beats = rng.choice([0.5, 1.0, 1.0, 2.0])
        if rng.uniform() < 0.12:  # comping rest
            t += dur_beats * beat
            continue
        degree = rng.integers(0, 7)
        chord = [scale[degree], scale[(degree + 2) % 7] + (12 if degree + 2 >= 7 else 0),
                 scale[(degree + 4) % 7] + (12 if degree + 4 >= 7 else 0)]
        if rng.uniform() < 0.4:
            chord.append(chord[0] + 12)
        dur = dur_beats * beat * rng.uniform(1.1, 1.6)
        n = min(int(dur * CORPUS_SR), len(out) - int(t * CORPUS_SR))
        if n <= 0:
            break
        tt = np.arange(n) / CORPUS_SR
        seg = np.zeros(n)
        for iv in chord:
            f0 = root * SEMITONE ** iv
            if f0 > 0.2 * CORPUS_SR:
                continue
            # 2-op FM: modulator at ~an octave+fifth, index decays fast
            # (bright strike -> mellow sustain), detuned 'tine' partial
            ratio = rng.choice([2.0, 3.0, 14.0]) * (1.0 + rng.normal(0, 1e-3))
            index = rng.uniform(1.5, 3.5) * np.exp(-tt / 0.06)
            ph = rng.uniform(0, 2 * np.pi)
            carrier = np.sin(
                2 * np.pi * f0 * tt + ph
                + index * np.sin(2 * np.pi * f0 * ratio * tt)
            )
            tine = 0.25 * np.sin(2 * np.pi * f0 * 6.27 * tt) * np.exp(-tt / 0.05)
            amp = rng.uniform(0.5, 0.9) * np.exp(-tt / (0.35 * dur))
            seg += amp * (carrier + tine)
        # key-click transient
        click = np.diff(rng.uniform(-1, 1, n + 1)) * 0.02 * np.exp(-tt / 0.01)
        i = int(t * CORPUS_SR)
        out[i : i + n] += (seg * 0.3 + click) * np.clip(tt / 0.004, 0, 1)
        t += dur_beats * beat
    out = out[:n_samples]
    peak = np.abs(out).max()
    return (0.7 * out / max(peak, 1e-6)).astype(np.float32)


STYLES = {
    "riffs": render_riff,
    "pads": render_pads,
    "vocal": render_vocal,
    "drums": render_drums,
    "bass": render_bass,
    "keys": render_keys,
}


def write_synthetic_corpus(
    out_root: str, n_train: int = 32, n_val: int = 8, dur_s: float = 12.0, style: str = "riffs"
) -> list:
    """Synthetic audio as PCM16 wavs under `out_root/{train,val}`, named
    `<style>_<seed>_<bpm>bpm.wav` (the idmt split convention), each file
    drawn from its own seed: the corpus `scripts/make_synthetic_corpus.py
    [out_root] [n_train] [n_val] [dur_s] [--style <style>]` writes, byte for
    byte.  `style` is one of `STYLES`: the Karplus-Strong guitar riffs
    (default), or the unseen-audio domains pads, vocal, drums, bass, keys.
    Returns the paths written."""
    render = STYLES[style]
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
            path = os.path.join(d, f"{style}_{seed0 + i}_{bpm}bpm.wav")
            wav_write(path, render(rng, n_samples, bpm), CORPUS_SR)
            paths.append(path)
    return paths


# the fixed flanger that makes a dry/wet fit's wet corpus: 1 ms + 10 ms lines
WET_FLANGER = dict(rate_hz=0.8, min_delay_width=0.5, width=1.0, feedback=0.5, depth=0.7, mix=1.0)


def write_wet_corpus(dry_root: str | Path, wet_root: str | Path, device: str | torch.device = "cuda") -> int:
    """Each split's dry files through K1 (`ops/fx_kernels.py::flanger`) on
    `device` at fixed parameters (`WET_FLANGER`: a 0.8 Hz triangle LFO over
    the 1 ms + 10 ms flanger), written as PCM16 under the same names in
    `wet_root`; returns the K1 calls made."""
    from mod_extraction_tpu_torch.data.wav import wav_read
    from mod_extraction_tpu_torch.ops import fx_kernels

    device = resolve_device(device)
    calls = 0
    for split_dir in sorted(p for p in Path(dry_root).iterdir() if p.is_dir()):
        paths = sorted(split_dir.glob("*.wav"))
        reads = [wav_read(str(p)) for p in paths]
        sr = float(reads[0][1])
        dry = np.stack([audio for audio, _ in reads])  # (n, 1, T)
        n, t = dry.shape[0], dry.shape[-1]
        mod = np_make_mod_signal(t, sr, WET_FLANGER["rate_hz"], 0.0, "tri")
        delay = round(10.0 / 1000 * sr) * WET_FLANGER["width"] * mod + WET_FLANGER["min_delay_width"] * round(
            1.0 / 1000 * sr)
        par = {k: torch.full((n, 1, 1), WET_FLANGER[k], device=device) for k in ("feedback", "depth", "mix")}
        wet = fx_kernels.flanger(
            torch.from_numpy(dry).to(device),
            torch.from_numpy(np.broadcast_to(delay, (n, 1, t)).astype(np.float32)).to(device),
            par["feedback"], par["depth"], par["mix"], flanger_max_delay_samples(*FLANGER_DELAYS_MS, sr))
        calls += 1
        out = Path(wet_root) / split_dir.name
        out.mkdir(parents=True, exist_ok=True)
        for p, w in zip(paths, wet.cpu().numpy()):
            wav_write(str(out / p.name), w, int(sr))
    return calls


def fit_config(path: str, corpus: str | Path, wet: Optional[str | Path], train_batches: int,
               val_batches: int = 1) -> dict:
    """The shipped training config at `path` with its data directories on
    `corpus` (and `wet`, for dry/wet pairs), `train_batches` train batches
    and `val_batches` val batches an epoch and a log line a step; batch
    size, widths, optimizer, schedule and weights as shipped."""
    from mod_extraction_tpu_torch.cli import load_yaml_with_includes

    corpus = Path(corpus)
    cfg = load_yaml_with_includes(path)
    args = cfg["data"]["init_args"]
    bs = args["batch_size"]
    if "shared_train_args" in args:  # interwoven
        for split, n in (("train", train_batches), ("val", val_batches)):
            args[f"shared_{split}_args"].update(input_dir=str(corpus / split), num_examples_per_epoch=n * bs)
    else:  # dry/wet pairs
        for split in ("train", "val"):
            args[f"dry_{split}_dir"] = str(corpus / split)
            args[f"wet_{split}_dir"] = str(Path(wet) / split)
        args["train_num_examples_per_epoch"] = train_batches * bs
        args["val_num_examples_per_epoch"] = val_batches * bs
    cfg["custom"]["log_every_n_steps"] = 1
    return cfg
