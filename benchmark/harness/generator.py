"""The one traffic generator: it reads a mix's parameters
(`benchmark/traffic/<mix>.json`) and makes, from the run's seed, the audio
and the per-row parameters that both the program and the reference get.

The dry audio is `make_synthetic_batch`'s filtered noise (white noise
through a 64-tap box filter, scaled to a peak), copied from the port's
`data/synthetic.py` and made in bulk on the device.  The LFO and effect
draws copy the training data modules' draws (`data/datasets.py`,
`data/mods.py`): log-uniform rates, the mix's ranges, the six shapes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

EFFECT_FLANGER_CHORUS = 2
EFFECT_PHASER = 3
MOD_SIG_DIVISOR = 100
LFO_SHAPES = ("cos", "rect_cos", "inv_rect_cos", "tri", "saw", "rsaw", "sqr")
FX_FLOAT_KEYS = ("rate_hz", "phase", "exp", "depth", "feedback", "mix", "width",
                 "min_delay_width", "max_lfo_delay_ms", "max_min_delay_ms", "centre_frequency_hz")
FX_INT_KEYS = ("effect_idx", "shape")


def filtered_noise(gen: torch.Generator, n: int, seg: int, peak: float, device) -> torch.Tensor:
    """(n,) float32: white noise through a 64-tap box filter (gain 4), each
    `seg` samples scaled to `peak`."""
    white = torch.randn(n + 63, generator=gen, device=device)
    box = torch.full((1, 1, 64), 1.0 / 16.0, device=device)
    dry = torch.nn.functional.conv1d(white[None, None], box)[0, 0]
    n_seg = -(-n // seg)
    dry = torch.nn.functional.pad(dry, (0, n_seg * seg - n)).reshape(n_seg, seg)
    dry = peak * dry / dry.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    return dry.reshape(-1)[:n]


def make_corpus(seed: int, seconds: float, sr: int, peak: float, seg: int, device) -> torch.Tensor:
    """The int16 PCM dry corpus held on the device, from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = filtered_noise(gen, int(seconds * sr), seg, peak, device)
    return torch.round(x * 32767.0).clamp(-32768, 32767).to(torch.int16)


def mod_signal(n: int, sr: float, freq: float, phase: float, shape: str, exp: float = 1.0) -> np.ndarray:
    """Unipolar [0, 1] LFO (`data/mods.py::np_make_mod_signal`)."""
    if shape in ("rect_cos", "inv_rect_cos"):
        freq, phase = freq / 2.0, phase / 2.0
    arg = 2.0 * np.pi * freq * np.arange(1, n + 1) / sr + phase
    saw = np.mod(arg, 2.0 * np.pi) / (2.0 * np.pi)
    if shape == "cos":
        y = (np.cos(arg + np.pi) + 1.0) / 2.0
    elif shape == "rect_cos":
        y = np.abs(np.cos(arg + np.pi / 2.0))
    elif shape == "inv_rect_cos":
        y = 1.0 - np.abs(np.cos(arg))
    elif shape == "sqr":
        y = (np.sign(np.cos(arg + np.pi)) + 1.0) / 2.0
    elif shape == "saw":
        y = saw
    elif shape == "rsaw":
        y = 1.0 - saw
    else:  # tri
        t2 = 2.0 * saw
        y = np.where(t2 > 1.0, 2.0 - t2, t2)
    if exp != 1.0:
        y = y**exp
    return y.astype(np.float32)


def _log_uniform(rng, r) -> float:
    return float(np.exp(rng.uniform(np.log(r["min"]), np.log(r["max"]))))


def _uniform(rng, r) -> float:
    return float(rng.uniform(r["min"], r["max"]))


def draw_row(rng: np.random.Generator, group: dict, n_frames: int, frame_sr: float) -> tuple:
    """(mod_sig (n_frames,), fx dict) of one row of a mix group."""
    fx = {k: 0.0 for k in FX_FLOAT_KEYS}
    fx.update({k: 0 for k in FX_INT_KEYS})
    if group["effect"] == "phaser":
        fx.update(effect_idx=EFFECT_PHASER, rate_hz=_log_uniform(rng, group["rate_hz"]),
                  depth=_uniform(rng, group["depth"]),
                  centre_frequency_hz=_log_uniform(rng, group["centre_frequency_hz"]),
                  feedback=_uniform(rng, group["feedback"]), mix=_uniform(rng, group["mix"]),
                  phase=float(rng.uniform(0.0, 2.0 * np.pi)), shape=LFO_SHAPES.index("cos"), exp=1.0)
        return np.zeros(n_frames, np.float32), fx
    rate = _log_uniform(rng, group["rate_hz"])
    phase = float(rng.uniform(0.0, 2.0 * np.pi))
    shape = group["shapes"][int(rng.integers(len(group["shapes"])))]
    mod = mod_signal(n_frames, frame_sr, rate, phase, shape)
    fx.update(effect_idx=EFFECT_FLANGER_CHORUS, rate_hz=rate, phase=phase,
              shape=LFO_SHAPES.index(shape), exp=1.0,
              max_min_delay_ms=group["max_min_delay_ms"], max_lfo_delay_ms=group["max_lfo_delay_ms"],
              feedback=_uniform(rng, group["feedback"]),
              min_delay_width=_uniform(rng, group["min_delay_width"]),
              width=_uniform(rng, group["width"]), depth=_uniform(rng, group["depth"]),
              mix=_uniform(rng, group["mix"]))
    return mod, fx


def make_pool(seed: int, traffic: dict, n_samples: int, sr: int, corpus_len: int) -> Dict:
    """`traffic["pool_batches"]` batches of the mix, drawn on the host from
    the seed: numpy arrays with a leading pool axis.  Each row's chunk
    starts at a uniform offset into the corpus, with gain 1 (the shipped
    data configs leave peak normalisation off)."""
    rng = np.random.default_rng(seed)
    n_frames = n_samples // MOD_SIG_DIVISOR
    frame_sr = sr / MOD_SIG_DIVISOR
    pool: List[Dict] = []
    for _ in range(traffic["pool_batches"]):
        mods, fxs = [], []
        for group in traffic["mix"]:
            for _ in range(group["rows"]):
                m, fx = draw_row(rng, group, n_frames, frame_sr)
                mods.append(m)
                fxs.append(fx)
        b = len(mods)
        pool.append({
            "dry_idx": rng.integers(0, corpus_len - n_samples, size=b).astype(np.int32),
            "dry_gain": np.ones(b, np.float32),
            "mod_sig": np.stack(mods),
            "fx": {k: np.asarray([f[k] for f in fxs], np.float32 if k in FX_FLOAT_KEYS else np.int32)
                   for k in FX_FLOAT_KEYS + FX_INT_KEYS},
        })
    return {k: (np.stack([p[k] for p in pool]) if k != "fx"
                else {f: np.stack([p["fx"][f] for p in pool]) for f in pool[0]["fx"]})
            for k in pool[0]}


def pool_batch(pool: Dict, i: int) -> Dict:
    """Batch i of a pool (views, no copy)."""
    return {k: (v[i] if k != "fx" else {f: a[i] for f, a in v.items()}) for k, v in pool.items()}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def mask_draws(seed: int, n: int) -> torch.Tensor:
    """SpecAugment's four U[0, 1) numbers for each of n steps (host)."""
    return torch.rand(n, 4, generator=torch.Generator().manual_seed(seed))


def stream_input(seed: int, n: int, channels: int, sr: int, peak: float, device) -> np.ndarray:
    """(channels, n) float32 filtered noise for a stream, from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = filtered_noise(gen, channels * n, 2 * sr, peak, device)
    return x.reshape(channels, n).cpu().numpy()


def effects(traffic: dict) -> tuple:
    """The effect codes a mix renders."""
    return tuple(sorted({EFFECT_PHASER if g["effect"] == "phaser" else EFFECT_FLANGER_CHORUS
                         for g in traffic["mix"]}))


def max_delay_samples(traffic: dict, sr: float) -> int:
    """The delay line that holds every flanger/chorus group of a mix: the
    largest round-half-up max_min + max_lfo delay (0 without one)."""
    return max([int(g["max_min_delay_ms"] / 1000.0 * sr + 0.5) + int(g["max_lfo_delay_ms"] / 1000.0 * sr + 0.5)
                for g in traffic["mix"] if g["effect"] != "phaser"] or [0])
