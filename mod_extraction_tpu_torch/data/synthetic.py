"""Synthetic batches (no audio files needed) for tests and the chip smoke
run: numpy copies of `mod_extraction_tpu/data/synthetic.py::
make_synthetic_batch` and (its audio-array case) `data/loader.py::collate`,
plus the interwoven
(flanger + chorus + phaser) batch the stage-1 path trains on."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from mod_extraction_tpu_torch.data.constants import (
    EFFECT_FLANGER_CHORUS,
    EFFECT_PHASER,
    EFFECT_TREMOLO,
    FX_FLOAT_KEYS,
    FX_INT_KEYS,
    MOD_SIG_DIVISOR,
    default_fx,
)
from mod_extraction_tpu_torch.data.mods import LFO_SHAPES, np_make_mod_signal
from mod_extraction_tpu_torch.utils.device import resolve_device

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


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack (dry, mod_sig, fx) example dicts into a numpy batch dict."""
    batch = {
        "dry": np.stack([it["dry"] for it in items]).astype(np.float32),
        "mod_sig": np.stack([it["mod_sig"] for it in items]).astype(np.float32),
    }
    fx: Dict[str, np.ndarray] = {}
    for k in FX_FLOAT_KEYS:
        fx[k] = np.asarray([it["fx"].get(k, 0.0) for it in items], np.float32)
    for k in FX_INT_KEYS:
        fx[k] = np.asarray([it["fx"].get(k, 0) for it in items], np.int32)
    batch["fx"] = fx
    return batch


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
