"""Host-side (numpy) mod-signal generators for the input pipeline (the
port's copy of `mod_extraction_tpu/data/mods.py`, in the same numpy order,
with the canonical shape order of `mod_extraction_tpu/ops/lfo.py::
LFO_SHAPES`).

The quasiperiodic / combined / concave-convex LFO variants have
data-dependent segment counts and lengths, so they run on the host in the
input pipeline at the LFO frame rate (sr / 100), hundreds of samples per
example.  `np_make_mod_signal` follows `ops/lfo.py`'s phase convention, so
host- and device-generated LFOs are interchangeable.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Canonical shape order. Index IS the wire format for fx["shape"].
LFO_SHAPES = ("cos", "rect_cos", "inv_rect_cos", "tri", "saw", "rsaw", "sqr")


def np_linear_interp(x: np.ndarray, n: int) -> np.ndarray:
    """align_corners=True linear resample of a 1-D array."""
    n_in = x.shape[-1]
    if n_in == n:
        return x
    src = np.zeros(1) if n == 1 else np.arange(n) * (n_in - 1) / (n - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = src - lo
    return (x[..., lo] * (1 - frac) + x[..., hi] * frac).astype(x.dtype)


def np_make_mod_signal(
    n_samples: int,
    sr: float,
    freq: float,
    phase: float = 0.0,
    shape: str = "cos",
    exp: float = 1.0,
) -> np.ndarray:
    """Unipolar [0, 1] LFO; argument at index i is 2*pi*f*(i+1)/sr + phase,
    and the rectified shapes halve frequency and phase."""
    assert shape in LFO_SHAPES
    if shape in ("rect_cos", "inv_rect_cos"):
        freq, phase = freq / 2.0, phase / 2.0
    arg = 2.0 * np.pi * freq * np.arange(1, n_samples + 1) / sr + phase
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


def np_find_corners(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1-D top/bottom corner masks (same rule as ops/corners.find_corners)."""
    diff = m[1:] - m[:-1]
    dr, dl = diff[1:], diff[:-1]
    pos = np.where(dl > 0, dl, 0.0)
    neg = np.where(dl < 0, dl, 0.0)
    top = -np.floor(pos * (dr + 1e-16)).astype(np.int64)
    bot = -np.floor(neg * (dr + 1e-16)).astype(np.int64)
    z = np.zeros(1, np.int64)
    return np.concatenate([z, top, z]), np.concatenate([z, bot, z])


def _time_stretch_section(
    rng: np.random.Generator, section, l_min, l_max, r_min, r_max, lr_split
):
    """reference `_time_stretch_section` (`modulations.py:104-118`)."""
    size = section.shape[0]
    if rng.uniform() < lr_split:
        x = int(rng.uniform(l_min, l_max) * size + 0.5)
        new_size = max(2, size - x)
    else:
        x = int(rng.uniform(r_min, r_max) * size + 0.5)
        new_size = size + x
    return np_linear_interp(section, new_size)


def make_quasi_periodic(
    rng: np.random.Generator,
    mod_sig: np.ndarray,
    l_min: float = 0.2,
    l_max: float = 0.2,
    r_min: float = 0.2,
    r_max: float = 0.2,
    lr_split: float = 0.5,
) -> np.ndarray:
    """Randomly time-stretch the sections between corners
    (`modulations.py:121-160`): shrink by U[l_min,l_max] or grow by
    U[r_min,r_max], re-concatenate, crop/pad back to the original length."""
    assert mod_sig.ndim == 1
    top, bottom = np_find_corners(mod_sig)
    corners = top if top.sum() > bottom.sum() else bottom
    idxs = np.nonzero(corners == 1)[0].tolist()
    if len(idxs) < 2:
        return mod_sig

    prev = 0
    sections = []
    total = 0
    for idx in idxs:
        sec = _time_stretch_section(
            rng, mod_sig[prev : idx + 1], l_min, l_max, r_min, r_max, lr_split
        )[:-1]
        total += sec.shape[0]
        sections.append(sec)
        prev = idx
    orig = mod_sig.shape[0]
    tail = mod_sig[prev:orig]
    total += tail.shape[0]
    if total < orig:
        tail = np_linear_interp(tail, tail.shape[0] + (orig - total))
    sections.append(tail)
    out = np.concatenate(sections)[:orig]
    return out.astype(np.float32)


def make_concave_convex_mod_sig(
    rng: np.random.Generator,
    n_samples: int,
    sr: float,
    freq: float,
    phase: float = 0.0,
    concave_min: float = 0.2,
    concave_max: float = 1.0,
    convex_min: float = 1.0,
    convex_max: float = 3.0,
    concave_prob: float = 0.5,
) -> np.ndarray:
    """Per-section random exponent on a triangle LFO (`modulations.py:163-188`)."""
    m = np_make_mod_signal(n_samples, sr, freq, phase, "tri")
    top, bottom = np_find_corners(m)
    idxs = np.nonzero((top + bottom) == 1)[0].tolist() + [n_samples]
    exp = np.ones_like(m)
    prev = 0
    for idx in idxs:
        if rng.uniform() < concave_prob:
            e = rng.uniform(concave_min, concave_max)
        else:
            e = rng.uniform(convex_min, convex_max)
        exp[prev:idx] = e
        prev = idx
    return (m**exp).astype(np.float32)


def make_combined_mod_sig(
    rng: np.random.Generator,
    n_samples: int,
    sr: float,
    freq: float,
    phase: float,
    shapes: Sequence[str],
) -> np.ndarray:
    """Replace each period (between bottom corners) with a freshly sampled
    shape (`modulations.py:191-210`)."""
    cur = shapes[rng.integers(len(shapes))]
    m = np_make_mod_signal(n_samples, sr, freq, phase, cur)
    _, bottom = np_find_corners(m)
    idxs = np.nonzero(bottom == 1)[0].tolist()
    if len(idxs) > 1:
        for i, idx in enumerate(idxs[1:]):
            prev = idxs[i]
            seg_len = idx - prev + 1
            cur = shapes[rng.integers(len(shapes))]
            m[prev : idx + 1] = np_make_mod_signal(seg_len, seg_len, 1.0, 0.0, cur)
    return m
