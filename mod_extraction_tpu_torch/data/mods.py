"""Host-side (numpy) LFO generator, copied from
`mod_extraction_tpu/data/mods.py::np_make_mod_signal` with the canonical
shape order of `mod_extraction_tpu/ops/lfo.py::LFO_SHAPES`."""

from __future__ import annotations

import numpy as np

# Canonical shape order. Index IS the wire format for fx["shape"].
LFO_SHAPES = ("cos", "rect_cos", "inv_rect_cos", "tri", "saw", "rsaw", "sqr")


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
