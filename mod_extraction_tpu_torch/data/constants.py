"""Effect codes and fx-parameter keys (copy of the constants in
`mod_extraction_tpu/data/datasets.py`)."""

from __future__ import annotations

from typing import Any, Dict

EFFECT_NONE = 0
EFFECT_TREMOLO = 1
EFFECT_FLANGER_CHORUS = 2
EFFECT_PHASER = 3

# LFO frame rate divisor: mod signals are rendered at sr / 100.
MOD_SIG_DIVISOR = 100

FX_FLOAT_KEYS = (
    "rate_hz",
    "phase",
    "exp",
    "depth",
    "feedback",
    "mix",
    "width",
    "min_delay_width",
    "max_lfo_delay_ms",
    "max_min_delay_ms",
    "centre_frequency_hz",
)
FX_INT_KEYS = ("effect_idx", "shape")


def default_fx() -> Dict[str, Any]:
    fx = {k: 0.0 for k in FX_FLOAT_KEYS}
    fx.update({k: 0 for k in FX_INT_KEYS})
    return fx
