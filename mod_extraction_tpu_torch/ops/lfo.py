"""LFO synthesis: unipolar [0, 1] modulation signals (port of
`mod_extraction_tpu/ops/lfo.py`).

Fully batched: one call renders a batch with per-example frequency, phase,
shape and exponent.  Shapes are integer codes into `LFO_SHAPES`.  The
argument at index i is 2*pi*f*(i+1)/sr + phase (a cumulative sum over a
constant step), and the rectified shapes halve frequency and phase.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# Canonical shape order. Index IS the wire format for fx_params["shape"].
LFO_SHAPES = ("cos", "rect_cos", "inv_rect_cos", "tri", "saw", "rsaw", "sqr")
_SHAPE_IDX = {name: idx for idx, name in enumerate(LFO_SHAPES)}

# Default sampling pool for random LFOs.
DEFAULT_RAND_SHAPES = ("cos", "tri", "rect_cos", "inv_rect_cos", "saw", "rsaw")


def shape_to_idx(shape) -> int:
    """Map a shape name (or pass through an int code) to its integer code."""
    if isinstance(shape, str):
        return _SHAPE_IDX[shape]
    return int(shape)


def make_mod_signal_batch(
    n_samples: int,
    sr: float,
    freq: torch.Tensor,
    phase: torch.Tensor,
    shape_idx: torch.Tensor,
    exp: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """Render a batch of unipolar LFOs.

    freq (B,) in Hz with 0 < freq < sr/2, phase (B,) in radians, shape_idx
    (B,) integer codes into LFO_SHAPES, exp a scalar or (B,) exponent
    distortion.  Returns (B, n_samples) float32 in [0, 1], on freq's device."""
    freq = torch.as_tensor(freq, dtype=torch.float32).reshape(-1)
    dev = freq.device
    phase = torch.as_tensor(phase, dtype=torch.float32, device=dev).reshape(-1)
    shape_idx = torch.as_tensor(shape_idx, device=dev).to(torch.int64).reshape(-1)
    exp = torch.as_tensor(exp, dtype=torch.float32, device=dev).broadcast_to(freq.shape)

    is_rect = (shape_idx == _SHAPE_IDX["rect_cos"]) | (shape_idx == _SHAPE_IDX["inv_rect_cos"])
    freq = torch.where(is_rect, freq / 2.0, freq)
    phase = torch.where(is_rect, phase / 2.0, phase)

    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=dev)
    t = torch.arange(1, n_samples + 1, dtype=torch.float32, device=dev)
    argument = (two_pi / sr) * freq[:, None] * t[None, :] + phase[:, None]
    saw = torch.remainder(argument, two_pi) / two_pi

    cos_wave = (torch.cos(argument + pi) + 1.0) / 2.0
    rect_cos = torch.abs(torch.cos(argument + pi / 2.0))
    inv_rect_cos = 1.0 - torch.abs(torch.cos(argument))
    sqr = (torch.sign(torch.cos(argument + pi)) + 1.0) / 2.0
    rsaw = 1.0 - saw
    tri2 = 2.0 * saw
    tri = torch.where(tri2 > 1.0, 2.0 - tri2, tri2)

    stacked = torch.stack([cos_wave, rect_cos, inv_rect_cos, tri, saw, rsaw, sqr], dim=0)
    mod_sig = torch.gather(stacked, 0, shape_idx[None, :, None].expand(1, -1, n_samples))[0]
    return torch.where(exp[:, None] == 1.0, mod_sig, torch.pow(mod_sig, exp[:, None]))


def make_mod_signal(
    n_samples: int,
    sr: float,
    freq: float,
    phase: float = 0.0,
    shape: str = "cos",
    exp: float = 1.0,
) -> torch.Tensor:
    """Single-example convenience wrapper: (n_samples,)."""
    return make_mod_signal_batch(
        n_samples, sr, torch.tensor([freq]), torch.tensor([phase]),
        torch.tensor([shape_to_idx(shape)]), torch.tensor([exp]),
    )[0]


def make_rand_mod_signal(
    generator: Optional[torch.Generator],
    batch_size: int,
    n_samples: int,
    sr: float,
    freq_min: float,
    freq_max: float,
    shapes_gt: Optional[torch.Tensor] = None,
    shapes: Optional[Sequence[str]] = None,
    phase_gt: Optional[torch.Tensor] = None,
    phase_error: float = 0.5,
    freq_gt: Optional[torch.Tensor] = None,
    freq_error: float = 0.25,
    draws: Optional[dict] = None,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Batched random LFO, optionally anchored to ground-truth fx params:
    * with phase_gt: phase = (gt + U[-1, 1) * pi * phase_error) mod 2pi
    * with freq_gt:  freq = clip(gt * U[1-e, 1+e), freq_min, freq_max)
    * shapes drawn from `shapes` (default pool) unless shapes_gt (integer
      codes) is given.

    The random numbers come from `generator` (a CPU `torch.Generator`), or
    from `draws` when given: a dict with "phase" and "freq", (B,) uniforms
    in [0, 1), and "shape", (B,) integer positions in the pool.  The JAX
    package draws with threefry, whose numbers a torch generator cannot
    give, so the tests feed both sides the same draws.  Returns (B,
    n_samples) on `device`."""
    if shapes is None:
        shapes = DEFAULT_RAND_SHAPES
    dev = torch.device(device)

    def uniform(name: str) -> torch.Tensor:
        if draws is not None:
            return torch.tensor(draws[name], dtype=torch.float32).reshape(-1).to(dev)
        return torch.rand(batch_size, generator=generator).to(dev)

    def scaled(name: str, low: float, high: float) -> torch.Tensor:
        return uniform(name) * (high - low) + low

    two_pi = 2.0 * math.pi
    if phase_gt is not None:
        phase = torch.as_tensor(phase_gt, dtype=torch.float32).reshape(-1).to(dev)
        if phase_error > 0:
            phase = phase + scaled("phase", -1.0, 1.0) * math.pi * phase_error
            phase = torch.remainder(phase + two_pi, two_pi)
    else:
        phase = scaled("phase", 0.0, two_pi)

    if freq_gt is not None:
        freq = torch.as_tensor(freq_gt, dtype=torch.float32).reshape(-1).to(dev)
        if freq_error > 0:
            freq = torch.clamp(
                freq * scaled("freq", 1.0 - freq_error, 1.0 + freq_error), freq_min, freq_max
            )
    else:
        freq = scaled("freq", freq_min, freq_max)

    if shapes_gt is not None:
        shape_idx = torch.as_tensor(shapes_gt).reshape(-1).to(dev)
    else:
        pool = torch.tensor([shape_to_idx(s) for s in shapes], dtype=torch.int64, device=dev)
        if draws is not None:
            pick = torch.tensor(draws["shape"], dtype=torch.int64).reshape(-1).to(dev)
        else:
            pick = torch.randint(0, len(shapes), (batch_size,), generator=generator).to(dev)
        shape_idx = pool[pick]

    return make_mod_signal_batch(n_samples, sr, freq, phase, shape_idx)
