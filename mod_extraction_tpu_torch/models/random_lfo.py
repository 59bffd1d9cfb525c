"""RandomLFO baseline "model" (port of
`mod_extraction_tpu/models/random_lfo.py`): random LFO batches, optionally
anchored to ground-truth fx params with a controlled phase and frequency
error.  It has no parameters; a small dataclass lets the task layer treat
it like the other extractors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from mod_extraction_tpu_torch.ops.lfo import make_rand_mod_signal


@dataclass(frozen=True)
class RandomLFO:
    n_samples: int
    sr: float
    use_shape_gt: bool = False
    use_phase_gt: bool = False
    use_freq_gt: bool = False
    shapes: Optional[Sequence[str]] = None
    freq_min: float = 0.5
    freq_max: float = 3.0
    phase_error: float = 0.0
    freq_error: float = 0.0

    def __call__(
        self,
        generator: Optional[torch.Generator],
        batch_size: int,
        fx_params: Optional[dict] = None,
        draws: Optional[dict] = None,
        device: str | torch.device = "cpu",
    ) -> torch.Tensor:
        """Returns (B, 1, n_samples) on `device`; `draws` as in
        `make_rand_mod_signal`."""
        shapes_gt = phase_gt = freq_gt = None
        if self.use_shape_gt:
            assert fx_params is not None and "shape" in fx_params
            shapes_gt = fx_params["shape"]
        if self.use_phase_gt:
            assert fx_params is not None and "phase" in fx_params
            phase_gt = fx_params["phase"]
        if self.use_freq_gt:
            assert fx_params is not None and "rate_hz" in fx_params
            freq_gt = fx_params["rate_hz"]
        out = make_rand_mod_signal(
            generator, batch_size, self.n_samples, self.sr, self.freq_min, self.freq_max,
            shapes_gt, self.shapes, phase_gt, self.phase_error, freq_gt, self.freq_error,
            draws=draws, device=device,
        )
        return out[:, None, :]
