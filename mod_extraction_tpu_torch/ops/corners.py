"""LFO post-processing (port of `mod_extraction_tpu/ops/corners.py::smoothen`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smoothen(x: torch.Tensor, smooth_n_frames: int) -> torch.Tensor:
    """Stride-1 moving average over the last dim (unfold-mean semantics):
    the length shrinks to T - smooth_n_frames + 1.  Computed from a
    cumulative sum, as the JAX package does."""
    if smooth_n_frames <= 1:
        return x
    w = smooth_n_frames
    cs = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    return (cs[..., w:] - cs[..., :-w]) / w
