"""Linear resampling along the last dimension (port of
`mod_extraction_tpu/utils/interp.py`) with `F.interpolate(mode="linear",
align_corners=True)` semantics.  Gather indices and fractions are computed
on the host in float64, as torch's own index math does."""

from __future__ import annotations

import numpy as np
import torch


def linear_interpolate_last_dim(x: torch.Tensor, n: int) -> torch.Tensor:
    """Resample `x` to length `n` along the last dim (any leading dims),
    align_corners=True: source position i * (n_in - 1) / (n - 1)."""
    n_in = x.shape[-1]
    if n_in == n:
        return x
    i = np.arange(n, dtype=np.float64)
    src = np.zeros(1) if n == 1 else i * (n_in - 1) / (n - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = torch.as_tensor((src - lo).astype(np.float32), device=x.device)
    x_lo = x.index_select(-1, torch.as_tensor(lo, device=x.device))
    x_hi = x.index_select(-1, torch.as_tensor(hi, device=x.device))
    return x_lo + (x_hi - x_lo) * frac.to(x.dtype)
