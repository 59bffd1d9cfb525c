"""Wright's (CoreAudioML) losses, the numerical-parity companions of the
loss registry (port of `mod_extraction_tpu/losses/wright.py`).

They stay out of the registry, as in the JAX package: `wright_esr_loss`
and `wright_dc_loss` take eps 0 and global means, where the registry's
`esr` and `dc` reduce per example and take weights."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def wright_esr_loss(output: torch.Tensor, target: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Error-to-signal ratio over global means."""
    loss = torch.mean((target - output) ** 2)
    energy = torch.mean(target**2) + eps
    return loss / energy


def wright_dc_loss(output: torch.Tensor, target: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Squared difference of the axis-0 means over the target's energy."""
    diff = torch.mean(target, dim=0) - torch.mean(output, dim=0)
    loss = torch.mean(diff**2)
    energy = torch.mean(target**2) + eps
    return loss / energy


def _fir(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """(T, B, 1) signals through an FIR, correlated as a torch Conv1d does
    (no flip), the time axis zero-padded in front so the length stays T."""
    t = x.shape[0]
    xp = torch.cat([x.new_zeros((len(taps) - 1,) + x.shape[1:]), x])
    acc = torch.zeros_like(x)
    for k, c in enumerate(taps):
        acc = acc + c * xp[k : k + t]  # the tap rounds to x's dtype
    return acc


def wright_pre_emph(
    output: torch.Tensor, target: torch.Tensor, filter_cfs: Sequence[float], low_pass: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIR pre-emphasis of (T, B, 1) signals; `low_pass` adds the 2-tap
    [0.85, 1] filter after it."""
    out, tgt = _fir(output, filter_cfs), _fir(target, filter_cfs)
    if low_pass:
        out, tgt = _fir(out, (0.85, 1.0)), _fir(tgt, (0.85, 1.0))
    return out, tgt
