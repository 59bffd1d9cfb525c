"""Losses (port of part of `mod_extraction_tpu/losses/losses.py`): l1,
mse, fdl1 and sdl1 for the stage-1 extractor, esr and dc for the stage-2
effect model, and the weighted loss dict.  Every loss is `(y_hat, y, weights=None) -> scalar`,
with `weights` an optional (B,) per-example weight."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def _wmean(per_example: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over examples (axis 0); extra axes are averaged first."""
    if per_example.ndim > 1:
        per_example = per_example.reshape(per_example.shape[0], -1).mean(dim=-1)
    if weights is None:
        return per_example.mean()
    w = weights.to(per_example.dtype)
    return (per_example * w).sum() / torch.clamp(w.sum(), min=1e-8)


def l1_loss(y_hat, y, weights=None):
    return _wmean(torch.abs(y_hat - y), weights)


def mse_loss(y_hat, y, weights=None):
    return _wmean((y_hat - y) ** 2, weights)


def esr_loss(y_hat, y, weights=None, eps: float = 1e-8):
    """Error-to-signal ratio: per (B, C) the error energy over the target
    energy along the last dim, then the mean."""
    num = ((y - y_hat) ** 2).sum(dim=-1)
    denom = (y**2).sum(dim=-1) + eps
    return _wmean(num / denom, weights)


def dc_loss(y_hat, y, weights=None, eps: float = 1e-8):
    """DC offset: squared mean error over the mean target energy."""
    num = (y - y_hat).mean(dim=-1) ** 2
    denom = (y**2).mean(dim=-1) + eps
    return _wmean(num / denom, weights)


def _central_diff(x):
    return (x[..., 2:] - x[..., :-2]) / 2.0


def first_derivative_l1_loss(y_hat, y, weights=None):
    """L1 of central differences."""
    return _wmean(torch.abs(_central_diff(y_hat) - _central_diff(y)), weights)


def second_derivative_l1_loss(y_hat, y, weights=None):
    """L1 of twice-applied central differences."""
    d2h = _central_diff(_central_diff(y_hat))
    d2 = _central_diff(_central_diff(y))
    return _wmean(torch.abs(d2h - d2), weights)


LossFn = Callable[..., torch.Tensor]

_LOSS_REGISTRY: Dict[str, LossFn] = {
    "l1": l1_loss,
    "fdl1": first_derivative_l1_loss,
    "sdl1": second_derivative_l1_loss,
    "mse": mse_loss,
    "esr": esr_loss,
    "dc": dc_loss,
}


class WeightedLossDict:
    """Every named loss is computed and returned as a metric (zero-weight
    ones too); the total sums the positive-weight terms."""

    def __init__(self, loss_dict: Optional[Dict[str, float]] = None):
        if loss_dict is None:
            loss_dict = {"l1": 1.0, "mse": 0.0}
        unknown = set(loss_dict) - set(_LOSS_REGISTRY)
        if unknown:
            raise KeyError(f"Unknown loss: {sorted(unknown)}")
        self.loss_dict = dict(loss_dict)

    def __call__(
        self, y_hat, y, weights=None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        metrics = {}
        total = torch.zeros((), dtype=torch.float32, device=y_hat.device)
        for name, weight in self.loss_dict.items():
            val = _LOSS_REGISTRY[name](y_hat, y, weights)
            metrics[name] = val
            if weight > 0:
                total = total + weight * val
        metrics["loss"] = total
        return total, metrics
