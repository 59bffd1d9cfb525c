"""Shared building blocks (port of `mod_extraction_tpu/models/common.py`),
in NCHW layout."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax `lecun_normal`: truncated normal in [-2, 2] std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class PReLU(nn.Module):
    """Per-channel PReLU on (B, C, ...) input.  The float32 alpha promotes
    the negative branch, so a bf16 input yields a float32 output (the JAX
    trunk's `act_io_dtype="float32"` behaviour).  `keep_dtype=True` computes
    `alpha * x` in x's dtype instead, so a bf16 activation stream stays bf16
    (`act_io_dtype="compute"`)."""

    def __init__(self, num_parameters: int, init: float = 0.25, keep_dtype: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_parameters,), init))
        self.keep_dtype = keep_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
        if self.keep_dtype:
            a = a.to(x.dtype)
        return torch.where(x >= 0, x, a * x)


def layer_norm_no_affine(
    x: torch.Tensor,
    dims: Sequence[int],
    eps: float = 1e-5,
    stat_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Affine-free LayerNorm over `dims` (biased variance, as torch and
    jnp.var).  By default statistics and result are float32.  With
    `stat_dtype` set, the statistics and the arithmetic run in that dtype
    and the RESULT is cast back to x's dtype, so the tensor that is kept
    stays narrow while the reductions keep full precision."""
    if stat_dtype is None:
        x = x.to(torch.float32)
        mean = x.mean(dim=tuple(dims), keepdim=True)
        var = x.var(dim=tuple(dims), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + eps)
    xs = x.to(stat_dtype)
    mean = xs.mean(dim=tuple(dims), keepdim=True)
    var = xs.var(dim=tuple(dims), keepdim=True, unbiased=False)
    return ((xs - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def same_pads(kernel: int, dilation: int) -> tuple[int, int]:
    """torch Conv 'same' padding (symmetric; left gets the smaller half)."""
    eff = (kernel - 1) * dilation
    lo = eff // 2
    return (lo, eff - lo)


class _MaxPoolEqMask(torch.autograd.Function):
    """Floor-mode max pool whose backward sends the cotangent to EVERY
    window element equal to the max (the JAX package's eq-mask VJP;
    `torch.max_pool2d` would pick one of a tie, and ties are common in
    bf16)."""

    @staticmethod
    def forward(ctx, x, h: int, w: int):
        b, c, hh, ww = x.shape
        y = x.reshape(b, c, hh // h, h, ww // w, w).amax(dim=(3, 5))
        ctx.save_for_backward(x, y)
        ctx.window = (h, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        h, w = ctx.window
        up = y.repeat_interleave(h, dim=2).repeat_interleave(w, dim=3)
        gu = g.repeat_interleave(h, dim=2).repeat_interleave(w, dim=3)
        return torch.where(x == up, gu, torch.zeros_like(gu)).to(x.dtype), None, None


def max_pool_floor(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """`nn.MaxPool2d(window)` (stride=window, floor mode) on (B, C, H, W),
    with the eq-mask backward."""
    h, w = window
    hh2, ww2 = (x.shape[2] // h) * h, (x.shape[3] // w) * w
    return _MaxPoolEqMask.apply(x[:, :, :hh2, :ww2], h, w)
