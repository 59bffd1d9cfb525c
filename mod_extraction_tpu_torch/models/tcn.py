"""The TCN family (port of `mod_extraction_tpu/models/tcn.py`): dilated
temporal conv blocks with FiLM conditioning, the spectral TCN extractors and
the streaming (cached) causal TCN.

As in the JAX package:

* a block is LayerNorm over (C, T) without affine (optional) -> dilated
  conv1d (non-causal: symmetric padding `k // 2 * dilation`, or the explicit
  `padding`; causal: no padding) -> FiLM (when `cond_dim > 0`) -> PReLU ->
  a bias-free 1x1 strided residual, cropped to the conv's length;
* `causal_crop` keeps the reference's quirk: the `length` samples that end
  one BEFORE the last;
* the streaming cache is explicit state: a cached block takes the last
  `(k - 1) * dilation` input frames (after its LayerNorm) from the caller
  and returns the new ones, (B, C, cache_len) here (channel-last in JAX);
* the spectral models see the spectrogram of input channel 0 only
  (`spectrogram(x)[:, 0]`): under `use_dry` (input cat(dry, wet)) that is
  the DRY signal.

The parameters keep the JAX module names (`tcn.blocks.{i}.conv`, `.res`,
`.act`, `.film.adaptor`, `.film.bn`, `output`, `fc`, `fc_act`), so
`models/convert.py` maps them one to one; the initial weights are flax's
initialisers (lecun-normal kernels, zero biases, PReLU 0.25) drawn from
`seed`.  Everything is float32 and plain PyTorch: the JAX package computes
these convolutions in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mod_extraction_tpu_torch.models.common import PReLU, layer_norm_no_affine, lecun_normal_
from mod_extraction_tpu_torch.ops.stft import spectrogram


def center_crop(x: torch.Tensor, length: int) -> torch.Tensor:
    if x.shape[-1] == length:
        return x
    start = (x.shape[-1] - length) // 2
    return x[..., start : start + length]


def causal_crop(x: torch.Tensor, length: int) -> torch.Tensor:
    """The `length` samples ending one before the last (the reference's
    semantics)."""
    if x.shape[-1] == length:
        return x
    stop = x.shape[-1] - 1
    return x[..., stop - length : stop]


def _linear(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    """flax `Dense` init: lecun-normal kernel, zero bias."""
    lin = nn.Linear(n_in, n_out)
    lecun_normal_(lin.weight.data, n_in, gen)
    nn.init.zeros_(lin.bias)
    return lin


class FlaxBatchNorm(nn.Module):
    """Batch norm of (B, C, T) over B and T, without scale or bias, with
    flax's `BatchNorm` numerics: the batch's biased variance as
    mean(x^2) - mean(x)^2 (clamped at 0), normalised with it in training,
    and running statistics that keep 0.99 of their old value (torch's
    `BatchNorm1d` would keep the UNBIASED variance, 0.9 of the old value
    by default)."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]


class FiLM(nn.Module):
    """Feature-wise linear modulation of (B, C, T) by cond (B, cond_dim):
    BN (optional, train mode with the module's) then x * g + b, (g, b) from
    one Linear adaptor."""

    def __init__(self, cond_dim: int, num_features: int, use_bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.adaptor = _linear(cond_dim, 2 * num_features, generator)
        self.bn = FlaxBatchNorm(num_features) if use_bn else None

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        g, b = self.adaptor(cond).chunk(2, dim=-1)
        if self.bn is not None:
            x = self.bn(x)
        return x * g[:, :, None] + b[:, :, None]


class TCNBlock(nn.Module):
    """LN -> dilated conv1d -> FiLM? -> PReLU -> 1x1 residual, (B, C, T)
    in and out.  `padding` None means the non-causal "same" padding."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 3,
        dilation: int = 1,
        stride: int = 1,
        padding: Optional[int] = 0,
        use_ln: bool = False,
        temporal_dim: Optional[int] = None,
        use_act: bool = True,
        use_res: bool = True,
        cond_dim: int = 0,
        use_film_bn: bool = True,
        is_causal: bool = True,
        is_cached: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        assert not is_cached or is_causal, "a cached block is causal"
        assert is_cached or not is_causal or padding in (0, None), "a causal block takes no padding"
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.kernel_size, self.dilation, self.stride = kernel_size, dilation, stride
        self.padding, self.use_ln, self.temporal_dim = padding, use_ln, temporal_dim
        self.is_causal, self.is_cached, self.cond_dim = is_causal, is_cached, cond_dim
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride, dilation=dilation)
        lecun_normal_(self.conv.weight.data, kernel_size * in_ch, gen)
        nn.init.zeros_(self.conv.bias)
        self.film = FiLM(cond_dim, out_ch, use_film_bn, gen) if cond_dim > 0 else None
        self.act = PReLU(out_ch) if use_act else None
        self.res = None
        if use_res:
            self.res = nn.Conv1d(in_ch, out_ch, 1, stride=stride, bias=False)
            lecun_normal_(self.res.weight.data, in_ch, gen)

    def cache_len(self) -> int:
        return (self.kernel_size - 1) * self.dilation

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                stream_state: Optional[torch.Tensor] = None):
        """y (B, C', T'); with `is_cached` (y, new stream state)."""
        assert x.ndim == 3
        h = layer_norm_no_affine(x, dims=(1, 2)) if self.use_ln else x
        new_state = None
        pad = 0
        if self.is_cached:
            n = self.cache_len()
            cache = h.new_zeros(h.shape[0], h.shape[1], n) if stream_state is None else stream_state
            h = torch.cat([cache, h], dim=-1)
            new_state = h[:, :, -n:]
        elif not self.is_causal:
            pad = self.kernel_size // 2 * self.dilation if self.padding is None else self.padding
        h = F.conv1d(h, self.conv.weight, self.conv.bias, self.stride, pad, self.dilation)
        if self.film is not None:
            assert cond is not None
            h = self.film(h, cond)
        if self.act is not None:
            h = self.act(h)
        if self.res is not None:
            crop = causal_crop if self.is_causal else center_crop
            h = h + crop(self.res(x), h.shape[-1])
        return (h, new_state) if self.is_cached else h


class TCN(nn.Module):
    """Stacked `TCNBlock`s; dilations default to 4**i, strides to 1."""

    def __init__(
        self,
        out_channels: Sequence[int],
        dilations: Optional[Sequence[int]] = None,
        in_ch: int = 1,
        kernel_size: int = 13,
        strides: Optional[Sequence[int]] = None,
        padding: Optional[int] = 0,
        use_ln: bool = False,
        temporal_dims: Optional[Sequence[int]] = None,
        use_act: bool = True,
        use_res: bool = True,
        cond_dim: int = 0,
        use_film_bn: bool = False,
        is_causal: bool = True,
        is_cached: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        n = len(out_channels)
        self.kernel_size, self.is_cached = kernel_size, is_cached
        self.dilations = list(dilations) if dilations is not None else [4**i for i in range(n)]
        self.strides = list(strides) if strides is not None else [1] * n
        blocks, prev = [], in_ch
        for i, (out_ch, dil, stride) in enumerate(zip(out_channels, self.dilations, self.strides)):
            blocks.append(TCNBlock(
                prev, out_ch, kernel_size, dil, stride, padding, use_ln,
                temporal_dims[i] if temporal_dims is not None else None, use_act, use_res,
                cond_dim, use_film_bn, is_causal, is_cached, gen,
            ))
            prev = out_ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                stream_state: Optional[Sequence[torch.Tensor]] = None):
        """y; with `is_cached` (y, [each block's new stream state])."""
        if not self.is_cached:
            for block in self.blocks:
                x = block(x, cond)
            return x
        new_states: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            x, st = block(x, cond, None if stream_state is None else stream_state[i])
            new_states.append(st)
        return x, new_states

    def calc_receptive_field(self) -> int:
        assert all(s == 1 for s in self.strides)
        assert self.dilations[0] == 1
        return self.kernel_size + sum((self.kernel_size - 1) * d for d in self.dilations[1:])


def _spectral_trunk(n_fft, kernel_size, chans, dils, strides, use_ln, use_res, temporal_dims, gen) -> TCN:
    """The spectral models' non-causal, "same"-padded TCN over the bins."""
    return TCN(
        chans, dils, in_ch=n_fft // 2 + 1, kernel_size=kernel_size, strides=strides, padding=None,
        use_ln=use_ln, temporal_dims=temporal_dims, use_res=use_res, is_causal=False, generator=gen,
    )


class SpectralTCN(nn.Module):
    """log spectrogram (channel 0) -> non-causal TCN -> per-frame Linear ->
    sigmoid.  Returns (mod_sig_hat (B, latent_dim, frames), the TCN's
    output (B, C, frames))."""

    def __init__(
        self,
        n_samples: int = 88200,
        n_fft: int = 1024,
        hop_len: int = 256,
        kernel_size: int = 13,
        out_channels: Optional[Sequence[int]] = None,
        dilations: Optional[Sequence[int]] = None,
        latent_dim: int = 1,
        use_ln: bool = True,
        use_res: bool = True,
        eps: float = 1e-7,
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        chans = list(out_channels) if out_channels else [96] * 5
        dils = list(dilations) if dilations else [2**i for i in range(len(chans))]
        self.n_samples, self.n_fft, self.hop_len, self.eps = n_samples, n_fft, hop_len, eps
        n_frames = n_samples // hop_len + 1
        self.tcn = _spectral_trunk(n_fft, kernel_size, chans, dils, None, use_ln, use_res,
                                   [n_frames] * len(chans), gen)
        self.output = _linear(chans[-1], latent_dim, gen)

    def forward(self, x: torch.Tensor, mask_draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, n_samples).  `mask_draws` is accepted and ignored: the
        model has no SpecAugment."""
        assert x.ndim == 3
        spec = spectrogram(x, self.n_fft, self.hop_len)[:, 0]  # (B, bins, frames)
        latent = self.tcn(torch.log(torch.clamp(spec, min=self.eps)))
        out = self.output(latent.transpose(1, 2)).transpose(1, 2)
        return torch.sigmoid(out), latent


class SpectralDSTCN(nn.Module):
    """log spectrogram (channel 0) -> downsampling TCN (strides 2) ->
    temporal mean -> Linear -> PReLU -> Linear -> sigmoid: one (B,
    latent_dim) vector a clip."""

    def __init__(
        self,
        n_samples: int = 88200,
        n_fft: int = 1024,
        hop_len: int = 256,
        kernel_size: int = 13,
        out_channels: Optional[Sequence[int]] = None,
        dilations: Optional[Sequence[int]] = None,
        strides: Optional[Sequence[int]] = None,
        n_fc_units: int = 48,
        latent_dim: int = 2,
        use_ln: bool = True,
        use_res: bool = True,
        eps: float = 1e-7,
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        chans = list(out_channels) if out_channels else [96] * 5
        dils = list(dilations) if dilations else [2**i for i in range(len(chans))]
        strs = list(strides) if strides else [2] * len(chans)
        self.n_samples, self.n_fft, self.hop_len, self.eps = n_samples, n_fft, hop_len, eps
        self.latent_dim = latent_dim
        temporal_dims = [n_samples // hop_len + 1]
        for s in strs[:-1]:
            temporal_dims.append(math.ceil(temporal_dims[-1] / s))
        self.tcn = _spectral_trunk(n_fft, kernel_size, chans, dils, strs, use_ln, use_res, temporal_dims, gen)
        self.fc = _linear(chans[-1], n_fc_units, gen)
        self.fc_act = PReLU(n_fc_units)
        self.output = _linear(n_fc_units, latent_dim, gen)

    def forward(self, x: torch.Tensor, mask_draws=None) -> torch.Tensor:
        """x (B, C, T) -> (B, latent_dim).  `mask_draws` is ignored."""
        assert x.ndim == 3
        spec = spectrogram(x, self.n_fft, self.hop_len)[:, 0]
        h = self.tcn(torch.log(torch.clamp(spec, min=self.eps))).mean(dim=-1)
        return torch.sigmoid(self.output(self.fc_act(self.fc(h))))
