"""Sample-rate conversion (the port's copy of
`mod_extraction_tpu/ops/resample.py`, the torchaudio `Resample`
equivalent the reference prepares datasets with).

Windowed-sinc polyphase resampler: the rates are reduced by their gcd to
(orig_g, new_g); each of the new_g output phases has a fixed FIR taken from
a Hann-windowed sinc with its cutoff at the lower Nyquist (rolloff 0.99),
and output j (phase p = j % new_g, block m = j // new_g) is the dot of
phase p's FIR with the window of the input that starts at
n0[p] + m * orig_g.  The FIR bank is built in numpy (float64, rounded to
float32); the filtering runs on torch tensors on the given device: every
output's window gathered from a view of the padded input, then one batched
product with the bank.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from mod_extraction_tpu_torch.utils.device import resolve_device

LOWPASS_FILTER_WIDTH = 6  # sinc lobes on each side
ROLLOFF = 0.99


@lru_cache(maxsize=32)
def _kernel_bank(orig_g: int, new_g: int) -> tuple[np.ndarray, np.ndarray, int]:
    """FIR bank for reduced rates (orig_g, new_g).

    Returns (kernels (new_g, 2W+1), n0 offsets (new_g,), W).
    Output j (phase p = j % new_g, block m = j // new_g) is
    sum_k kernels[p, k] * x[n0[p] + m*orig_g + k - W].
    """
    # normalized cutoff in cycles per orig sample
    fc = ROLLOFF * min(orig_g, new_g) / orig_g / 2.0
    w = int(math.ceil(LOWPASS_FILTER_WIDTH / (2.0 * fc)))
    k = np.arange(-w, w + 1, dtype=np.float64)
    kernels = np.empty((new_g, 2 * w + 1), np.float64)
    n0 = np.empty((new_g,), np.int64)
    for p in range(new_g):
        tau = p * orig_g / new_g
        n0[p] = math.floor(tau)
        frac = tau - n0[p]
        t = k - frac
        x = 2.0 * math.pi * fc * t
        sinc = np.where(np.abs(x) < 1e-12, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
        # Hann window over the filter support
        win = np.cos(np.clip(t / w, -1.0, 1.0) * math.pi / 2.0) ** 2
        kernels[p] = 2.0 * fc * sinc * win
    return kernels.astype(np.float32), n0, w


def resample(x, orig_freq: int, new_freq: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Resamples along the last axis: x (..., T), a numpy array or a tensor,
    -> float32 (..., ceil(T * new / orig)) on `device` (the card unless the
    caller asks for the CPU).  Equal rates return x as float32."""
    dev = resolve_device(device)
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    x = torch.as_tensor(x).to(dev, torch.float32)
    if orig_freq == new_freq:
        return x
    g = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // g, new_freq // g
    kernels, n0, w = _kernel_bank(orig_g, new_g)
    klen = 2 * w + 1

    lead, t = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, t)
    n_out = int(math.ceil(t * new_g / orig_g))
    n_blocks = (n_out + new_g - 1) // new_g  # output blocks of new_g samples
    # pad so that every window lies inside the padded input
    pad_right = w + (n_blocks - 1) * orig_g + int(n0.max()) + klen - (t + w)
    padded = torch.nn.functional.pad(flat, (w, max(pad_right, 0)))
    windows = padded.unfold(-1, klen, 1)  # (N, L, klen), a view
    # window start of output (block m, phase p): n0[p] + m * orig_g
    starts = torch.as_tensor(n0, device=dev)[None, :] + orig_g * torch.arange(n_blocks, device=dev)[:, None]
    bank = torch.as_tensor(kernels, device=dev)  # (new_g, klen)
    out = torch.einsum("nmpk,pk->nmp", windows[:, starts, :], bank)  # (N, n_blocks, new_g)
    return out.reshape(flat.shape[0], n_blocks * new_g)[:, :n_out].reshape(*lead, n_out)
