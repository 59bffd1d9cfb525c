"""LSTMEffectModel, the conditional LSTM-64 effect model (port of
`mod_extraction_tpu/models/lstm.py`).

concat(latent, x) on channels -> one-layer LSTM with one fused gate bias,
torch gate order (i, f, g, o) -> fc -> residual + x -> tanh.  The hidden
state (h, c) is explicit in and out, so TBPTT detaches it between chunks
and streaming carries it across buffers.  Parameters keep the JAX layout:
w_ih (in_dim, 4H), w_hh (H, 4H), b_gates (4H,), fc_kernel (H, out_ch),
fc_bias (out_ch,).

The forward dispatches on gradient: with gradients it runs the K4/K5
autograd function, without them K3.  Each of those takes its plain version
for CPU tensors and its CUDA kernel for CUDA tensors
(`ops/lstm_kernels.py`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mod_extraction_tpu_torch.models.common import lecun_normal_
from mod_extraction_tpu_torch.ops.lstm_kernels import (
    lstm_effect_model_forward,
    lstm_effect_model_train,
)

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (B, H)


def lstm_init_state(
    batch_size: int, n_hidden: int, device: str | torch.device = "cpu"
) -> LSTMState:
    z = torch.zeros(batch_size, n_hidden, dtype=torch.float32, device=device)
    return (z, z.clone())


def detach_state(state: LSTMState) -> LSTMState:
    """The TBPTT hidden detach."""
    return tuple(s.detach() for s in state)


class LSTMEffectModel(nn.Module):
    def __init__(
        self,
        in_ch: int = 1,
        out_ch: int = 1,
        n_hidden: int = 64,
        latent_dim: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if out_ch != in_ch and in_ch != 1:
            raise ValueError("the residual needs in_ch == out_ch or in_ch == 1")
        self.in_ch, self.out_ch = in_ch, out_ch
        self.n_hidden, self.latent_dim = n_hidden, latent_dim
        in_dim = in_ch + latent_dim
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        k = 1.0 / math.sqrt(n_hidden)

        def uniform(*shape):  # torch LSTM init: U[-1/sqrt(H), 1/sqrt(H)]
            return nn.Parameter(torch.rand(*shape, generator=gen) * (2 * k) - k)

        self.w_ih = uniform(in_dim, 4 * n_hidden)
        self.w_hh = uniform(n_hidden, 4 * n_hidden)
        self.b_gates = uniform(4 * n_hidden)
        self.fc_kernel = nn.Parameter(torch.empty(n_hidden, out_ch))
        lecun_normal_(self.fc_kernel.data, n_hidden, gen)  # flax Dense
        self.fc_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(
        self, x: torch.Tensor, latent: torch.Tensor, state: LSTMState
    ) -> Tuple[torch.Tensor, LSTMState]:
        """x: (B, in_ch, T); latent: (B, latent_dim, T); state ((B, H), (B, H)).
        Returns (y (B, out_ch, T), (h_n, c_n))."""
        assert x.ndim == 3
        h0, c0 = state
        args = (self.w_ih, self.w_hh, self.b_gates, self.fc_kernel, self.fc_bias, x, latent, h0, c0)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            y, hn, cn = lstm_effect_model_train(*args)
        else:
            y, hn, cn = lstm_effect_model_forward(*args)
        return y, (hn, cn)
