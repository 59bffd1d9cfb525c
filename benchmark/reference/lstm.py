"""Plain PyTorch LSTM effect model and its streaming processor.

The model (the reference's `LSTMEffectModel`): the LFO and the dry audio
as two input channels (LFO first) -> one LSTM layer (gate order i, f, g,
o; one bias) -> linear head -> + dry -> tanh.  The LSTM is
`torch.nn.LSTM` in float32; the bias rides as the input weights of a
constant third channel, so each parameter is one leaf.

The processor (the plugin): per buffer, the LFO continues from the
previous buffer's phase, (cos(2 pi rate i / sr + phase) + 1) / 2 * depth
for i = 1..n in float32, the next phase the last argument mod 2 pi; the
channels are the LSTM's batch and carry (h, c) from buffer to buffer.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def npz_params(path: str) -> Dict[str, np.ndarray]:
    """A shipped effect-model `.npz`: w_ih (2, 4H), w_hh (H, 4H), b (4H,),
    fc_k (H, 1), fc_b (1,)."""
    with np.load(path) as z:
        return {"w_ih": np.array(z["w_ih"], np.float32), "w_hh": np.array(z["w_hh"], np.float32),
                "b": np.array(z["b_gates"], np.float32), "fc_k": np.array(z["fc/kernel"], np.float32),
                "fc_b": np.array(z["fc/bias"], np.float32)}


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even): the operands of a TF32 product."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32).reshape(np.shape(a))


class EffectModel(torch.nn.Module):
    def __init__(self, p: Dict[str, np.ndarray], device):
        super().__init__()
        hid = p["w_hh"].shape[0]
        self.lstm = torch.nn.LSTM(3, hid, bias=False, batch_first=True).to(device)
        w_in = np.concatenate([p["w_ih"], p["b"][None, :]], axis=0).T  # (4H, 3)
        with torch.no_grad():
            self.lstm.weight_ih_l0.copy_(torch.from_numpy(np.ascontiguousarray(w_in)))
            self.lstm.weight_hh_l0.copy_(torch.from_numpy(np.ascontiguousarray(p["w_hh"].T)))
        self.fc_k = torch.nn.Parameter(torch.from_numpy(p["fc_k"].copy()).to(device))
        self.fc_b = torch.nn.Parameter(torch.from_numpy(p["fc_b"].copy()).to(device))

    def forward(self, x, lfo, state, x_in=None) -> Tuple[torch.Tensor, Tuple]:
        """x, lfo (B, 1, T); state (h, c) each (B, H) -> y (B, 1, T), state.
        `x_in` stands for x as the LSTM's input (the residual keeps x)."""
        x_in = x if x_in is None else x_in
        inp = torch.stack([lfo[:, 0], x_in[:, 0], torch.ones_like(x[:, 0])], dim=-1)
        hs, (h, c) = self.lstm(inp, (state[0][None].contiguous(), state[1][None].contiguous()))
        y = torch.tanh(hs @ self.fc_k + self.fc_b + x[:, 0, :, None])  # (B, T, 1)
        return y.transpose(1, 2), (h[0], c[0])

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The program's leaves as views of this model's: w_ih, w_hh,
        b_gates, fc_kernel, fc_bias."""
        w = self.lstm.weight_ih_l0
        return {"w_ih": w[:, :2].t(), "b_gates": w[:, 2], "w_hh": self.lstm.weight_hh_l0.t(),
                "fc_kernel": self.fc_k, "fc_bias": self.fc_b}


def stream_phases(n_buffers: int, n: int, sr: float, rate: float) -> np.ndarray:
    """Each buffer's starting phase, carried in float32 as the processor
    carries it."""
    step = np.float32(np.float32(2.0 * math.pi / sr) * np.float32(rate))
    last = step * np.float32(n)
    two_pi = np.float32(2.0 * math.pi)
    phases = np.empty(n_buffers, np.float32)
    ph = np.float32(0.0)
    for k in range(n_buffers):
        phases[k] = ph
        ph = np.float32(np.remainder(np.float32(last + ph), two_pi))
    return phases


def stream_lfo(phases: np.ndarray, n: int, sr: float, rate: float, depth: float,
               channels: int, offset: float) -> np.ndarray:
    """(channels, n_buffers * n) LFO of a stream."""
    step = np.float32(np.float32(2.0 * math.pi / sr) * np.float32(rate))
    i = np.arange(1, n + 1, dtype=np.float32)
    arg = step * i[None, :] + phases[:, None]  # (buffers, n)
    out = []
    for c in range(channels):
        a = arg + np.float32(c) * np.float32(offset)
        out.append(((np.cos(a) + np.float32(1.0)) / np.float32(2.0) * np.float32(depth)).reshape(-1))
    return np.stack(out).astype(np.float32)


@torch.no_grad()
def stream(model: EffectModel, x: np.ndarray, lfo: np.ndarray, device, block: int = 8192,
           x_in: np.ndarray = None):
    """The whole stream through the model in blocks, (h, c) carried from
    zero: (y (C, T) numpy, h, c numpy).  `x_in`: the LSTM's input in place
    of x (the control's, rounded by `tf32_round`)."""
    x_in = x if x_in is None else x_in
    ch, t = x.shape
    hid = model.lstm.hidden_size
    state = (torch.zeros(ch, hid, device=device), torch.zeros(ch, hid, device=device))
    ys = []
    for a in range(0, t, block):
        xb = torch.as_tensor(x[:, None, a:a + block], device=device)
        lb = torch.as_tensor(lfo[:, None, a:a + block], device=device)
        xi = torch.as_tensor(x_in[:, None, a:a + block], device=device)
        y, state = model(xb, lb, state, xi)
        ys.append(y[:, 0].cpu().numpy())
    return np.concatenate(ys, axis=1), state[0].cpu().numpy(), state[1].cpu().numpy()
