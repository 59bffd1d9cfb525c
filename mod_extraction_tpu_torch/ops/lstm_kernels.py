"""K3 (no-gradient LSTM effect-model forward), K4 (training forward that
saves every step's h and c) and K5 (reverse-time backward): wrappers around
the hand-written CUDA kernels in `csrc/lstm.cu`, their plain PyTorch
versions, launch counters, and the autograd function that pairs K4 with K5.

Replaces `mod_extraction_tpu/ops/pallas_lstm.py` (`lstm_effect_model_pallas`
with `_lstm_kernel`; `lstm_effect_model_pallas_train`, the custom VJP of
`_lstm_fwd_train_kernel` and `_lstm_bwd_kernel`).  As there, the fc head's
backward (dz, dfc_k, dfc_b, dh_in and the residual dx) is plain tensor code
outside the kernel.

Arguments keep the JAX parameter layout: seq (B, in_dim, T) = [latent; x]
on channels, x residual (B, out_ch, T), h0 / c0 (B, H), w_ih (in_dim, 4H),
w_hh (H, 4H), b (4H,), fc_k (H, out_ch), fc_b (out_ch,), gate order
(i, f, g, o).  Saved states hs / cs are (B, T, H).

Dispatch is by the device of the input: a CPU tensor takes the plain
version (the tests), a CUDA tensor launches the kernel or raises.  There is
no fallback between the two.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from mod_extraction_tpu_torch.ops import cuda_build

#: Kernel launches per wrapper since the last `reset_launch_counts()`.
LAUNCHES = {"lstm_forward": 0, "lstm_train_forward": 0, "lstm_backward": 0}
#: Rows (batch x time) of the weight-gradient reduction per partial sum.
WGRAD_MIN_ROWS_PER_SLICE = 512

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile `csrc/lstm.cu` for sm_90a (see `cuda_build.build`)."""
    return cuda_build.build("lstm.cu", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_forward.argtypes = [p] * 14 + [i] * 5 + [p]
        lib.lstm_forward.restype = i
        lib.lstm_backward.argtypes = [p] * 17 + [i] * 6 + [p]
        lib.lstm_backward.restype = i
        for limit in (lib.lstm_max_in_dim, lib.lstm_max_hidden):
            limit.argtypes = []
            limit.restype = i
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous()


def _ptr(a) -> int | None:
    return None if a is None else a.data_ptr()


def _require_cuda(name: str, seq, hid: int, **shapes) -> None:
    """Raise unless `seq` is a CUDA tensor and every argument has the shape
    the kernel indexes it with (`shapes`: name -> (tensor, expected))."""
    if seq.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CPU or CUDA tensor, got {seq.device}")
    if seq.ndim != 3:
        raise ValueError(f"{name}: expected seq (B, in_dim, T), got {tuple(seq.shape)}")
    lib = _load()
    if hid > lib.lstm_max_hidden():  # the JAX task's limit for its training kernels
        raise ValueError(f"{name}: n_hidden={hid} exceeds the kernels' limit {lib.lstm_max_hidden()}")
    if seq.shape[1] > lib.lstm_max_in_dim():
        raise ValueError(f"{name}: in_dim={seq.shape[1]} exceeds the kernel's limit")
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want) or t.device != seq.device:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} on {t.device}, expected {tuple(want)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lstm_forward_plain(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, save_states: bool = False):
    """Plain PyTorch version of K3 (and of K4 with `save_states`): returns
    y (B, out_ch, T), hn, cn (B, H) [, hs, cs (B, T, H)].  A Python loop over
    time; differentiable by autograd."""
    hid = w_hh.shape[0]
    gx = torch.einsum("bit,ij->btj", seq, w_ih) + b  # (B, T, 4H)
    h, c = h0, c0
    hs, cs = [], []
    for t in range(seq.shape[-1]):
        gates = gx[:, t] + h @ w_hh
        gi, gf, gg, go = gates.split(hid, dim=1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    hs_t = torch.stack(hs, dim=1)
    y = torch.tanh((hs_t @ fc_k + fc_b).transpose(1, 2) + xres)
    if save_states:
        return y, h, c, hs_t, torch.stack(cs, dim=1)
    return y, h, c


def lstm_backward_plain(seq, hs, cs, h0, c0, w_ih, w_hh, b, dh_in, dhn, dcn):
    """Plain PyTorch version of K5: reverse-time BPTT of the recurrence
    from the saved states, with dh_in (B, T, H) the cotangent that the fc
    head sends into each step's h and (dhn, dcn) that of the final state.
    Returns dseq (B, in_dim, T), dh0, dc0 (B, H), dw_ih (in_dim, 4H),
    dw_hh (H, 4H), db (4H,).  A Python loop over time."""
    hid = w_hh.shape[0]
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    cprev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    gates = torch.einsum("bit,ij->btj", seq, w_ih) + b + hprev @ w_hh
    pre_i, pre_f, pre_g, pre_o = gates.split(hid, dim=-1)
    gi, gf, go = torch.sigmoid(pre_i), torch.sigmoid(pre_f), torch.sigmoid(pre_o)
    gg = torch.tanh(pre_g)
    dgates = torch.empty_like(gates)
    dh_run, dc_run = dhn, dcn
    for t in range(seq.shape[-1] - 1, -1, -1):
        dh = dh_run + dh_in[:, t]
        tc = torch.tanh(cs[:, t])
        dc = dc_run + dh * go[:, t] * (1.0 - tc * tc)
        dg = torch.cat(
            [
                dc * gg[:, t] * gi[:, t] * (1.0 - gi[:, t]),
                dc * cprev[:, t] * gf[:, t] * (1.0 - gf[:, t]),
                dc * gi[:, t] * (1.0 - gg[:, t] * gg[:, t]),
                dh * tc * go[:, t] * (1.0 - go[:, t]),
            ],
            dim=1,
        )
        dc_run = dc * gf[:, t]
        dgates[:, t] = dg
        dh_run = dg @ w_hh.T
    dseq = torch.einsum("btj,ij->bit", dgates, w_ih)
    dw_ih = torch.einsum("bit,btj->ij", seq, dgates)
    dw_hh = torch.einsum("bth,btj->hj", hprev, dgates)
    return dseq, dh_run, dc_run, dw_ih, dw_hh, dgates.sum(dim=(0, 1))


# ---------------------------------------------------------------------------
# K3 / K4: forward walks
# ---------------------------------------------------------------------------


def _forward_launch(name, seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, save_states):
    bsz, in_dim, t = seq.shape
    hid = w_hh.shape[0]
    out_ch = fc_k.shape[-1]
    _require_cuda(
        name, seq, hid, xres=(xres, (bsz, out_ch, t)), h0=(h0, (bsz, hid)), c0=(c0, (bsz, hid)),
        w_ih=(w_ih, (in_dim, 4 * hid)), w_hh=(w_hh, (hid, 4 * hid)), b=(b, (4 * hid,)),
        fc_k=(fc_k, (hid, out_ch)), fc_b=(fc_b, (out_ch,)),
    )
    lib = _load()
    args = [_f32(a) for a in (seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)]
    dev = seq.device
    y = torch.empty(bsz, out_ch, t, dtype=torch.float32, device=dev)
    hn = torch.empty(bsz, hid, dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    hs = cs = None
    if save_states:
        hs = torch.empty(bsz, t, hid, dtype=torch.float32, device=dev)
        cs = torch.empty_like(hs)
    LAUNCHES[name] += 1
    _check(
        lib.lstm_forward(
            *(a.data_ptr() for a in args), y.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            _ptr(hs), _ptr(cs), bsz, t, hid, in_dim, out_ch,
            torch.cuda.current_stream(dev).cuda_stream,
        ),
        name,
    )
    return (y, hn, cn, hs, cs) if save_states else (y, hn, cn)


def lstm_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    """K3 on CUDA tensors, the plain version on CPU tensors: returns
    y (B, out_ch, T), hn, cn (B, H)."""
    if seq.device.type == "cpu":
        return lstm_forward_plain(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)
    return _forward_launch("lstm_forward", seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, False)


def lstm_train_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    """K4 on CUDA tensors, the plain version on CPU tensors: K3's outputs
    and the saved hs, cs (B, T, H)."""
    if seq.device.type == "cpu":
        return lstm_forward_plain(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, save_states=True)
    return _forward_launch(
        "lstm_train_forward", seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, True
    )


# ---------------------------------------------------------------------------
# K5: backward
# ---------------------------------------------------------------------------


def wgrad_slices(n_rows: int) -> Tuple[int, int]:
    """(n_slices, rows_per_slice) of K5's weight-gradient reduction: a
    function of the shape alone, so the summation order is fixed."""
    rows = max(WGRAD_MIN_ROWS_PER_SLICE, -(-n_rows // 64))
    rows = -(-rows // 32) * 32
    return -(-n_rows // rows), rows


def lstm_backward(seq, hs, cs, h0, c0, w_ih, w_hh, b, dh_in, dhn, dcn):
    """K5 on CUDA tensors, the plain version on CPU tensors (see
    `lstm_backward_plain` for the contract).  On the card one call runs the
    reverse walk, then the fixed-order weight-gradient reduction and dseq."""
    if seq.device.type == "cpu":
        return lstm_backward_plain(seq, hs, cs, h0, c0, w_ih, w_hh, b, dh_in, dhn, dcn)
    bsz, in_dim, t = seq.shape
    hid = w_hh.shape[0]
    state, steps = (bsz, hid), (bsz, t, hid)
    _require_cuda(
        "lstm_backward", seq, hid, hs=(hs, steps), cs=(cs, steps), h0=(h0, state),
        c0=(c0, state), w_ih=(w_ih, (in_dim, 4 * hid)), w_hh=(w_hh, (hid, 4 * hid)),
        b=(b, (4 * hid,)), dh_in=(dh_in, steps), dhn=(dhn, state), dcn=(dcn, state),
    )
    lib = _load()
    args = [_f32(a) for a in (seq, hs, cs, h0, c0, w_ih, w_hh, b, dh_in, dhn, dcn)]
    dev = seq.device
    n_rows = bsz * t
    n_slices, rows_per_slice = wgrad_slices(n_rows)
    na = hid + in_dim + 1
    f32 = dict(dtype=torch.float32, device=dev)
    dgates = torch.empty(n_rows, 4 * hid, **f32)
    partial = torch.empty(n_slices, na, 4 * hid, **f32)
    dwcat = torch.empty(na, 4 * hid, **f32)
    dseq = torch.empty(bsz, in_dim, t, **f32)
    dh0 = torch.empty(bsz, hid, **f32)
    dc0 = torch.empty_like(dh0)
    LAUNCHES["lstm_backward"] += 1
    _check(
        lib.lstm_backward(
            *(a.data_ptr() for a in args), dgates.data_ptr(), partial.data_ptr(),
            dwcat.data_ptr(), dseq.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            bsz, t, hid, in_dim, n_slices, rows_per_slice,
            torch.cuda.current_stream(dev).cuda_stream,
        ),
        "lstm_backward",
    )
    return dseq, dh0, dc0, dwcat[hid : hid + in_dim], dwcat[:hid], dwcat[hid + in_dim]


# ---------------------------------------------------------------------------
# the training pair as one autograd function
# ---------------------------------------------------------------------------


class LSTMTrainFunction(torch.autograd.Function):
    """K4 forward, K5 backward; the fc head's backward in tensor code."""

    @staticmethod
    def forward(ctx, w_ih, w_hh, b, fc_k, fc_b, x, latent, h0, c0):
        seq = torch.cat([latent, x], dim=1).contiguous()
        xres = x.expand(-1, fc_k.shape[1], -1)
        y, hn, cn, hs, cs = lstm_train_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)
        ctx.save_for_backward(seq, h0, c0, w_ih, w_hh, b, fc_k, hs, cs, y)
        ctx.lat_dim = latent.shape[1]
        ctx.in_ch = x.shape[1]
        return y, hn, cn

    @staticmethod
    def backward(ctx, dy, dhn, dcn):
        seq, h0, c0, w_ih, w_hh, b, fc_k, hs, cs, y = ctx.saved_tensors
        dz = dy * (1.0 - y * y)  # (B, out_ch, T)
        dfc_k = torch.einsum("bth,bot->ho", hs, dz)
        dfc_b = dz.sum(dim=(0, 2))
        dh_in = torch.einsum("ho,bot->bth", fc_k, dz).contiguous()
        dseq, dh0, dc0, dw_ih, dw_hh, db = lstm_backward(
            seq, hs, cs, h0, c0, w_ih, w_hh, b, dh_in, dhn.contiguous(), dcn.contiguous()
        )
        lat = ctx.lat_dim
        dx_res = dz if dz.shape[1] == ctx.in_ch else dz.sum(dim=1, keepdim=True)
        dx = dseq[:, lat:] + dx_res
        return dw_ih, dw_hh, db, dfc_k, dfc_b, dx, dseq[:, :lat], dh0, dc0


def lstm_effect_model_train(w_ih, w_hh, b, fc_k, fc_b, x, latent, h0, c0):
    """Differentiable LSTM effect model through K4/K5: x (B, in_ch, T),
    latent (B, L, T), (h0, c0) (B, H).  Returns y (B, out_ch, T), hn, cn."""
    return LSTMTrainFunction.apply(w_ih, w_hh, b, fc_k, fc_b, x, latent, h0, c0)


def lstm_effect_model_forward(w_ih, w_hh, b, fc_k, fc_b, x, latent, h0, c0):
    """The no-gradient path through K3, same contract as
    `lstm_effect_model_train`."""
    seq = torch.cat([latent, x], dim=1).contiguous()
    xres = x.expand(-1, fc_k.shape[1], -1)
    return lstm_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)
