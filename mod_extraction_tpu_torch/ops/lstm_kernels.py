"""K3 (no-gradient LSTM effect-model forward), K4 (training forward that
saves every step's h, c and gate activations) and K5 (reverse-time backward
from those saved tensors): wrappers around
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
(i, f, g, o).  Saved states hs / cs are (B, T, H); the saved gate
activations are (B, T, 4H): sigmoid(i), sigmoid(f), tanh(g), sigmoid(o).
K5 reads them and never recomputes a gate, so it takes neither the bias
nor the pre-activations.

Which kernel a width takes on the card (`forward_kernel`, `backward_kernel`;
`csrc/lstm.cu` says how they differ): H 16, 32 and 64 the kernels whose
recurrent weights stay in registers (K3, K4 and K5); H 160, the shipped
chorus model's width, a forward (K3, K4) and a backward walk (K5) that run
the batch as thread-block clusters with W_hh split over their CTAs'
registers, 8 CTAs for one row or 4 for two as the batch allows
(`cluster_shape`; the forward trades h, the backward the partial sums of
W_hh dgates); every other H <= 256 the generic kernels.  The plans
(`forward_plan`, `backward_plan`) are made here and passed to the library,
which launches them or refuses them.  `ALLOW_FAST = False` keeps every
width on the generic kernels, for comparisons only.

Dispatch is by the device of the input: a CPU tensor takes the plain
version (the tests), a CUDA tensor launches the kernel or raises.  There is
no fallback between the two.

K3 is also an operator, `torch.ops.mod_extraction_tpu_torch.lstm_forward`
(`torch.library.custom_op`): its CPU implementation is `lstm_forward_plain`,
its CUDA implementation the kernel's launch, and its fake implementation
gives the output shapes with the time axis left symbolic.  Every no-gradient
forward (the TBPTT warm-up and `val_step`, streaming) goes through it, and
`torch.export` records it as one node, so an exported streaming processor
runs the plain version on the CPU and the kernel on the card.  Importing
this module registers it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from mod_extraction_tpu_torch.ops import cuda_build

#: Kernel launches per wrapper since the last `reset_launch_counts()`.
LAUNCHES = {"lstm_forward": 0, "lstm_train_forward": 0, "lstm_backward": 0}
#: Rows (batch x time) of the weight-gradient reduction per partial sum.
WGRAD_MIN_ROWS_PER_SLICE = 256
#: Partial sums of that reduction, at most.
WGRAD_MAX_SLICES = 128
#: False keeps H 16 / 32 / 64 and H 160 on the generic kernels (benchmarks only).
ALLOW_FAST = True
#: Widths of the register-resident kernels (K3, K4, K5).
FAST_WIDTHS = (16, 32, 64)
#: The width of the cluster kernels (K3, K4, K5).
CLUSTER_HIDDEN = 160
#: (CTAs, batch rows) of the cluster kernels.
CLUSTER_SHAPES = ((8, 1), (4, 2))

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
        lib.lstm_forward.argtypes = [p] * 15 + [i] * 8 + [p]
        lib.lstm_forward.restype = i
        lib.lstm_backward.argtypes = [p] * 18 + [i] * 9 + [p]
        lib.lstm_backward.restype = i
        for limit in (lib.lstm_max_in_dim, lib.lstm_max_hidden):
            limit.argtypes = []
            limit.restype = i
        lib.lstm_cluster_occupancy.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.lstm_cluster_occupancy.restype = i
        lib.lstm_bwd_cluster_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lstm_bwd_cluster_occupancy.restype = i
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_shape(batch: int, n_sms: int) -> Tuple[int, int]:
    """(CTAs, batch rows) a cluster of the H 160 kernels: 8 CTAs (100 cycles
    of a step's multiply-adds each) for one row while a cluster for every
    row fits one wave, else 4 CTAs for two rows.  The clusters of a wave
    fill at most 15/16 of the SMs: the GPCs' SM counts leave the rest (the
    H100's 132 SMs hold 15 clusters of 8 and 30 of 4), so B 15 and 60 are
    the largest batches of the two shapes that run in one wave."""
    if 8 * batch <= n_sms * 15 // 16:
        return 8, 1
    return 4, 2


def forward_plan(batch: int, hid: int, n_sms: int) -> Tuple[str, int, int]:
    """The forward kernel (K3, K4) that a launch of `batch` rows at width
    `hid` takes on a card of `n_sms` SMs, with its CTAs and rows a cluster:
    ("registers", 1, 1) at H 16/32/64, ("cluster", *`cluster_shape`) at H
    160, ("generic", 1, 1) otherwise.  A pure function of its arguments."""
    if hid in FAST_WIDTHS:
        return "registers", 1, 1
    if hid == CLUSTER_HIDDEN:
        return ("cluster", *cluster_shape(batch, n_sms))
    return "generic", 1, 1


def backward_plan(batch: int, hid: int, n_sms: int) -> Tuple[str, int, int]:
    """The backward walk (K5) that a launch of `batch` rows at width `hid`
    takes on a card of `n_sms` SMs: the forward's plan.  At the batches the
    paths send, the same cluster shape wins for the walk (H100: at B 2 and
    3, T 1024, 8 CTAs a row 0.58 ms against 1.08 for 4 x 2; at B 32, 4 x 2
    1.35 against 1.45 for 8 x 1, which takes two waves: the card holds 30
    of the walk's clusters of either shape).  A pure function of its
    arguments."""
    return forward_plan(batch, hid, n_sms)


def _plan_on_card(plan, hid: int, batch: int, device) -> Tuple[str, int, int]:
    if not ALLOW_FAST:
        return "generic", 1, 1
    index = getattr(device, "index", None)
    return plan(batch, hid, _sm_count(torch.cuda.current_device() if index is None else index))


def forward_kernel(hid: int, batch: int, device=None) -> Tuple[str, int, int]:
    """`forward_plan` on the current (or given) CUDA device; ("generic", 1,
    1) with `ALLOW_FAST` off."""
    return _plan_on_card(forward_plan, hid, batch, device)


def backward_kernel(hid: int, batch: int, device=None) -> Tuple[str, int, int]:
    """`backward_plan` on the current (or given) CUDA device; ("generic", 1,
    1) with `ALLOW_FAST` off."""
    return _plan_on_card(backward_plan, hid, batch, device)


def cluster_occupancy(n: int, rows: int, save: bool, in_dim: int = 2, out_ch: int = 1) -> int:
    """The most clusters of `n` CTAs for `rows` batch rows of the H 160
    forward (K4 with `save`, K3 without) that the card holds at once
    (`cudaOccupancyMaxActiveClusters`)."""
    out = ctypes.c_int(0)
    _check(_load().lstm_cluster_occupancy(n, rows, in_dim, out_ch, int(save), ctypes.byref(out)),
           "cluster occupancy")
    return out.value


def backward_cluster_occupancy(n: int, rows: int) -> int:
    """As `cluster_occupancy`, for the H 160 backward walk (K5)."""
    out = ctypes.c_int(0)
    _check(_load().lstm_bwd_cluster_occupancy(n, rows, ctypes.byref(out)), "cluster occupancy")
    return out.value


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _f32(a: torch.Tensor) -> torch.Tensor:
    """float32, contiguous and 16-byte aligned (the kernels move 16 bytes a
    load; a view into a larger tensor may start anywhere)."""
    a = a.to(torch.float32).contiguous()
    return a.clone() if a.data_ptr() % 16 else a


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
    y (B, out_ch, T), hn, cn (B, H) [, hs, cs (B, T, H), gate activations
    (B, T, 4H)].  A Python loop over time; differentiable by autograd."""
    hid = w_hh.shape[0]
    gx = torch.einsum("bit,ij->btj", seq, w_ih) + b  # (B, T, 4H)
    h, c = h0, c0
    hs, cs, acts = [], [], []
    for t in range(seq.shape[-1]):
        pre_i, pre_f, pre_g, pre_o = (gx[:, t] + h @ w_hh).split(hid, dim=1)
        gi, gf, go = torch.sigmoid(pre_i), torch.sigmoid(pre_f), torch.sigmoid(pre_o)
        gg = torch.tanh(pre_g)
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        if save_states:
            acts.append(torch.cat([gi, gf, gg, go], dim=1))
    hs_t = torch.stack(hs, dim=1)
    y = torch.tanh((hs_t @ fc_k + fc_b).transpose(1, 2) + xres)
    if save_states:
        return y, h, c, hs_t, torch.stack(cs, dim=1), torch.stack(acts, dim=1)
    return y, h, c


def lstm_backward_plain(seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn, with_dgates: bool = False):
    """Plain PyTorch version of K5: reverse-time BPTT of the recurrence
    from the saved states and gate activations, with dh_in (B, T, H) the
    cotangent that the fc head sends into each step's h and (dhn, dcn) that
    of the final state.  Returns dseq (B, in_dim, T), dh0, dc0 (B, H),
    dw_ih (in_dim, 4H), dw_hh (H, 4H), db (4H,) [, with `with_dgates` the
    walk's gate cotangents (B, T, 4H)].  A Python loop over time."""
    hid = w_hh.shape[0]
    hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    cprev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    gi, gf, gg, go = gates.split(hid, dim=-1)
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
    out = (dseq, dh_run, dc_run, dw_ih, dw_hh, dgates.sum(dim=(0, 1)))
    return (*out, dgates) if with_dgates else out


# ---------------------------------------------------------------------------
# K3 / K4: forward walks
# ---------------------------------------------------------------------------


def _forward_launch(name, seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, save_states, plan=None):
    """K3 or K4 on the card, on `forward_kernel`'s plan unless `plan`
    (kernel, CTAs, rows) names another (benchmarks: each cluster shape at one
    batch)."""
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
    kernel, n, rows = plan or forward_kernel(hid, bsz, dev)
    y = torch.empty(bsz, out_ch, t, dtype=torch.float32, device=dev)
    hn = torch.empty(bsz, hid, dtype=torch.float32, device=dev)
    cn = torch.empty_like(hn)
    hs = cs = gates = None
    if save_states:
        hs = torch.empty(bsz, t, hid, dtype=torch.float32, device=dev)
        cs = torch.empty_like(hs)
        gates = torch.empty(bsz, t, 4 * hid, dtype=torch.float32, device=dev)
    LAUNCHES[name] += 1
    _check(
        lib.lstm_forward(
            *(a.data_ptr() for a in args), y.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            _ptr(hs), _ptr(cs), _ptr(gates), bsz, t, hid, in_dim, out_ch, int(kernel == "registers"),
            n if kernel == "cluster" else 0, rows, torch.cuda.current_stream(dev).cuda_stream,
        ),
        name,
    )
    return (y, hn, cn, hs, cs, gates) if save_states else (y, hn, cn)


@torch.library.custom_op("mod_extraction_tpu_torch::lstm_forward", mutates_args=(), device_types="cpu")
def lstm_forward_op(
    seq: torch.Tensor, xres: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w_ih: torch.Tensor,
    w_hh: torch.Tensor, b: torch.Tensor, fc_k: torch.Tensor, fc_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 as an operator; on CPU tensors the plain version."""
    return lstm_forward_plain(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)


@lstm_forward_op.register_kernel("cuda")
def _lstm_forward_cuda(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    return _forward_launch("lstm_forward", seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b, False)


@lstm_forward_op.register_fake
def _lstm_forward_fake(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    bsz, _, t = seq.shape  # t stays symbolic under torch.export
    f32 = dict(dtype=torch.float32)
    return (seq.new_empty(bsz, fc_k.shape[-1], t, **f32), h0.new_empty(bsz, w_hh.shape[0], **f32),
            h0.new_empty(bsz, w_hh.shape[0], **f32))


def lstm_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    """K3 through its operator: the kernel on CUDA tensors, the plain
    version on CPU tensors; returns y (B, out_ch, T), hn, cn (B, H)."""
    if seq.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"lstm_forward: expected a CPU or CUDA tensor, got {seq.device}")
    return lstm_forward_op(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)


def lstm_train_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b):
    """K4 on CUDA tensors, the plain version on CPU tensors: K3's outputs
    and the saved hs, cs (B, T, H) and gate activations (B, T, 4H)."""
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
    rows = max(WGRAD_MIN_ROWS_PER_SLICE, -(-n_rows // WGRAD_MAX_SLICES))
    rows = -(-rows // 32) * 32
    return -(-n_rows // rows), rows


def lstm_backward(seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn):
    """K5 on CUDA tensors, the plain version on CPU tensors (see
    `lstm_backward_plain` for the contract).  On the card one call runs the
    reverse walk, then the fixed-order weight-gradient reduction and dseq."""
    if seq.device.type == "cpu":
        return lstm_backward_plain(seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn)
    return _backward_launch(seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn)[:6]


def _backward_launch(seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn, plan=None):
    """K5 on the card, on `backward_kernel`'s plan unless `plan` (kernel,
    CTAs, rows) names another (benchmarks: each cluster shape at one batch):
    `lstm_backward_plain`'s outputs and the walk's gate cotangents (B, T,
    4H), a view of the scratch the weight-gradient reduction reads."""
    bsz, in_dim, t = seq.shape
    hid = w_hh.shape[0]
    state, steps = (bsz, hid), (bsz, t, hid)
    _require_cuda(
        "lstm_backward", seq, hid, hs=(hs, steps), cs=(cs, steps),
        gates=(gates, (bsz, t, 4 * hid)), h0=(h0, state), c0=(c0, state),
        w_ih=(w_ih, (in_dim, 4 * hid)), w_hh=(w_hh, (hid, 4 * hid)),
        dh_in=(dh_in, steps), dhn=(dhn, state), dcn=(dcn, state),
    )
    lib = _load()
    args = [_f32(a) for a in (seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn, dcn)]
    dev = seq.device
    n_rows = bsz * t
    n_slices, rows_per_slice = wgrad_slices(n_rows)
    na = hid + in_dim + 1
    f32 = dict(dtype=torch.float32, device=dev)
    dgates = torch.empty(n_rows, 4 * hid, **f32)
    kernel, n, rows = plan or backward_kernel(hid, bsz, dev)
    # the generic walk reads W_hh transposed where it does not fit shared memory
    w_hh_t = torch.empty(4 * hid, hid, **f32) if kernel == "generic" else None
    partial = torch.empty(n_slices, na, 4 * hid, **f32)
    dwcat = torch.empty(na, 4 * hid, **f32)
    dseq = torch.empty(bsz, in_dim, t, **f32)
    dh0 = torch.empty(bsz, hid, **f32)
    dc0 = torch.empty_like(dh0)
    LAUNCHES["lstm_backward"] += 1
    _check(
        lib.lstm_backward(
            *(a.data_ptr() for a in args), dgates.data_ptr(), _ptr(w_hh_t), partial.data_ptr(),
            dwcat.data_ptr(), dseq.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            bsz, t, hid, in_dim, n_slices, rows_per_slice, int(kernel == "registers"),
            n if kernel == "cluster" else 0, rows, torch.cuda.current_stream(dev).cuda_stream,
        ),
        "lstm_backward",
    )
    return (dseq, dh0, dc0, dwcat[hid : hid + in_dim], dwcat[:hid], dwcat[hid + in_dim],
            dgates.view(bsz, t, 4 * hid))


# ---------------------------------------------------------------------------
# the training pair as one autograd function
# ---------------------------------------------------------------------------


class LSTMTrainFunction(torch.autograd.Function):
    """K4 forward, K5 backward; the fc head's backward in tensor code."""

    @staticmethod
    def forward(ctx, w_ih, w_hh, b, fc_k, fc_b, x, latent, h0, c0):
        seq = torch.cat([latent, x], dim=1).contiguous()
        xres = x.expand(-1, fc_k.shape[1], -1)
        y, hn, cn, hs, cs, gates = lstm_train_forward(seq, xres, h0, c0, w_ih, w_hh, b, fc_k, fc_b)
        ctx.save_for_backward(seq, h0, c0, w_ih, w_hh, fc_k, hs, cs, gates, y)
        ctx.lat_dim = latent.shape[1]
        ctx.in_ch = x.shape[1]
        return y, hn, cn

    @staticmethod
    def backward(ctx, dy, dhn, dcn):
        seq, h0, c0, w_ih, w_hh, fc_k, hs, cs, gates, y = ctx.saved_tensors
        dz = dy * (1.0 - y * y)  # (B, out_ch, T)
        dfc_k = torch.einsum("bth,bot->ho", hs, dz)
        dfc_b = dz.sum(dim=(0, 2))
        dh_in = torch.einsum("ho,bot->bth", fc_k, dz).contiguous()
        dseq, dh0, dc0, dw_ih, dw_hh, db = lstm_backward(
            seq, hs, cs, gates, h0, c0, w_ih, w_hh, dh_in, dhn.contiguous(), dcn.contiguous()
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
