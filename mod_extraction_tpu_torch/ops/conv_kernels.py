"""K6, the trunk conv's weight gradient: the wrapper around the hand-written
CUDA kernel in `csrc/conv_wgrad.cu`, its plain PyTorch version, a float32
reference, the launch counter, and the conv with an explicitly chosen
backward that calls them.

Replaces `mod_extraction_tpu/ops/pallas_conv.py` (`conv2d_wgrad_tapcat` with
`_wgrad_kernel`, `conv2d_wgrad_reference`, `make_conv2d_custom`,
`make_conv2d_same_pallas_wgrad`, `pair_supported`, `wgrad_supported`).

Layout: the port's trunk is NCHW, so every function here takes x (B, Ci, F,
T) and the output cotangent dy (B, Co, F, T) and returns the weight gradient
as torch's OIHW (Co, Ci, kf, kt) in float32, where the JAX functions take
NHWC and return HWIO (kf, kt, Ci, Co).  The conversion to OIHW happens in
one place, the kernel's second pass.

Dispatch is by the device of the input: a CPU tensor takes the plain version
(the tests), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from mod_extraction_tpu_torch.ops import cuda_build
from mod_extraction_tpu_torch.ops.conv import (
    conv2d_pair_rows,
    conv2d_same,
    conv2d_same_backward,
    conv2d_wgrad_s2b,
)

#: Kernel launches per wrapper since the last `reset_launch_counts()`.
LAUNCHES = {"conv_wgrad": 0}
#: Blocks of the kernel that one SM holds at once; with the SM count it
#: fixes how many ways the contraction is split.
BLOCKS_PER_SM = 1

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile `csrc/conv_wgrad.cu` for sm_90a (see `cuda_build.build`)."""
    return cuda_build.build("conv_wgrad.cu", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_wgrad.argtypes = [p] * 4 + [i] * 9 + [p]
        lib.conv_wgrad.restype = i
        for const in (lib.conv_wgrad_max_kf, lib.conv_wgrad_time_tile, lib.conv_wgrad_chan_tile):
            const.argtypes = []
            const.restype = i
        lib.conv_wgrad_taps_per_block.argtypes = [i]
        lib.conv_wgrad_taps_per_block.restype = i
        lib.conv_wgrad_channels_last.argtypes = [p, p] + [i] * 5 + [p]
        lib.conv_wgrad_channels_last.restype = i
        _lib = lib
    return _lib


def pair_supported(w_shape, bin_dil: int, f: int) -> bool:
    """True when the row-pair forward/dgrad form covers this conv (w_shape
    OIHW)."""
    return w_shape[2] == 5 and bin_dil == 1 and f % 2 == 0


def wgrad_supported(w_shape, bin_dil: int, ci: int) -> bool:
    """True when K6 covers this conv (w_shape OIHW): bin dilation 1, odd
    kernel, input channels a multiple of 8 (the JAX package's rule: the
    trunk's 64-channel layers; layer 0 with its 2 input channels stays on
    the library's weight gradient)."""
    kf, kt = w_shape[2], w_shape[3]
    return bin_dil == 1 and kf % 2 == 1 and kt % 2 == 1 and ci % 8 == 0 and ci >= 8


def _check_shapes(x: torch.Tensor, dy: torch.Tensor, kf: int, kt: int, dil: int) -> None:
    if x.ndim != 4 or dy.ndim != 4:
        raise ValueError(f"expected x (B, Ci, F, T) and dy (B, Co, F, T), got {tuple(x.shape)}, {tuple(dy.shape)}")
    if (x.shape[0], x.shape[2], x.shape[3]) != (dy.shape[0], dy.shape[2], dy.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in B, F or T")
    if kf % 2 != 1 or kt % 2 != 1 or dil < 1:
        raise ValueError(f"kernel ({kf}, {kt}) must be odd and dil >= 1, got dil={dil}")


# ---------------------------------------------------------------------------
# plain version and float32 reference
# ---------------------------------------------------------------------------


def conv2d_wgrad_plain(x, dy, kf: int = 5, kt: int = 13, dil: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K6: both operands rounded to bf16, products
    and sums in float32 (one shifted matrix product per tap).  x (B, Ci, F,
    T), dy (B, Co, F, T) -> (Co, Ci, kf, kt) float32."""
    _check_shapes(x, dy, kf, kt, dil)
    f, t = x.shape[2], x.shape[3]
    hf, ht = kf // 2, (kt // 2) * dil
    xp = F.pad(x.to(torch.bfloat16).to(torch.float32), (ht, ht, hf, hf))
    g = dy.to(torch.bfloat16).to(torch.float32)
    dw = x.new_empty((dy.shape[1], x.shape[1], kf, kt), dtype=torch.float32)
    for a in range(kf):
        for j in range(kt):
            xs = xp[:, :, a : a + f, j * dil : j * dil + t]
            dw[:, :, a, j] = torch.einsum("boft,bift->oi", g, xs)
    return dw


def conv2d_wgrad_reference(x, dy, kf: int = 5, kt: int = 13, dil: int = 1) -> torch.Tensor:
    """Float32 autograd of `conv2d_same` with respect to its kernel, no bf16
    rounding: (Co, Ci, kf, kt).  The yardstick for K6's bf16 operands."""
    w0 = torch.zeros(dy.shape[1], x.shape[1], kf, kt, dtype=torch.float32, device=x.device)
    with torch.enable_grad():
        w0.requires_grad_(True)
        y = conv2d_same(x.detach().to(torch.float32), w0, None, 1, dil)
        (dw,) = torch.autograd.grad(y, w0, dy.detach().to(torch.float32))
    return dw


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def wgrad_splits(n_units: int, n_grid_other: int, sm_count: int) -> int:
    """Ways the contraction is split over blocks: as many as fill the card
    once, a function of shape and card alone, so the order of the sums is
    fixed."""
    return max(1, min(n_units, (BLOCKS_PER_SM * sm_count) // n_grid_other))


def channels_last_bf16(a: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) -> a contiguous bf16 copy laid out (B, F, T, C): K6's
    operand layout, in which TMA applies the time shift of a tap as a box
    coordinate.  On the card a copy kernel of `csrc/conv_wgrad.cu` (float32
    or bf16 in), elsewhere torch's copy."""
    b, c, f, t = a.shape
    out = torch.empty(b, f, t, c, dtype=torch.bfloat16, device=a.device)
    if a.device.type != "cuda":
        return out.copy_(a.permute(0, 2, 3, 1))
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.to(torch.float32)
    a = a.contiguous()
    with torch.cuda.device(a.device):  # the launch goes to the card of its tensors
        rc = _load().conv_wgrad_channels_last(
            a.data_ptr(), out.data_ptr(), b, c, f, t, int(a.dtype == torch.float32),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv_wgrad channels-last copy failed: cudaError {rc}")
    return out


def conv2d_wgrad_tapcat(x, dy, kf: int = 5, kt: int = 13, dil: int = 1) -> torch.Tensor:
    """Weight gradient of `conv2d_same(x, w, None, 1, dil)` with respect to
    its kernel: x (B, Ci, F, T) conv input, dy (B, Co, F, T) output
    cotangent -> (Co, Ci, kf, kt) float32, operands rounded to bf16 and
    summed in float32.  K6 on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return conv2d_wgrad_plain(x, dy, kf, kt, dil)
    if x.device.type != "cuda" or dy.device != x.device:
        raise RuntimeError(f"conv2d_wgrad_tapcat: expected CPU or CUDA tensors, got {x.device} and {dy.device}")
    _check_shapes(x, dy, kf, kt, dil)
    bsz, ci, f, t = x.shape
    co = dy.shape[1]
    if ci % 8 or co % 8:
        raise ValueError(f"conv2d_wgrad_tapcat: channels must be multiples of 8, got {ci} and {co}")
    lib = _load()
    if kf > lib.conv_wgrad_max_kf():
        raise ValueError(f"conv2d_wgrad_tapcat: kf={kf} exceeds the kernel's limit {lib.conv_wgrad_max_kf()}")
    # the one copy K6 makes: channels last, bf16
    xb = channels_last_bf16(x.detach())
    gb = channels_last_bf16(dy.detach())
    tile_c = lib.conv_wgrad_chan_tile()
    n_units = bsz * -(-t // lib.conv_wgrad_time_tile())
    n_tap_blocks = -(-kt // lib.conv_wgrad_taps_per_block(kf))
    n_other = n_tap_blocks * -(-ci // tile_c) * -(-co // tile_c)
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_split = wgrad_splits(n_units, n_other, sm_count)
    partial = torch.empty(n_split, kf, kt, co, ci, dtype=torch.float32, device=x.device)
    out = torch.empty(co, ci, kf, kt, dtype=torch.float32, device=x.device)
    LAUNCHES["conv_wgrad"] += 1
    with torch.cuda.device(x.device):
        rc = lib.conv_wgrad(
            xb.data_ptr(), gb.data_ptr(), partial.data_ptr(), out.data_ptr(),
            bsz, ci, co, f, t, kf, kt, dil, n_split,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv_wgrad kernel launch failed: code {rc} (a cudaError; -1: no "
                           f"cuTensorMapEncodeTiled in libcuda; -1000 - CUresult: it refused)")
    return out


# ---------------------------------------------------------------------------
# the conv with an explicitly chosen backward
# ---------------------------------------------------------------------------

_FWD_IMPLS = ("lax", "pair")
_DGRAD_IMPLS = ("lax", "pair", "autodiff")
_WGRAD_IMPLS = ("xla", "pallas", "s2b")


def _one_conv(impl: str, x, w, dil: int, b=None):
    if impl == "pair":
        return conv2d_pair_rows(x, w, b, 1, dil)
    return conv2d_same(x, w, b, 1, dil)


class _Conv2dCustom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dil, fwd_impl, dgrad_impl, wgrad_impl):
        ctx.save_for_backward(x, w)
        ctx.cfg = (dil, fwd_impl, dgrad_impl, wgrad_impl, b is not None)
        # the bias goes into the conv call, as on the default path, so the
        # two forwards are the same computation
        return _one_conv(fwd_impl, x, w, dil, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dil, fwd_impl, dgrad_impl, wgrad_impl, has_bias = ctx.cfg
        kf, kt = w.shape[2], w.shape[3]
        dx = dw = db = None
        odd = kf % 2 == 1 and kt % 2 == 1
        # the library's own passes, where asked for: one call for both
        lib_dx = ctx.needs_input_grad[0] and dgrad_impl == "autodiff" and fwd_impl == "lax" and odd
        lib_dw = ctx.needs_input_grad[1] and wgrad_impl == "xla" and odd
        if lib_dx or lib_dw:
            dx, dw = conv2d_same_backward(x, w, g, dil, lib_dx, lib_dw)
        if ctx.needs_input_grad[0] and dx is None:
            if dgrad_impl in ("lax", "pair"):
                # dx = same-conv of g with the flipped, channel-transposed
                # kernel (odd kernel dims keep 'same' padding symmetric)
                w_t = w.flip(2, 3).transpose(0, 1)
                dx = _one_conv(dgrad_impl, g, w_t, dil).to(x.dtype)
            else:  # autograd of the forward conv (it runs the forward again)
                with torch.enable_grad():
                    x_ = x.detach().requires_grad_(True)
                    (dx,) = torch.autograd.grad(_one_conv(fwd_impl, x_, w.detach(), dil), x_, g)
        if ctx.needs_input_grad[1]:
            if wgrad_impl == "pallas":
                dw = conv2d_wgrad_tapcat(x, g, kf, kt, dil)
            elif wgrad_impl == "s2b":
                dw = conv2d_wgrad_s2b(x, g, kf, kt, dil)
            elif dw is None:  # autograd of the plain conv, for an even kernel
                with torch.enable_grad():
                    w_ = w.detach().requires_grad_(True)
                    (dw,) = torch.autograd.grad(conv2d_same(x.detach(), w_, None, 1, dil), w_, g)
            dw = dw.to(w.dtype)
        if has_bias and ctx.needs_input_grad[2]:
            # summed in float32: the bias parameter is float32
            db = g.sum(dim=(0, 2, 3), dtype=torch.float32)
        return dx, dw, db, None, None, None, None


def make_conv2d_custom(
    dil: int,
    fwd_impl: str = "lax",
    dgrad_impl: str = "lax",
    wgrad_impl: str = "pallas",
    with_bias: bool = False,
):
    """conv2d_same(x, w, None, 1, dil) with an explicitly chosen backward.

    fwd_impl / dgrad_impl: "lax" (the plain conv) or "pair" (the row-pair
    freq-stride-2 conv, `ops/conv.py::conv2d_pair_rows`); dgrad is itself a
    same-conv of the output cotangent with the flipped, channel-transposed
    kernel, so the same pairing applies; any other dgrad_impl means
    autograd of the forward.  wgrad_impl: "xla" (the library's weight
    gradient), "pallas" (K6, `conv2d_wgrad_tapcat`) or "s2b" (the
    space-to-batch framing).  The option values are the JAX package's, so a
    model config written for it loads unchanged.

    with_bias: the returned callable takes (x, w, b) and computes conv + b,
    with db the float32 sum of the cotangent.

    The JAX function's `barrier` argument pins XLA's scheduling (it makes
    the cotangent materialise once) and never the math.  Eager PyTorch
    materialises the cotangent once in any case, so here `grad_barrier` on
    the model only selects this function, with its float32 db.

    Returns a (x, w[, b]) -> y callable on NCHW x and OIHW w."""
    if fwd_impl not in _FWD_IMPLS or wgrad_impl not in _WGRAD_IMPLS:
        raise ValueError(f"unknown conv implementation: fwd {fwd_impl!r}, wgrad {wgrad_impl!r}")
    if dgrad_impl not in _DGRAD_IMPLS:
        raise ValueError(f"unknown dgrad implementation {dgrad_impl!r}")
    if with_bias:
        return lambda x, w, b: _Conv2dCustom.apply(x, w, b, dil, fwd_impl, dgrad_impl, wgrad_impl)
    return lambda x, w: _Conv2dCustom.apply(x, w, None, dil, fwd_impl, dgrad_impl, wgrad_impl)


def make_conv2d_same_pallas_wgrad(dil: int):
    """conv2d_same(x, w, None, 1, dil) with the library's forward and dgrad
    and K6 as its weight gradient.  Returns a (x, w) -> y callable."""
    return make_conv2d_custom(dil, fwd_impl="lax", dgrad_impl="autodiff", wgrad_impl="pallas")
