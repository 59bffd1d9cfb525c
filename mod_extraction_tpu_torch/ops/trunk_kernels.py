"""K7: the Spectral2DCNN trunk's block between two convs (conv i's bias, the
floor-mode (p, 1) max pool with its eq-mask backward, the per-channel
PReLU, the affine-free LayerNorm over (freq, frames), the cast to the next
conv's dtype), as one hand-written CUDA kernel forward and one backward
(`csrc/trunk_block.cu`), its plain PyTorch version, and launch counters.

It replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it.  Eager PyTorch runs it as about twenty passes over each conv
output.  The backward kernel reads the conv output and the cotangent once
and keeps everything between on chip.  The forward kernel reads the conv
output once; where LayerNorm follows, it writes PReLU's float32 output, of
which torch takes the planes' mean and variance with the eager chain's own
reductions, and a second kernel normalises it: the forward's bits are the
eager chain's (`csrc/trunk_block.cu` says why).

Dispatch is by the device of the conv output: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.  There is no fallback
between the two.  The library is compiled with `nvcc` at first use into
`_build/` (git-ignored) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from mod_extraction_tpu_torch.models.common import layer_norm_no_affine, max_pool_floor, prelu
from mod_extraction_tpu_torch.ops import cuda_build
from mod_extraction_tpu_torch.ops.conv import from_time_phases

#: Kernel launches per wrapper since the last `reset_launch_counts()` (the
#: backward's per-channel sum over the batch counts with its kernel).
LAUNCHES = {"trunk_block_fwd": 0, "trunk_block_bwd": 0}
#: dtypes the kernels take for the conv output and the block's output
DTYPES = (torch.bfloat16, torch.float32)
#: LayerNorm's eps (`layer_norm_no_affine`'s, as the model calls it)
LN_EPS = 1e-5

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile `csrc/trunk_block.cu` for sm_90a (see `cuda_build.build`)."""
    return cuda_build.build("trunk_block.cu", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        geometry = [ll, ll, ll, i, i, i, i, i, i, i, p]
        lib.trunk_block_forward.argtypes = [p, p, p, p, i, i, i] + geometry
        lib.trunk_block_forward.restype = i
        lib.trunk_block_norm.argtypes = [p, p, p, p, i, i, i, i, ll, p]
        lib.trunk_block_norm.restype = i
        lib.trunk_block_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i] + geometry
        lib.trunk_block_backward.restype = i
        lib.trunk_block_cluster.argtypes = [ll, i, i, i, i, i, i, i, i]
        lib.trunk_block_cluster.restype = i
        lib.trunk_block_max_cluster.argtypes = []
        lib.trunk_block_max_cluster.restype = i
        _lib = lib
    return _lib


class Block(NamedTuple):
    """What the block does besides its tensors.

    phases: the conv output's time phases (`ops/conv.py::conv2d_same_phases`);
    width: the frames (needed with phases > 1); pool: the pool's rows;
    ln: LayerNorm on; narrow: PReLU and LayerNorm's result in the conv's dtype
    (`act_io_dtype="compute"`), else PReLU promotes to float32; out_dtype: the
    block's output."""

    phases: int = 1
    width: int | None = None
    pool: int = 2
    ln: bool = True
    narrow: bool = False
    out_dtype: torch.dtype = torch.bfloat16


def trunk_block_plain(y, bias, alpha, blk: Block) -> torch.Tensor:
    """Plain PyTorch version of K7, the eager chain operation for operation:
    y the conv output without its bias, (B*d, C, H, ceil(W/d)) over
    `blk.phases` time phases; bias the conv's (C,) float32 bias, or None
    where the conv added it; alpha PReLU's (C,) float32.  Returns (B, C,
    H // pool, W) in `blk.out_dtype`."""
    h = from_time_phases(y, blk.phases, blk.width) if blk.phases > 1 else y
    if bias is not None:
        # the pass the card's library runs after the conv's product
        h = h + bias.to(h.dtype).reshape(1, -1, 1, 1)
    h = max_pool_floor(h, (blk.pool, 1))
    h = prelu(h, alpha, keep_dtype=blk.narrow)
    if blk.ln:
        h = layer_norm_no_affine(h, dims=(2, 3), eps=LN_EPS, stat_dtype=torch.float32 if blk.narrow else None)
    return h.to(blk.out_dtype)


def _shape(y, blk: Block) -> tuple:
    """(B, C, H, W, d, wq) of the conv output, checked."""
    if y.ndim != 4:
        raise ValueError(f"trunk_block: expected a 4-D conv output, got {tuple(y.shape)}")
    bd, c, h, wq = y.shape
    d = int(blk.phases)
    if d < 1 or bd % d:
        raise ValueError(f"trunk_block: {bd} batch rows do not hold {d} time phases")
    w = wq if blk.width is None else int(blk.width)
    if -(-w // d) != wq:
        raise ValueError(f"trunk_block: {w} frames over {d} phases are not {wq} positions a phase")
    if not 1 <= blk.pool <= h:
        raise ValueError(f"trunk_block: a pool of {blk.pool} rows over {h} rows")
    return bd // d, c, h, w, d, wq


def _check(y, bias, alpha, blk: Block) -> tuple:
    """Raises on what the kernels do not take; returns the shape."""
    if y.device.type != "cuda":
        raise RuntimeError(f"trunk_block: expected a CPU or CUDA tensor, got {y.device}")
    if y.dtype not in DTYPES or blk.out_dtype not in DTYPES:
        raise ValueError(f"trunk_block: conv output {y.dtype}, output {blk.out_dtype}; the kernels take "
                         f"{DTYPES}")
    b, c, h, w, d, wq = shape = _shape(y, blk)
    for name, p in (("alpha", alpha), ("bias", bias)):
        if p is not None and (p.dtype != torch.float32 or tuple(p.shape) != (c,) or p.device != y.device):
            raise ValueError(f"trunk_block: {name} must be float32 ({c},) on {y.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    if y.stride(3) != 1 or y.stride(2) < wq:
        raise ValueError(f"trunk_block: the kernels read frames back to back in rows, got strides {y.stride()}")
    if d * c * h * wq >= 2**31 or b * c * h * wq * d >= 2**40:
        raise ValueError(f"trunk_block: a conv output of {tuple(y.shape)} is past the kernels' indexing")
    return shape


@functools.lru_cache(maxsize=256)
def _cluster_size(*shape) -> int:
    return _load().trunk_block_cluster(*shape)


def _cluster(lib, y, blk: Block, bwd: bool) -> int:
    """CTAs a plane takes (`csrc/trunk_block.cu::plan`); raises for a plane
    that does not fit."""
    _, _, h, w, d, wq = _shape(y, blk)
    k = _cluster_size(y.stride(2), h, w, d, wq, blk.pool, y.element_size(),
                      torch.empty((), dtype=blk.out_dtype).element_size(), int(bwd))
    if k == 0:
        raise ValueError(f"trunk_block: a plane of {h} x {w} ({d} phases of {wq}) does not fit "
                         f"{lib.trunk_block_max_cluster()} CTAs' shared memory")
    return k


def _geometry(y, blk: Block, stream) -> list:
    b, c, h, w, d, wq = _shape(y, blk)
    return [y.stride(0), y.stride(1), y.stride(2), b, c, h, w, d, wq, blk.pool, stream]


def _ln_mode(blk: Block) -> int:
    return 0 if not blk.ln else (2 if blk.narrow else 1)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(y):
    return torch.cuda.current_stream(y.device).cuda_stream


def _forward(y, bias, alpha, blk: Block, save: bool):
    """The forward: (out, stats), stats the planes' LayerNorm (mean, den)
    as (B*C,) float32 with `save` and LayerNorm on, else None."""
    b, c, h, w, _, _ = _check(y, bias, alpha, blk)
    lib = _load()
    _cluster(lib, y, blk, bwd=False)
    if save:
        _cluster(lib, y, blk, bwd=True)  # a plane the backward cannot take raises now
    x_dtype = torch.float32 if blk.ln else blk.out_dtype
    x = torch.empty((b, c, h // blk.pool, w), dtype=x_dtype, device=y.device)
    LAUNCHES["trunk_block_fwd"] += 1
    with torch.cuda.device(y.device):
        rc = lib.trunk_block_forward(
            y.data_ptr(), _ptr(bias), alpha.data_ptr(), x.data_ptr(), int(y.dtype == torch.bfloat16),
            int(x_dtype == torch.bfloat16), int(blk.narrow), *_geometry(y, blk, _stream(y)))
        if rc != 0:
            raise RuntimeError(f"trunk_block forward kernel launch failed: cudaError {rc}")
        if not blk.ln:
            return x, None
        # `layer_norm_no_affine`'s statistics, by the same reductions
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        den = torch.rsqrt(var + LN_EPS) if blk.narrow else torch.sqrt(var + LN_EPS)
        out = torch.empty(x.shape, dtype=blk.out_dtype, device=y.device)
        rc = lib.trunk_block_norm(
            x.data_ptr(), mean.data_ptr(), den.data_ptr(), out.data_ptr(), int(blk.out_dtype == torch.bfloat16),
            _ln_mode(blk), int(blk.narrow and y.dtype == torch.bfloat16), b * c, x[0, 0].numel(), _stream(y))
    if rc != 0:
        raise RuntimeError(f"trunk_block norm kernel launch failed: cudaError {rc}")
    return out, ((mean.view(-1), den.view(-1)) if save else None)


def _backward(y, bias, alpha, stats, g, blk: Block):
    """The backward: (dy in y's shape, contiguous; dbias or None; dalpha),
    the parameters' gradients in float32."""
    b, c, h, w, _, _ = _check(y, bias, alpha, blk)
    lib = _load()
    _cluster(lib, y, blk, bwd=True)
    g = g.to(blk.out_dtype).contiguous()
    mean, den = stats if stats is not None else (None, None)
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    part = torch.empty(b * c * lib.trunk_block_max_cluster() * 2, dtype=torch.float32, device=y.device)
    dalpha = torch.empty(c, dtype=torch.float32, device=y.device)
    dbias = None if bias is None else torch.empty(c, dtype=torch.float32, device=y.device)
    LAUNCHES["trunk_block_bwd"] += 1
    with torch.cuda.device(y.device):
        rc = lib.trunk_block_backward(
            y.data_ptr(), _ptr(bias), alpha.data_ptr(), _ptr(mean), _ptr(den), g.data_ptr(), dy.data_ptr(),
            part.data_ptr(), dalpha.data_ptr(), _ptr(dbias), int(y.dtype == torch.bfloat16),
            int(blk.out_dtype == torch.bfloat16), int(blk.narrow), _ln_mode(blk), *_geometry(y, blk, _stream(y)))
    if rc != 0:
        raise RuntimeError(f"trunk_block backward kernel launch failed: cudaError {rc}")
    return dy, dbias, dalpha


class _TrunkBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, alpha, blk):
        out, stats = _forward(y, bias, alpha, blk, save=True)
        # the conv output is kept as it is (no copy): the backward reads it again
        ctx.save_for_backward(y, bias, alpha, *(stats or ()))
        ctx.blk = blk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, bias, alpha, *stats = ctx.saved_tensors
        dy, dbias, dalpha = _backward(y, bias, alpha, stats or None, g, ctx.blk)
        return dy, dbias, dalpha, None


def trunk_block(y, bias, alpha, blk: Block) -> torch.Tensor:
    """K7 on CUDA tensors, the plain version on CPU tensors (see
    `trunk_block_plain` for the contract).  Without gradients to take (no
    grad mode, or nothing that requires one) the card's forward saves
    nothing."""
    if y.device.type == "cpu":
        return trunk_block_plain(y, bias, alpha, blk)
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (y, bias, alpha))
    if wants_grad:
        return _TrunkBlock.apply(y, bias, alpha, blk)
    return _forward(y, bias, alpha, blk, save=False)[0]
