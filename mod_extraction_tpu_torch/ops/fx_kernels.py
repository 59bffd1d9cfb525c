"""K1 (flanger/chorus delay line) and K2 (phaser allpass cascade): wrappers
around the hand-written CUDA kernels in `csrc/fx.cu`, their plain PyTorch
versions, and launch counters.

Replaces `mod_extraction_tpu/ops/pallas_fx.py` (`flanger_pallas` with
`_flanger_kernel`, `phaser_pallas` with `_phaser_kernel`).  Both are per-sample
recurrences with few independent rows: K1 runs a warp's worth of samples at
once wherever its feedback allows, K2 (linear in its state) runs as a
chunked affine scan; `csrc/fx.cu` says why.

Dispatch is by the device of the input: a CPU tensor takes the plain
version (the tests), a CUDA tensor launches the kernel or raises.  There is
no fallback between the two.  The library is compiled with `nvcc` at first
use into `_build/` (git-ignored) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from mod_extraction_tpu_torch.ops import cuda_build

#: Kernel launches per wrapper since the last `reset_launch_counts()`.
LAUNCHES = {"flanger": 0, "phaser": 0}
#: Samples per chunk of K2's affine scan (`csrc/fx.cu::kScanChunk`; the
#: CPU model in `tests/test_torch_phaser_scan.py` reads it).
PHASER_CHUNK = 128
#: Samples one step of K1 may run at once: a warp (`csrc/fx.cu::kWarp`).
FLANGER_STEP = 32

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile `csrc/fx.cu` for sm_90a (see `cuda_build.build`)."""
    return cuda_build.build("fx.cu", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flanger_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.flanger_forward.restype = i
        lib.phaser_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.phaser_forward.restype = i
        lib.phaser_chunk_ok.argtypes = [i, i]
        lib.phaser_chunk_ok.restype = i
        lib.phaser_scratch_floats.argtypes = [i, i, i, i]
        lib.phaser_scratch_floats.restype = ctypes.c_longlong
        lib.flanger_smem_bytes.argtypes = [i]
        lib.flanger_smem_bytes.restype = i
        for const in (lib.phaser_max_stages, lib.phaser_scan_max_stages, lib.phaser_chunk):
            const.argtypes = []
            const.restype = i
        if lib.phaser_chunk() != PHASER_CHUNK:
            raise RuntimeError(f"csrc/fx.cu scans chunks of {lib.phaser_chunk()}, not {PHASER_CHUNK}")
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _lanes(a: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast to `shape` and lay out as contiguous float32 rows."""
    return a.to(torch.float32).expand(shape).contiguous()


def _per_lane(p: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(B, 1, 1) parameter -> (B*C,) contiguous float32."""
    return p.to(torch.float32).expand(b, c, 1).reshape(b * c).contiguous()


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"{name}: expected float32 (B, C, T), got {x.dtype} {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# K1: flanger / chorus delay line
# ---------------------------------------------------------------------------


def _flanger_read(delay_samples, max_delay_samples: int):
    """K1's fractional read position for every sample of (..., T) delays:
    (prev, next, frac), prev/next int64 slots of the delay line.

    read = mod((t mod d) - delay + d, d) in float32, reduced as
    `torch.remainder` and `jnp.mod` reduce it, so a delay outside [0, d]
    reads the slot the JAX package reads."""
    d = int(max_delay_samples)
    t = delay_samples.shape[-1]
    write_idx = torch.arange(t, device=delay_samples.device) % d
    read_idx = torch.remainder(write_idx.to(torch.float32) - delay_samples + d, d)
    prev_f = torch.floor(read_idx)
    prev_idx = prev_f.to(torch.int64)
    return prev_idx, torch.remainder(prev_idx + 1, d), read_idx - prev_f


def flanger_plain(x, delay_samples, feedback, depth, mix, max_delay_samples: int):
    """Plain PyTorch version of K1 (the `_flanger_scan` contract): x / delay
    (B, C, T); feedback / depth / mix (B, 1, 1); returns the dry/wet mixed,
    clipped (B, C, T).  A Python loop over time."""
    b, c, t = x.shape
    d = int(max_delay_samples)
    prev_idx, next_idx, frac = _flanger_read(delay_samples.expand(b, c, t), d)
    fb = feedback[..., 0]
    dp = depth[..., 0]
    buf = torch.zeros(b, c, d, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for i in range(t):
        prev_val = torch.gather(buf, 2, prev_idx[:, :, i : i + 1])[..., 0]
        next_val = torch.gather(buf, 2, next_idx[:, :, i : i + 1])[..., 0]
        f = frac[:, :, i]
        interp = f * next_val + (1.0 - f) * prev_val
        x_t = x[:, :, i]
        buf[:, :, i % d] = x_t + fb * interp
        out[:, :, i] = x_t + dp * interp
    out = (1.0 - mix) * x + mix * out
    return torch.clamp(out, -1.0, 1.0)


def flanger_step_counts(delay_samples, max_delay_samples: int, shape) -> torch.Tensor:
    """The plain version of K1's step counts: per row of the (B, C, T)
    `shape`, the steps the card's kernel takes, (B*C,) int32 on the CPU.

    A step runs samples t0 .. t0 + s - 1 at once, reads before writes.  It
    may hold sample t0 + j only if both slots that sample reads were last
    written before t0: dep(t) = min(age(prev), age(next)) > j, where a
    slot's age is the samples since it was last written (d for the slot
    about to be overwritten).  Steps are greedy and at most
    `FLANGER_STEP` samples."""
    b, c, t = shape
    d = int(max_delay_samples)
    delay = delay_samples.detach().to("cpu", torch.float32).expand(b, c, t).reshape(b * c, t)
    prev_idx, next_idx, _ = _flanger_read(delay, d)
    w = torch.arange(t) % d

    def age(slot):
        a = w - slot
        return torch.where(a <= 0, a + d, a)

    dep = torch.minimum(age(prev_idx), age(next_idx)).clamp(max=FLANGER_STEP)
    dep = torch.nn.functional.pad(dep, (0, FLANGER_STEP))  # past the row: no sample
    step = torch.full((b * c, t), FLANGER_STEP, dtype=torch.int64)
    for j in reversed(range(FLANGER_STEP)):
        step = torch.where(dep[:, j : j + t] <= j, j, step)
    pos = torch.zeros(b * c, dtype=torch.int64)
    counts = torch.zeros(b * c, dtype=torch.int32)
    rows = torch.arange(b * c)
    while True:
        live = pos < t
        if not live.any():
            return counts
        counts += live.to(torch.int32)
        pos = torch.where(live, pos + step[rows, pos.clamp(max=t - 1)], pos)


def flanger(x, delay_samples, feedback, depth, mix, max_delay_samples: int, *,
            walk: bool = False, step_counts: bool = False, fixed_step: int = 0):
    """K1 on CUDA tensors, the plain version on CPU tensors (see
    `flanger_plain` for the contract).  On the card one warp steps each row
    up to `FLANGER_STEP` samples at a time, as far as the feedback allows
    (`csrc/fx.cu`), and gives the sequential walk's bits.

    walk: the sequential walk instead (one lane walks every sample); for
    the bench and the bit-identity check only.
    step_counts: also return (B*C, 2) int32: per row the steps taken and
    the times the walker found the next chunk of inputs not yet staged.  On
    CPU tensors: `flanger_step_counts` and no waits.
    fixed_step (bench only, 1 .. min(32, d)): every step runs this many
    samples whatever the delay allows, to time the staging apart from the
    steps; the output is then wrong."""
    if walk and (step_counts or fixed_step):
        raise ValueError("the sequential walk takes no steps to count or fix")
    d = int(max_delay_samples)
    if x.device.type == "cpu":
        if fixed_step:
            raise ValueError("fixed_step: only the card's kernel takes steps")
        out = flanger_plain(x, delay_samples, feedback, depth, mix, d)
        if not step_counts:
            return out
        steps = flanger_step_counts(delay_samples, d, x.shape)
        return out, torch.stack([steps, torch.zeros_like(steps)], 1)
    _require_cuda(x, "flanger")
    b, c, t = x.shape
    if d < 2:
        raise ValueError("delay line must hold at least 2 samples")
    if not 0 <= fixed_step <= min(FLANGER_STEP, d):
        raise ValueError(f"fixed_step={fixed_step} outside 0..{min(FLANGER_STEP, d)}")
    lib = _load()
    if lib.flanger_smem_bytes(d) > 232448:
        raise ValueError(f"delay line of {d} samples exceeds a block's shared memory")
    xs = x.contiguous()
    ds = _lanes(delay_samples, x.shape)
    fb, dp, mx = (_per_lane(p, b, c) for p in (feedback, depth, mix))
    out = torch.empty_like(xs)
    stats = torch.zeros(b * c, 2, dtype=torch.int32, device=x.device) if step_counts else None
    LAUNCHES["flanger"] += 1
    with torch.cuda.device(x.device):  # the launch goes to the card of its tensors
        _check(
            lib.flanger_forward(
                xs.data_ptr(), ds.data_ptr(), fb.data_ptr(), dp.data_ptr(),
                mx.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
                b * c, t, d, int(walk), int(fixed_step),
                torch.cuda.current_stream(x.device).cuda_stream,
            ),
            "flanger",
        )
    return (out, stats) if step_counts else out


# ---------------------------------------------------------------------------
# K2: phaser allpass cascade
# ---------------------------------------------------------------------------


def phaser_plain(x, g_all, feedback, mix, n_stages: int = 6):
    """Plain PyTorch version of K2 (the `_phaser_scan` contract): x / g_all
    (B, C, T), feedback / mix (B, 1, 1); returns the mixed wet signal
    before clipping.  A Python loop over time."""
    b, c, t = x.shape
    g_all = g_all.expand(b, c, t)
    big_g = g_all / (1.0 + g_all)
    fb = feedback[..., 0]
    states = [torch.zeros(b, c, dtype=torch.float32, device=x.device) for _ in range(n_stages)]
    last = torch.zeros(b, c, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for i in range(t):
        gi = big_g[:, :, i]
        u = x[:, :, i] + fb * last
        for n in range(n_stages):
            s = states[n]
            v = gi * (u - s)
            lp = v + s
            states[n] = lp + v
            u = 2.0 * lp - u
        last = u
        out[:, :, i] = u
    return (1.0 - mix) * x + mix * out


def phaser(x, g_all, feedback, mix, n_stages: int = 6, chunk_states: bool = False,
           chunk: int = PHASER_CHUNK):
    """K2 on CUDA tensors, the plain version on CPU tensors (see
    `phaser_plain` for the contract).  On the card, up to
    `phaser_scan_max_stages()` (8) stages run as a chunked affine scan over
    time (three launches, counted as one), more as a sequential walk.

    chunk_states (scan only, for diagnostics): also return the scan's
    per-chunk transitions P (B*C, chunks, n+1, n+1), offsets q (B*C,
    chunks, n+1) and entry states z (B*C, chunks, n+1), state order (s_1 ..
    s_n, last).  chunk: the scan's chunk length; other than
    `PHASER_CHUNK` only 32, 64, 256 and 512 at 6 stages, or 0 for the
    sequential walk at any stage count (`scripts/bench_torch_fx.py` sweeps
    them)."""
    if x.device.type == "cpu":
        if chunk_states:
            raise ValueError("chunk_states: the plain version has no chunks")
        return phaser_plain(x, g_all, feedback, mix, n_stages)
    _require_cuda(x, "phaser")
    b, c, t = x.shape
    lib = _load()
    if not 1 <= n_stages <= lib.phaser_max_stages():
        raise ValueError(f"n_stages={n_stages} outside 1..{lib.phaser_max_stages()}")
    scan = n_stages <= lib.phaser_scan_max_stages() and chunk != 0
    if scan and not lib.phaser_chunk_ok(n_stages, chunk):
        raise ValueError(f"the scan is not built for chunks of {chunk} at {n_stages} stages")
    if chunk_states and not scan:
        raise ValueError(f"chunk_states: {n_stages} stages, chunk {chunk} take the walk, not the scan")
    xs = x.contiguous()
    gs = _lanes(g_all, x.shape)
    fb, mx = (_per_lane(p, b, c) for p in (feedback, mix))
    out = torch.empty_like(xs)
    scratch = torch.empty(lib.phaser_scratch_floats(b * c, t, n_stages, chunk), dtype=torch.float32,
                          device=x.device)
    LAUNCHES["phaser"] += 1
    with torch.cuda.device(x.device):
        _check(
            lib.phaser_forward(
                xs.data_ptr(), gs.data_ptr(), fb.data_ptr(), mx.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), b * c, t, n_stages, chunk,
                torch.cuda.current_stream(x.device).cuda_stream,
            ),
            "phaser",
        )
    if not chunk_states:
        return out
    z, n_chunks = n_stages + 1, -(-t // chunk)
    pq, zs = scratch.split([b * c * n_chunks * z * (z + 1), b * c * n_chunks * z])
    pq = pq.view(b * c, n_chunks, z * (z + 1))
    p = pq[..., : z * z].view(b * c, n_chunks, z, z)
    return out, p, pq[..., z * z :], zs.view(b * c, n_chunks, z)
