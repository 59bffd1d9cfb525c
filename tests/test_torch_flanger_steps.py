"""K1's warp-wide steps (`csrc/fx.cu::flanger_step_kernel`) modelled on the
CPU in float32, against the sequential walk.

Sample t of a row reads delay-line slots prev and next and writes slot
t mod d.  A slot's age is the samples since it was last written (d for the
slot about to be overwritten); dep(t) is the lesser age of the two slots
sample t reads.  The kernel runs samples t0 .. t0 + s - 1 at once, every
read before every write, with s the longest run, at most 32 (a warp), in
which dep(t0 + j) > j for every j.  Each sample's arithmetic is the walk's,
so the result is the walk's bits.

`stepped_model` below does this with numpy, one row at a time, computing
read, prev and next itself from the float32 delay.  It is held bit for bit
against `fx_kernels.flanger_plain` (the walk) at the edges of the stepping
and on a stage-1 clip, and within 1e-5 max-abs of the JAX package's
`_flanger_scan` (the limit `tests/test_torch_fx.py` holds K1's plain
version to: the two libraries may round the lerp differently).  Its step
counts are held equal to `fx_kernels.flanger_step_counts` (the plain
version of the kernel's step-count output, which `chip_smoke.py` holds the
card's counts against) and pinned on the batches `chip_smoke.py` times.
The CUDA kernel itself is compared with `flanger_plain` and the walk on the
card (`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import fx as jfx
from mod_extraction_tpu_torch.data.synthetic import (
    batch_to_torch,
    make_interwoven_batch,
    make_synthetic_batch,
)
from mod_extraction_tpu_torch.ops import fx_kernels
from mod_extraction_tpu_torch.train.render import flanger_delay_samples
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim

STEP = fx_kernels.FLANGER_STEP
SR, N_SAMPLES = 44100.0, 88200
JAX_TOL = 1e-5
F32 = np.float32


def _read(delay, d):
    """(prev, next, frac) of every sample of (rows, T) float32 delays, as
    the walk computes them: read = mod((t mod d) - delay + d, d)."""
    w = (np.arange(delay.shape[-1]) % d).astype(F32)
    read = np.remainder((w - delay) + F32(d), F32(d))
    prev_f = np.floor(read)
    prev = prev_f.astype(np.int64)
    return prev, (prev + 1) % d, (read - prev_f).astype(F32)


def _dep(prev, nxt, d):
    """min(age(prev), age(next)) per sample, capped at STEP."""
    w = np.arange(prev.shape[-1]) % d
    age = lambda slot: (w - slot - 1) % d + 1  # noqa: E731
    return np.minimum(np.minimum(age(prev), age(nxt)), STEP)


def _steps(dep_row):
    """Greedy step starts of one row."""
    t, starts = dep_row.shape[0], []
    t0 = 0
    while t0 < t:
        starts.append(t0)
        s = 1
        while s < STEP and t0 + s < t and dep_row[t0 + s] > s:
            s += 1
        t0 += s
    return starts + [t]


def stepped_model(x, delay, fb, depth, mix, d):
    """K1 run in the kernel's steps: numpy float32, (B, C, T) x / delay,
    (B, 1, 1) parameters.  Returns (out (B, C, T), steps per row)."""
    b, c, t = x.shape
    rows = b * c
    xr = x.reshape(rows, t)
    prev, nxt, frac = _read(np.broadcast_to(delay, x.shape).reshape(rows, t), d)
    dep = _dep(prev, nxt, d)
    fbr = np.broadcast_to(fb, (b, c, 1)).reshape(rows)
    interp = np.empty((rows, t), F32)
    counts = []
    for r in range(rows):
        buf = np.zeros(d, F32)
        starts = _steps(dep[r])
        counts.append(len(starts) - 1)
        for t0, t1 in zip(starts[:-1], starts[1:]):
            sl = slice(t0, t1)
            f = frac[r, sl]
            pv, nv = buf[prev[r, sl]], buf[nxt[r, sl]]  # every read of the step ...
            it = f * nv + (F32(1) - f) * pv
            buf[np.arange(t0, t1) % d] = xr[r, sl] + fbr[r] * it  # ... before any write
            interp[r, sl] = it
    wet = x + depth * interp.reshape(b, c, t)
    out = np.clip((F32(1) - mix) * x + mix * wet, F32(-1), F32(1))
    return out.astype(F32), np.array(counts)


def _params(rng, b):
    fb = rng.uniform(0, 0.7, (b, 1, 1)).astype(F32)
    depth = rng.uniform(0.25, 1.0, (b, 1, 1)).astype(F32)
    mix = rng.uniform(0.25, 1.0, (b, 1, 1)).astype(F32)
    return fb, depth, mix


def _edge_delays(rng, t, d):
    """One row per edge of the stepping: (rows, 1, T) float32 delays."""
    below = np.nextafter(F32(3.0), F32(0))  # one float32 ulp below an integer
    rows = [
        rng.uniform(0, d, t),  # random per sample, over the whole line
        np.zeros(t),  # delay exactly 0 (reads the slot about to be written)
        np.full(t, d),  # delay exactly d (the same slot)
        np.full(t, 0.37),  # constant in (0, 1): the sample just written
        np.full(t, 1.0),
        np.full(t, 2.0),
        np.full(t, min(31.0, d - 0.5)),
        np.full(t, below),
        np.nextafter(rng.integers(1, d, t).astype(F32), F32(0)),  # each an ulp below an integer
        0.5 + 0.49 * np.sin(np.arange(t) / 7.0) ** 2 * min(d - 1, 8),  # a sweep down near 0
    ]
    return np.stack(rows)[:, None, :].astype(F32)


def _check_edges(t, d, seed):
    rng = np.random.default_rng(seed)
    delay = _edge_delays(rng, t, d)
    b = delay.shape[0]
    x = rng.uniform(-0.9, 0.9, (b, 1, t)).astype(F32)
    fb, depth, mix = _params(rng, b)
    got, counts = stepped_model(x, delay, fb, depth, mix, d)
    args = tuple(map(torch.as_tensor, (x, delay, fb, depth, mix)))
    want = fx_kernels.flanger_plain(*args, d).numpy()
    np.testing.assert_array_equal(got, want)
    assert counts.tolist() == fx_kernels.flanger_step_counts(args[1], d, x.shape).tolist()
    return counts


@pytest.mark.parametrize("t", [1, 31, 32, 33, 511, 513])
@pytest.mark.parametrize("d", [2, 17, 485])
def test_model_is_the_walk_at_the_edges(d, t):
    """Bit for bit at delays exactly 0 and d, constant in (0, 1), integer
    1 / 2 / 31, an ulp below an integer, d below a warp, and T around a warp
    and a chunk of the kernel's ring (512 samples)."""
    counts = _check_edges(t, d, seed=d * 1000 + t)
    assert counts.min() >= -(-t // STEP) and counts.max() <= t


def test_model_steps_where_the_delay_allows():
    """What the stepping does at each edge regime (d 485, T 1000).  A delay
    of 0 or d reads slots d and d - 1 samples old: 32 samples a step.  An
    integer delay k reads slots k and k - 1 back (next is read even where
    frac is 0): k - 1 samples a step, one for a delay in (0, 2]."""
    counts = _check_edges(1000, 485, seed=7)
    assert counts[1] == counts[2] == -(-1000 // STEP)  # 0, d
    assert counts[3] == counts[4] == counts[5] == 1000  # 0.37, 1, 2
    assert counts[6] == -(-1000 // 30)  # 31
    assert counts[7] == 500  # an ulp below 3 rounds to 3 in (w - delay) + d


def _render_delays(batch):
    tb = batch_to_torch(batch, "cpu")
    mod_audio = linear_interpolate_last_dim(tb["mod_sig"], N_SAMPLES)[:, None, :]
    return tb, flanger_delay_samples(tb["fx"], mod_audio, SR)


def test_model_on_a_stage1_clip_is_the_walk_and_near_jax():
    """(3, 1, 88200), interwoven seed 2000 (the rows `chip_smoke.py`
    compares card against CPU): bit for bit against `flanger_plain`, within
    1e-5 of JAX's `_flanger_scan`."""
    tb, delay = _render_delays(make_interwoven_batch(2000, 3, N_SAMPLES, SR))
    fx = tb["fx"]
    args = (tb["dry"], delay, fx["feedback"][:, None, None], fx["depth"][:, None, None],
            fx["mix"][:, None, None])
    d = 1764
    got, counts = stepped_model(*(a.numpy() for a in args), d)
    want = fx_kernels.flanger_plain(*args, d).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jfx._flanger_scan(*(jnp.asarray(a.numpy()) for a in args), d))
    assert np.abs(got - ref).max() <= JAX_TOL
    assert counts.tolist() == fx_kernels.flanger_step_counts(delay, d, args[0].shape).tolist()


@pytest.mark.parametrize(
    "make,d,worst,total",
    [
        (lambda: make_interwoven_batch(4, 32, N_SAMPLES, SR), 1764, 3711, 89827),
        (lambda: make_synthetic_batch(0, 32, N_SAMPLES, SR, "flanger"), 485, 4585, 93988),
    ],
    ids=["interwoven-seed4-d1764", "flanger-seed0-d485"],
)
def test_step_counts_on_the_path_batches(make, d, worst, total):
    """Steps per row on the batches `chip_smoke.py` runs, against the walk's
    88200: the worst row sets the kernel's time; 2757 = 88200 / 32 is the
    least any row can take."""
    _, delay = _render_delays(make())
    dep = _dep(*_read(delay.expand(32, 1, N_SAMPLES).reshape(32, N_SAMPLES).numpy(), d)[:2], d)
    counts = np.array([len(_steps(row)) - 1 for row in dep])
    plain = fx_kernels.flanger_step_counts(delay, d, (32, 1, N_SAMPLES))
    assert counts.tolist() == plain.tolist()
    assert counts.max() == worst and counts.sum() == total
    assert counts.min() == -(-N_SAMPLES // STEP) == 2757


@pytest.mark.parametrize("lo,hi", [(37.0, 74.0), (-0.01, 0.0), (-37.0, 74.0)],
                         ids=["d-to-2d", "slightly-below-0", "both"])
def test_plain_reads_outside_the_line_as_jax(lo, hi):
    """Delays outside [0, d], d 37: `flanger_plain` takes the read position
    modulo d as `jnp.mod` does, so it reads the slots JAX's `_flanger_scan`
    reads (within 1e-5); the stepped model gives its bits."""
    rng = np.random.default_rng(11)
    b, t, d = 4, 700, 37
    x = rng.uniform(-0.9, 0.9, (b, 1, t)).astype(F32)
    delay = rng.uniform(lo, hi, (b, 1, t)).astype(F32)
    fb, depth, mix = _params(rng, b)
    args = (x, delay, fb, depth, mix)
    got = fx_kernels.flanger_plain(*map(torch.as_tensor, args), d).numpy()
    ref = np.asarray(jfx._flanger_scan(*map(jnp.asarray, args), d))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, atol=JAX_TOL, rtol=0)
    np.testing.assert_array_equal(stepped_model(*args, d)[0], got)


def test_cpu_wrapper_counts_the_plain_steps():
    """On CPU tensors `flanger(..., step_counts=True)` is the plain version
    and its step counts, with no waits; the card-only options refuse."""
    rng = np.random.default_rng(3)
    delay = _edge_delays(rng, 300, 40)
    b = delay.shape[0]
    x = rng.uniform(-0.9, 0.9, (b, 1, 300)).astype(F32)
    args = tuple(map(torch.as_tensor, (x, delay, *_params(rng, b))))
    fx_kernels.reset_launch_counts()
    out, stats = fx_kernels.flanger(*args, 40, step_counts=True)
    assert torch.equal(out, fx_kernels.flanger_plain(*args, 40))
    assert stats.dtype == torch.int32 and stats.shape == (b, 2)
    assert stats[:, 0].tolist() == stepped_model(*(a.numpy() for a in args), 40)[1].tolist()
    assert stats[:, 1].eq(0).all()
    assert fx_kernels.LAUNCHES["flanger"] == 0
    with pytest.raises(ValueError, match="only the card"):
        fx_kernels.flanger(*args, 40, fixed_step=32)
    with pytest.raises(ValueError, match="no steps"):
        fx_kernels.flanger(*args, 40, walk=True, step_counts=True)


def test_model_step_is_the_kernels():
    """A step is at most a warp, and the ring's chunk that the edge cases
    straddle is the kernel's (the CPU cannot load the library, so read the
    source)."""
    src = (Path(fx_kernels.__file__).resolve().parent.parent / "csrc" / "fx.cu").read_text()
    assert int(re.search(r"constexpr int kWarp = (\d+);", src).group(1)) == STEP
    assert int(re.search(r"constexpr int kFlChunk = (\d+);", src).group(1)) == 512
