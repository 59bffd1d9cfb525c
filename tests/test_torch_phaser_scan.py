"""K2's chunked affine scan (`csrc/fx.cu::phaser_scan_*_kernel`) modelled on
the CPU in float32, against the sequential walk.

The phaser cascade is linear in its state z = (s_1 .. s_n, last): one
sample maps it as z' = A(G_t, fb) z + b(G_t) x_t.  The kernel cuts each row
into chunks of `fx_kernels.PHASER_CHUNK` samples and

1. walks every chunk from z = 0 driven by x (its offset q_c) and from the
   n + 1 unit states with x = 0 (its transition P_c), all chunks at once;
2. joins the chunks in order, z_{c+1} = P_c z_c + q_c, one row at a time;
3. walks every chunk again from z_c, driven by x, as the plain walk does.

`phaser_scan_model` below does the same three passes, vectorised over
chunks, with the kernel's chunk length and its order of the sums in pass 2.
It is held against `fx_kernels.phaser_plain` (T <= 6000) and the JAX
package's `_phaser_scan` (T = 88200, the stage-1 clip), within 1e-4
max-abs: the tolerance K2 is held to on the card.  A float64 walk reports
the decomposition's own error beside the float32 walk's.  The CUDA kernel
itself is compared with `phaser_plain` on the card
(`tests/test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import fx as jfx
from mod_extraction_tpu_torch.ops import fx_kernels

TOL = 1e-4
CHUNK = fx_kernels.PHASER_CHUNK


def _walk(z, x, big_g, fb, n_stages):
    """The plain walk over the last axis of x / big_g from state z (..., n +
    1): returns the cascade outputs u (..., L) and the final state."""
    s = [z[..., k] for k in range(n_stages)]
    last = z[..., n_stages]
    out = []
    for i in range(x.shape[-1]):
        gi = big_g[..., i]
        u = x[..., i] + fb * last
        for k in range(n_stages):
            v = gi * (u - s[k])
            lp = v + s[k]
            s[k] = lp + v
            u = 2.0 * lp - u
        last = u
        out.append(u)
    return torch.stack(out, -1), torch.stack(s + [last], -1)


def phaser_scan_model(x, g_all, feedback, mix, n_stages: int = 6, chunk: int = CHUNK,
                      stats: dict | None = None):
    """The kernel's three passes in float32: x / g_all (B, C, T), feedback /
    mix (B, 1, 1) -> the mixed output (B, C, T), as `phaser_plain`.  With
    `stats`, records max|P_c| and the largest z_c there."""
    b, c, t = x.shape
    n = n_stages
    big_g = g_all.expand(b, c, t) / (1.0 + g_all.expand(b, c, t))
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    xc = torch.nn.functional.pad(x, (0, pad)).reshape(b, c, n_chunks, chunk)
    gc = torch.nn.functional.pad(big_g, (0, pad)).reshape(b, c, n_chunks, chunk)

    # pass 1: walk 0 from zero driven by x, walks 1 .. n + 1 from the unit
    # states with x = 0, all sharing G
    z0 = torch.zeros(b, c, n_chunks, n + 2, n + 1)
    z0[..., 1:, :] = torch.eye(n + 1)
    drive = torch.zeros(b, c, n_chunks, n + 2, chunk)
    drive[..., 0, :] = xc
    _, zend = _walk(z0, drive, gc[..., None, :].expand_as(drive), feedback[..., None], n)
    q = zend[..., 0, :]  # (B, C, chunks, n + 1)
    p = zend[..., 1:, :].transpose(-1, -2)  # p[..., i, j]: state i after unit j

    # pass 2: in order, z_{c+1}[i] = q_c[i] + sum_j P_c[i, j] z_c[j] (j upwards)
    zs = torch.zeros(b, c, n_chunks, n + 1)
    z = torch.zeros(b, c, n + 1)
    for k in range(n_chunks - 1):
        zs[:, :, k] = z
        acc = q[:, :, k].clone()
        for j in range(n + 1):
            acc = acc + p[:, :, k, :, j] * z[..., j : j + 1]
        z = acc
    zs[:, :, n_chunks - 1] = z
    if stats is not None:
        stats["max_p"] = p[:, :, :-1].abs().max().item() if n_chunks > 1 else 0.0
        stats["max_z"] = zs.abs().max().item()

    # pass 3: every chunk again from its z_c, driven by x
    u, _ = _walk(zs, xc, gc, feedback, n)
    wet = u.reshape(b, c, n_chunks * chunk)[..., :t]
    return (1.0 - mix) * x + mix * wet


def _inputs(seed, b, t, fb_hi, g_lo, g_hi):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (b, 1, t)).astype(np.float32)
    # g sweeps log-uniformly between its extremes, as the LFO-driven
    # coefficient does, with a random phase per row
    ph = rng.uniform(0, 2 * np.pi, (b, 1, 1))
    lfo = 0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * np.arange(t) / 44100.0 + ph)
    g = (g_lo * (g_hi / g_lo) ** lfo).astype(np.float32)
    fb = np.full((b, 1, 1), fb_hi, np.float32)
    mix = rng.uniform(0.2, 1.0, (b, 1, 1)).astype(np.float32)
    return x, g, fb, mix


def _walk64(x, g, fb, mix, n_stages):
    """The sequential walk in float64 (numpy, vectorised over rows)."""
    x64, g64 = x.astype(np.float64)[:, 0], g.astype(np.float64)[:, 0]
    big_g = g64 / (1.0 + g64)
    f = fb.astype(np.float64)[:, 0, 0]
    s = np.zeros((x.shape[0], n_stages))
    last = np.zeros(x.shape[0])
    out = np.empty_like(x64)
    for i in range(x64.shape[1]):
        gi = big_g[:, i]
        u = x64[:, i] + f * last
        for k in range(n_stages):
            v = gi * (u - s[:, k])
            lp = v + s[:, k]
            s[:, k] = lp + v
            u = 2.0 * lp - u
        last = u
        out[:, i] = u
    m = mix.astype(np.float64)[:, :, 0]
    return ((1.0 - m) * x64 + m * out)[:, None]


CASES = [  # (n_stages, feedback, g_lo, g_hi)
    (1, 0.0, 0.001, 32.0),
    (6, 0.0, 0.001, 32.0),
    (6, 0.7, 0.001, 32.0),
    (8, 0.7, 0.001, 32.0),
    (8, 0.0, 0.01, 1.5),
    (6, 0.7, 0.001, 0.002),
    (6, 0.7, 30.0, 32.0),
    (1, 0.7, 0.001, 32.0),
]


@pytest.mark.parametrize("n_stages,fb,g_lo,g_hi", CASES)
@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, CHUNK + 1, 6000])
def test_scan_model_matches_plain(t, n_stages, fb, g_lo, g_hi):
    x, g, f, mix = _inputs(t + n_stages, 2, t, fb, g_lo, g_hi)
    args = tuple(map(torch.as_tensor, (x, g, f, mix)))
    got = phaser_scan_model(*args, n_stages)
    want = fx_kernels.phaser_plain(*args, n_stages)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("n_stages,fb,g_lo,g_hi", CASES[1:4])
def test_scan_model_matches_jax_scan_on_a_clip(n_stages, fb, g_lo, g_hi):
    """T = 88200 (2 s at 44.1 kHz), 4 rows: the model against the JAX
    package's `lax.scan` walk, and both against a float64 walk."""
    x, g, f, mix = _inputs(n_stages, 4, 88200, fb, g_lo, g_hi)
    stats = {}
    got = phaser_scan_model(*map(torch.as_tensor, (x, g, f, mix)), n_stages, stats=stats).numpy()
    ref = np.asarray(jfx._phaser_scan(*map(jnp.asarray, (x, g, f, mix)), n_stages))
    err = np.abs(got - ref).max()
    ref64 = _walk64(x, g, f, mix, n_stages)
    err64, err64_walk = np.abs(got - ref64).max(), np.abs(ref - ref64).max()
    print(f"n={n_stages} fb={fb} g in [{g_lo}, {g_hi}]: scan vs walk {err:.3e}; vs float64: "
          f"scan {err64:.3e}, float32 walk {err64_walk:.3e}; max|P_c| {stats['max_p']:.3f} "
          f"max|z_c| {stats['max_z']:.3f}")
    assert err <= TOL
    assert err64 <= TOL


def test_model_chunk_is_the_kernels():
    """The model's chunk length is the one `csrc/fx.cu` is built with (the
    CPU cannot load the library, so read the source)."""
    import re
    from pathlib import Path

    src = (Path(fx_kernels.__file__).resolve().parent.parent / "csrc" / "fx.cu").read_text()
    assert int(re.search(r"constexpr int kScanChunk = (\d+);", src).group(1)) == CHUNK


def test_cpu_wrapper_takes_the_plain_walk():
    """On CPU tensors K2's wrapper is the plain walk; the scan's diagnostics
    exist only on the card."""
    x, g, f, mix = map(torch.as_tensor, _inputs(3, 2, 300, 0.7, 0.001, 32.0))
    fx_kernels.reset_launch_counts()
    assert torch.equal(fx_kernels.phaser(x, g, f, mix, 6), fx_kernels.phaser_plain(x, g, f, mix, 6))
    assert fx_kernels.LAUNCHES["phaser"] == 0
    with pytest.raises(ValueError, match="no chunks"):
        fx_kernels.phaser(x, g, f, mix, 6, chunk_states=True)
