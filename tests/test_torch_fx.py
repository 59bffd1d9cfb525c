"""The port's effects (K1 flanger/chorus delay line, K2 phaser cascade, the
phaser prologue, render_batch) against the JAX package on the CPU.

Each CPU tensor goes through the kernel's plain PyTorch version; the JAX
side runs its `lax.scan` references and, for the kernels, the Pallas
kernels in interpret mode (short T and small delay lines, as
`tests/test_pallas_fx.py` does).  Tolerances: 1e-5 max-abs in float32 for
the recurrences (a few ulps of reordering in the lerp and allpass
arithmetic), 1e-5 for the phaser prologue (sin / tan / log of float32
arguments in two libraries).  The CUDA kernels themselves are compared with
the same plain versions on the card (`tests/test_torch_cuda_kernels.py`
and `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.data.datasets import default_fx
from mod_extraction_tpu.ops import fx as jfx
from mod_extraction_tpu.ops.pallas_fx import flanger_pallas, phaser_pallas
from mod_extraction_tpu.train.render import RenderConfig as JRenderConfig
from mod_extraction_tpu.train.render import render_batch as j_render_batch
from mod_extraction_tpu_torch.ops import fx as tfx
from mod_extraction_tpu_torch.ops import fx_kernels
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch

T = torch.as_tensor


def _flanger_inputs(rng, b, c, t, d, lo=0.5):
    x = rng.uniform(-0.5, 0.5, (b, c, t)).astype(np.float32)
    mod = rng.uniform(0, 1, (b, c, t)).astype(np.float32)
    delay = (mod * (d - 1 - lo - 0.5) + lo).astype(np.float32)
    fb = rng.uniform(0, 0.7, (b, 1, 1)).astype(np.float32)
    depth = rng.uniform(0.25, 1.0, (b, 1, 1)).astype(np.float32)
    mix = rng.uniform(0.25, 1.0, (b, 1, 1)).astype(np.float32)
    return x, delay, fb, depth, mix


@pytest.mark.parametrize(
    "b,c,t,d,lo",
    [(3, 2, 500, 37, 0.5), (4, 1, 600, 200, 60.0)],
    ids=["flanger-like", "chorus-like"],
)
def test_flanger_plain_matches_scan_and_pallas(rng, b, c, t, d, lo):
    args = _flanger_inputs(rng, b, c, t, d, lo)
    ref = np.asarray(jfx._flanger_scan(*map(jnp.asarray, args), d))
    pal = np.asarray(
        flanger_pallas(*map(jnp.asarray, args), d, t_chunk=128, interpret=True)
    )
    out = fx_kernels.flanger(*map(T, args), d).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, pal, atol=1e-5)


def test_flanger_cpu_uses_plain_version(rng):
    args = _flanger_inputs(rng, 2, 1, 200, 23)
    fx_kernels.reset_launch_counts()
    out = fx_kernels.flanger(*map(T, args), 23)
    np.testing.assert_array_equal(
        out.numpy(), fx_kernels.flanger_plain(*map(T, args), 23).numpy()
    )
    assert fx_kernels.LAUNCHES["flanger"] == 0


def test_phaser_plain_matches_scan_and_pallas(rng):
    b, c, t, n_stages = 2, 1, 700, 6
    x = rng.uniform(-0.5, 0.5, (b, c, t)).astype(np.float32)
    g = rng.uniform(0.01, 1.5, (b, c, t)).astype(np.float32)
    fb = rng.uniform(0, 0.7, (b, 1, 1)).astype(np.float32)
    mix = rng.uniform(0.2, 1.0, (b, 1, 1)).astype(np.float32)
    args = (x, g, fb, mix)
    ref = np.asarray(jfx._phaser_scan(*map(jnp.asarray, args), n_stages))
    pal = np.asarray(
        phaser_pallas(*map(jnp.asarray, args), n_stages=n_stages, t_chunk=256,
                      interpret=True)
    )
    out = fx_kernels.phaser(*map(T, args), n_stages).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, pal, atol=1e-5)


def test_apply_phaser_prologue_and_output(rng):
    """g sweep + GT mod signal (the prologue) and the clipped wet signal."""
    b, t, sr = 3, 1500, 44100.0
    x = rng.uniform(-0.8, 0.8, (b, 1, t)).astype(np.float32)
    rate = np.array([0.5, 1.7, 3.0], np.float32)
    depth = np.array([0.2, 0.6, 1.0], np.float32)
    centre = np.array([70.0, 1300.0, 18000.0], np.float32)
    fb = np.array([0.0, 0.35, 0.7], np.float32)
    mix = np.array([0.2, 0.5, 1.0], np.float32)
    phase = np.array([0.0, 2.0, 5.5], np.float32)
    wet_j, mod_j = jfx.apply_phaser(
        jnp.asarray(x), sr, jnp.asarray(rate), jnp.asarray(depth),
        jnp.asarray(centre), jnp.asarray(fb), jnp.asarray(mix),
        phase=jnp.asarray(phase),
    )
    wet_t, mod_t = tfx.apply_phaser(
        T(x), sr, T(rate), T(depth), T(centre), T(fb), T(mix), phase=T(phase)
    )
    np.testing.assert_allclose(mod_t.numpy(), np.asarray(mod_j), atol=1e-5)
    np.testing.assert_allclose(wet_t.numpy(), np.asarray(wet_j), atol=1e-5)

    # the prologue's g, rebuilt from the JAX formulas in float32
    g_t, _ = tfx.phaser_coefficients(t, sr, T(rate), T(depth), T(centre), T(phase))
    f_max = jfx.phaser_freq_max(sr)
    k4 = jnp.arange(-(-t // 4), dtype=jnp.float32) * 4.0
    arg = (2.0 * jnp.pi / sr) * jnp.asarray(rate)[:, None] * k4[None] + jnp.asarray(phase)[:, None]
    pos = jnp.clip(
        jfx.map_from_log10(jnp.asarray(centre), f_max=f_max)[:, None]
        + 0.5 * jnp.asarray(depth)[:, None] * -jnp.sin(arg), 0.0, 1.0,
    )
    g_j = jnp.repeat(jnp.tan(jnp.pi * jfx.map_to_log10(pos, f_max=f_max) / sr), 4, axis=1)[:, :t]
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5)


def test_apply_tremolo_matches(rng):
    x = rng.uniform(-1, 1, (2, 1, 64)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    mix = np.array([0.3, 0.9], np.float32)
    ref = jfx.apply_tremolo(jnp.asarray(x), jnp.asarray(m), jnp.asarray(mix))
    out = tfx.apply_tremolo(T(x), T(m), T(mix))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)


def _mixed_batch(rng, b, n, sr):
    """Rows: tremolo, flanger, chorus, phaser, none (cycled)."""
    fx = {k: np.zeros(b, np.float32) for k in default_fx()}
    eff = np.array([1, 2, 2, 3, 0] * b, np.int32)[:b]
    fx["effect_idx"] = eff
    fx["shape"] = np.zeros(b, np.int32)
    chorus = (np.arange(b) % 5) == 2
    fx["mix"] = rng.uniform(0.25, 1.0, b).astype(np.float32)
    fx["depth"] = rng.uniform(0.25, 1.0, b).astype(np.float32)
    fx["feedback"] = rng.uniform(0.0, 0.7, b).astype(np.float32)
    fx["width"] = rng.uniform(0.25, 1.0, b).astype(np.float32)
    fx["min_delay_width"] = np.where(chorus, 0.6, 0.3).astype(np.float32)
    fx["max_min_delay_ms"] = np.where(chorus, 30.0, 1.0).astype(np.float32)
    fx["max_lfo_delay_ms"] = np.full(b, 10.0, np.float32)
    fx["rate_hz"] = rng.uniform(0.5, 3.0, b).astype(np.float32)
    fx["phase"] = rng.uniform(0, 6.28, b).astype(np.float32)
    fx["centre_frequency_hz"] = rng.uniform(70.0, 3000.0, b).astype(np.float32)
    fx["exp"] = np.ones(b, np.float32)
    dry = rng.uniform(-0.5, 0.5, (b, 1, n)).astype(np.float32)
    mod = rng.uniform(0.05, 0.95, (b, n // 100)).astype(np.float32)
    return {"dry": dry, "mod_sig": mod, "fx": fx}


def _to_torch(batch):
    return {
        k: ({kk: T(vv) for kk, vv in v.items()} if isinstance(v, dict) else T(v))
        for k, v in batch.items()
    }


def test_render_batch_mixed_matches_jax(rng):
    sr, n, b = 8000.0, 3000, 5
    batch = _mixed_batch(rng, b, n, sr)
    d = int(30 / 1000 * sr + 0.5) + int(10 / 1000 * sr + 0.5)  # chorus line
    jcfg = JRenderConfig(sr=sr, n_samples=n, effects=(1, 2, 3), max_delay_samples=d)
    tcfg = RenderConfig(sr=sr, n_samples=n, effects=(1, 2, 3), max_delay_samples=d)
    dj, wj, mj, _ = j_render_batch(jax.tree.map(jnp.asarray, batch), jcfg)
    dt, wt, mt, _ = render_batch(_to_torch(batch), tcfg)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)


def test_render_batch_device_corpus_matches_jax(rng):
    """int16 corpus gather (dequant x gain) feeding the flanger."""
    sr, n, b = 8000.0, 1200, 3
    batch = _mixed_batch(rng, b, n, sr)
    batch["fx"]["effect_idx"] = np.full(b, 2, np.int32)
    del batch["dry"]
    corpus = rng.integers(-20000, 20000, 5000).astype(np.int16)
    batch["dry_idx"] = np.array([0, 1700, 3800], np.int32)
    batch["dry_gain"] = np.array([0.5, 1.0, 0.8], np.float32)
    cfg_kw = dict(sr=sr, n_samples=n, effects=(2,), max_delay_samples=88)
    dj, wj, _, _ = j_render_batch(
        jax.tree.map(jnp.asarray, batch), JRenderConfig(**cfg_kw), jnp.asarray(corpus)
    )
    dt, wt, _, _ = render_batch(_to_torch(batch), RenderConfig(**cfg_kw), T(corpus))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-7)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)

