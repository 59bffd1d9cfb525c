"""The port's LFO synthesis (`ops/lfo.py`) and RandomLFO baseline
(`models/random_lfo.py`) against the JAX package on the CPU.

`make_mod_signal_batch` is deterministic: 1e-5 max-abs on a [0, 1] signal
(float32 phase arguments up to a few hundred radians, cos / mod in two
libraries), except within a few samples of a discontinuity of the saw,
reverse-saw and square shapes, where an argument that differs in its last
bit lands on the other side of the jump: those shapes are compared away
from the jumps and must agree on at least 99.5 % of the samples.

`make_rand_mod_signal` draws with a `torch.Generator`, whose numbers
threefry cannot give, so the test draws with JAX exactly as the JAX
function does (`jax.random.split(key, 3)`, then uniform / randint) and feeds
the port those draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.models.random_lfo import RandomLFO as JRandomLFO
from mod_extraction_tpu.ops import lfo as jlfo
from mod_extraction_tpu_torch.models.random_lfo import RandomLFO
from mod_extraction_tpu_torch.ops import lfo as tlfo

N, SR = 345, 172.5


def jax_lfo_draws(key, batch_size, n_shapes=len(jlfo.DEFAULT_RAND_SHAPES)):
    """The raw draws `make_rand_mod_signal` makes from `key`."""
    k_phase, k_freq, k_shape = jax.random.split(key, 3)
    return {
        "phase": np.asarray(jax.random.uniform(k_phase, (batch_size,), dtype=jnp.float32)),
        "freq": np.asarray(jax.random.uniform(k_freq, (batch_size,), dtype=jnp.float32)),
        "shape": np.asarray(jax.random.randint(k_shape, (batch_size,), 0, n_shapes)),
    }


def _close_off_the_jumps(got, want, jumpy):
    diff = np.abs(got - want)
    if jumpy:
        assert (diff <= 1e-5).mean() >= 0.995
        assert np.all((diff <= 1e-5) | (diff >= 0.5))  # a miss is a jump, nothing else
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_tables_match_jax():
    assert tlfo.LFO_SHAPES == jlfo.LFO_SHAPES
    assert tlfo.DEFAULT_RAND_SHAPES == jlfo.DEFAULT_RAND_SHAPES
    for s in jlfo.LFO_SHAPES:
        assert tlfo.shape_to_idx(s) == jlfo.shape_to_idx(s)
    assert tlfo.shape_to_idx(3) == 3


@pytest.mark.parametrize("shape", jlfo.LFO_SHAPES)
@pytest.mark.parametrize("exp", [1.0, 2.5])
def test_make_mod_signal_batch_matches_jax(rng, shape, exp):
    b = 6
    freq = rng.uniform(0.5, 3.0, b).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, b).astype(np.float32)
    idx = np.full(b, jlfo.shape_to_idx(shape), np.int32)
    want = np.asarray(jlfo.make_mod_signal_batch(N, SR, jnp.asarray(freq), jnp.asarray(phase), jnp.asarray(idx), exp))
    got = tlfo.make_mod_signal_batch(N, SR, torch.as_tensor(freq), torch.as_tensor(phase), torch.as_tensor(idx), exp)
    assert tuple(got.shape) == (b, N) and got.dtype == torch.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    _close_off_the_jumps(got.numpy(), want, shape in ("saw", "rsaw", "sqr"))


def test_mixed_shapes_and_per_example_exponent(rng):
    b = 7
    freq = rng.uniform(0.5, 3.0, b).astype(np.float32)
    phase = rng.uniform(-2 * np.pi, 2 * np.pi, b).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 0, 1, 3], np.int32)  # the continuous shapes
    exp = np.array([1.0, 0.5, 2.0, 1.0, 3.0, 1.0, 0.7], np.float32)
    want = np.asarray(jlfo.make_mod_signal_batch(N, SR, freq, phase, idx, jnp.asarray(exp)))
    got = tlfo.make_mod_signal_batch(N, SR, torch.as_tensor(freq), torch.as_tensor(phase), torch.as_tensor(idx), torch.as_tensor(exp))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one = tlfo.make_mod_signal(N, SR, float(freq[2]), float(phase[2]), "inv_rect_cos", 2.0)
    np.testing.assert_allclose(one.numpy(), want[2], atol=1e-5)
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jlfo.make_mod_signal(N, SR, float(freq[2]), float(phase[2]), "inv_rect_cos", 2.0)), atol=1e-5
    )


CONTINUOUS = ("cos", "tri", "rect_cos", "inv_rect_cos")


@pytest.mark.parametrize(
    "anchors",
    [dict(), dict(phase=True, phase_error=0.5), dict(freq=True, freq_error=0.25),
     dict(shape=True), dict(phase=True, freq=True, shape=True, phase_error=0.0, freq_error=0.0)],
    ids=["free", "phase_gt", "freq_gt", "shape_gt", "all_gt_exact"],
)
def test_make_rand_mod_signal_with_fed_draws(rng, anchors):
    b = 8
    key = jax.random.PRNGKey(11)
    phase_gt = rng.uniform(0, 2 * np.pi, b).astype(np.float32) if anchors.get("phase") else None
    freq_gt = rng.uniform(0.5, 3.0, b).astype(np.float32) if anchors.get("freq") else None
    shapes_gt = np.array([0, 1, 2, 3] * 2, np.int32) if anchors.get("shape") else None
    kw = dict(phase_error=anchors.get("phase_error", 0.5), freq_error=anchors.get("freq_error", 0.25))
    want = np.asarray(jlfo.make_rand_mod_signal(
        key, b, N, SR, 0.5, 3.0, shapes_gt=shapes_gt, shapes=CONTINUOUS,
        phase_gt=phase_gt, freq_gt=freq_gt, **kw,
    ))
    draws = jax_lfo_draws(key, b, len(CONTINUOUS))
    got = tlfo.make_rand_mod_signal(
        None, b, N, SR, 0.5, 3.0,
        shapes_gt=None if shapes_gt is None else torch.as_tensor(shapes_gt), shapes=CONTINUOUS,
        phase_gt=None if phase_gt is None else torch.as_tensor(phase_gt),
        freq_gt=None if freq_gt is None else torch.as_tensor(freq_gt), draws=draws, **kw,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_make_rand_mod_signal_from_a_generator():
    """Without fed draws: reproducible from the generator's seed, in range,
    frequencies inside [freq_min, freq_max] (a 0.5-3 Hz LFO over 2 s crosses
    its mean at most 2 * 3 * 2 + 1 times)."""
    a = tlfo.make_rand_mod_signal(torch.Generator().manual_seed(3), 16, N, SR, 0.5, 3.0)
    b = tlfo.make_rand_mod_signal(torch.Generator().manual_seed(3), 16, N, SR, 0.5, 3.0)
    c = tlfo.make_rand_mod_signal(torch.Generator().manual_seed(4), 16, N, SR, 0.5, 3.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tuple(a.shape) == (16, N) and a.min() >= 0 and a.max() <= 1
    cos_only = tlfo.make_rand_mod_signal(torch.Generator().manual_seed(5), 16, N, SR, 0.5, 3.0, shapes=("cos",))
    crossings = ((cos_only[:, 1:] - 0.5) * (cos_only[:, :-1] - 0.5) < 0).sum(dim=1)
    assert crossings.max() <= 13 and crossings.min() >= 1


@pytest.mark.parametrize("use_gt", [False, True])
def test_random_lfo_model_matches_jax(rng, use_gt):
    b = 6
    fx = {
        "shape": np.array([0, 3, 1, 2, 0, 3], np.int32),
        "phase": rng.uniform(0, 2 * np.pi, b).astype(np.float32),
        "rate_hz": rng.uniform(0.5, 3.0, b).astype(np.float32),
    }
    cfg = dict(n_samples=N, sr=SR, use_shape_gt=use_gt, use_phase_gt=use_gt, use_freq_gt=use_gt,
               shapes=CONTINUOUS, phase_error=0.25, freq_error=0.1)
    key = jax.random.PRNGKey(2)
    want = np.asarray(JRandomLFO(**cfg)(key, b, {k: jnp.asarray(v) for k, v in fx.items()}))
    got = RandomLFO(**cfg)(
        None, b, {k: torch.as_tensor(v) for k, v in fx.items()},
        draws=jax_lfo_draws(key, b, len(CONTINUOUS)),
    )
    assert tuple(got.shape) == want.shape == (b, 1, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
