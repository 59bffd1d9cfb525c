"""Corner ops of the port against the JAX package on the signals of
`tests/test_corners.py`: clean LFOs of every shape, offset LFOs, a busy
LFO past the corner budget, hand-built spacing cases and noisy smoothed
LFOs.

Tolerances: corner masks and validity masks exact; `stretch_corners` 1e-6
max-abs (float32, the same operations in the same order; only fused
multiply-adds may round differently); `smoothen` bit-exact, its gradient
1e-12 against autograd in float64."""

import functools

import jax
import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import corners as jc
from mod_extraction_tpu.ops.lfo import make_mod_signal_batch, shape_to_idx
from mod_extraction_tpu_torch.ops import corners as tc

# jitted once per shape: eager dispatch of the vmapped ops compiles each op
J_FIND_CORNERS = jax.jit(jc.find_corners)
J_VALID = jax.jit(jc.find_valid_mod_sig_mask)
J_STRETCH = jax.jit(jc.stretch_corners, static_argnums=(1, 2))
SHAPES = ["cos", "tri", "saw", "rsaw", "rect_cos", "inv_rect_cos", "sqr"]


def _lfo_batch(shapes, freq=2.0, phase=0.3, n=345, sr=172.5):
    b = len(shapes)
    return np.array(
        make_mod_signal_batch(
            n, sr, np.full((b,), freq, np.float32), np.full((b,), phase, np.float32),
            np.array([shape_to_idx(s) for s in shapes]),
        ),
        np.float32,
    )


def _spacing_case():
    m = np.full((345,), 0.1, np.float32)
    for c in (100, 110):
        m[c] = 0.9
    m[105] = 0.05
    m[200] = 0.02
    return m[None, :]


@functools.lru_cache(maxsize=1)
def _signals():
    rng = np.random.default_rng(0)
    noisy = np.clip(
        _lfo_batch(SHAPES[:6] * 4, freq=1.7, phase=0.9, n=256, sr=128.0)
        + 0.04 * rng.standard_normal((24, 256)).astype(np.float32), 0, 1,
    ).astype(np.float32)
    return {
        "clean": _lfo_batch(SHAPES),
        "offset": (0.25 + 0.5 * _lfo_batch(["cos", "tri", "saw"] * 2, freq=1.7, phase=1.1)).astype(np.float32),
        "busy": _lfo_batch(["cos"], freq=20.0, n=345, sr=1725.0),
        "valid_mix": np.concatenate(
            [_lfo_batch(["cos"], freq=1.5), _lfo_batch(["cos"], freq=30.0),
             np.full((1, 345), 0.5, np.float32), _spacing_case()], 0,
        ),
        "noisy": noisy,
        "noisy_smoothed": np.array(jc.smoothen(noisy, 8), np.float32),
    }


# (case, max_n_corners, smooth_n_frames) of each stretch comparison
CASES = [
    ("clean", 10, 0),
    ("offset", 10, 0),
    ("busy", 3, 0),
    ("valid_mix", 16, 8),
    ("noisy", 16, 8),
    ("noisy_smoothed", 10, 0),
]


@pytest.mark.parametrize("case,max_n_corners,smooth", CASES)
def test_corners_stretch_and_validity_match_jax(case, max_n_corners, smooth):
    m = _signals()[case]
    top_j, bot_j = (np.asarray(a) for a in J_FIND_CORNERS(m))
    top_t, bot_t = tc.find_corners(torch.from_numpy(m))
    np.testing.assert_array_equal(top_t.numpy(), top_j)
    np.testing.assert_array_equal(bot_t.numpy(), bot_j)
    np.testing.assert_array_equal(
        tc.find_valid_mod_sig_mask(torch.from_numpy(m)).numpy(),
        np.asarray(J_VALID(m)),
    )
    ref = np.asarray(J_STRETCH(m, max_n_corners, smooth))
    out = tc.stretch_corners(
        torch.from_numpy(m), max_n_corners=max_n_corners, smooth_n_frames=smooth
    ).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [7, 345, 88200])
def test_smoothen_is_bit_exact(n, rng):
    """The blocked cumulative sum reproduces XLA's summation order, so the
    smoothed LFO (and every corner found on it) is the JAX one exactly."""
    x = rng.uniform(0, 1, (3, n)).astype(np.float32)
    np.testing.assert_array_equal(tc.smoothen(torch.from_numpy(x), 8).numpy(),
                                  np.asarray(jc.smoothen(x, 8)))


def test_smoothen_gradient_matches_autograd(rng):
    """`smoothen`'s hand-written backward against autograd through an
    unfold-mean of the same window (float64, 1e-12 max-abs)."""
    x = torch.from_numpy(rng.standard_normal((3, 345))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 338)))
    (got,) = torch.autograd.grad(tc.smoothen(x, 8), x, g)
    (ref,) = torch.autograd.grad(x.unfold(-1, 8, 1).mean(-1), x, g)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_validity_expectations():
    """The JAX test's verdicts hold in the port: a slow LFO is valid, a
    fast one, a flat one and one with close tops are not."""
    m = _signals()["valid_mix"]
    assert tc.find_valid_mod_sig_mask(torch.from_numpy(m)).tolist() == [True, False, False, False]


def test_min_corner_spacing_matches_jax(rng):
    masks = (rng.uniform(size=(16, 120)) < 0.05).astype(np.int32)
    masks[0] = 0
    masks[1] = 0
    masks[1, 7] = 1
    ref = np.asarray(jax.jit(jax.vmap(jc._min_corner_spacing))(masks))
    out = tc._min_corner_spacing(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(out, ref)
