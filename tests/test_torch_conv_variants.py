"""The port's conv variants (`ops/conv.py`: the frequency-folded and row-pair
forms of the trunk conv, and the two explicit framings of its weight
gradient) against the JAX package's functions on the CPU, float32.

The same numpy inputs go through both; the port's tensors are NCHW / OIHW,
the JAX ones NHWC / HWIO, so the test permutes at the boundary.

Tolerances: forward variants 2e-5 max-abs (the JAX package's own bound for
them: the same products summed in another order); weight gradients 1e-5 of
the largest |dW| (same reason); fold/unfold are pure permutations and must
round-trip exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import conv as jconv
from mod_extraction_tpu.ops.pallas_conv import conv2d_wgrad_reference as j_wgrad_reference
from mod_extraction_tpu.ops.pallas_conv import pair_supported as j_pair_supported
from mod_extraction_tpu.ops.pallas_conv import wgrad_supported as j_wgrad_supported
from mod_extraction_tpu_torch.ops import conv as tconv
from mod_extraction_tpu_torch.ops import conv_kernels as ck


def nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def oihw(w):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


def _conv_inputs(rng):
    x = rng.standard_normal((3, 16, 50, 8)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 13, 8, 12))).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("t_dil", [1, 2, 8])
@pytest.mark.parametrize("variant", ["conv2d_pair_rows", "conv2d_freq_folded"])
def test_forward_variant_matches_jax(rng, variant, t_dil):
    x, w, b = _conv_inputs(rng)
    want = np.asarray(getattr(jconv, variant)(jnp.asarray(x), jnp.asarray(w), 1, t_dil)) + b
    got = getattr(tconv, variant)(nchw(x), oihw(w), torch.as_tensor(b), 1, t_dil)
    np.testing.assert_allclose(nhwc(got), want, atol=2e-5)
    # and the plain conv, the thing both are forms of
    plain = tconv.conv2d_same(nchw(x), oihw(w), torch.as_tensor(b), 1, t_dil)
    np.testing.assert_allclose(nhwc(got), nhwc(plain), atol=2e-5)


def test_forward_variants_without_bias_and_even_kt(rng):
    """The pair form with an even time kernel (asymmetric 'same' padding)
    and no bias, against the JAX function."""
    x = rng.standard_normal((2, 8, 21, 4)).astype(np.float32)
    w = (0.1 * rng.standard_normal((5, 6, 4, 3))).astype(np.float32)
    for t_dil in (1, 3):
        want = np.asarray(jconv.conv2d_pair_rows(jnp.asarray(x), jnp.asarray(w), 1, t_dil))
        got = tconv.conv2d_pair_rows(nchw(x), oihw(w), None, 1, t_dil)
        np.testing.assert_allclose(nhwc(got), want, atol=2e-5)


def test_fold_unfold_and_weight_layouts_match_jax(rng):
    x = rng.standard_normal((2, 8, 10, 4)).astype(np.float32)
    xt = nchw(x)
    folded = tconv.fold_freq(xt)
    np.testing.assert_array_equal(nhwc(folded), np.asarray(jconv.fold_freq(jnp.asarray(x))))
    assert torch.equal(tconv.unfold_freq(folded), xt)
    w = rng.standard_normal((5, 13, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        hwio(tconv.fold_weights(oihw(w))), np.asarray(jconv.fold_weights(jnp.asarray(w)))
    )
    np.testing.assert_array_equal(
        hwio(tconv.pair_weights(oihw(w))), np.asarray(jconv.pair_weights(jnp.asarray(w)))
    )


@pytest.mark.parametrize("dil", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("form", ["conv2d_wgrad_convform", "conv2d_wgrad_s2b"])
def test_wgrad_framing_matches_jax(form, dil):
    rng = np.random.default_rng(100 + dil)
    b, f, t, ci, co = 2, 8, 57, 5, 7  # T deliberately not a dilation multiple
    x = (0.3 * rng.standard_normal((b, f, t, ci))).astype(np.float32)
    dy = (0.3 * rng.standard_normal((b, f, t, co))).astype(np.float32)
    want = np.asarray(getattr(jconv, form)(jnp.asarray(x), jnp.asarray(dy), 5, 13, dil))
    ref = np.asarray(j_wgrad_reference(jnp.asarray(x), jnp.asarray(dy), dil=dil))
    got = getattr(tconv, form)(nchw(x), nchw(dy), 5, 13, dil)
    assert tuple(got.shape) == (co, ci, 5, 13) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(hwio(got), want, atol=1e-5 * scale)
    np.testing.assert_allclose(hwio(got), ref, atol=1e-5 * scale)


@pytest.mark.parametrize(
    "hwio_shape,bin_dil,f,ci",
    [
        ((5, 13, 64, 64), 1, 256, 64),
        ((5, 13, 64, 64), 2, 256, 64),  # bin dilation
        ((3, 13, 64, 64), 1, 256, 64),  # kernel != 5
        ((5, 13, 64, 64), 1, 85, 64),  # odd freq dim
        ((5, 13, 2, 64), 1, 256, 2),  # layer 0: two input channels
        ((5, 12, 8, 64), 1, 128, 8),  # even time kernel
        ((5, 13, 12, 64), 1, 128, 12),  # channels not a multiple of 8
    ],
)
def test_guards_match_jax(hwio_shape, bin_dil, f, ci):
    kf, kt, i, o = hwio_shape
    oihw_shape = (o, i, kf, kt)
    assert tconv.foldable(oihw_shape, bin_dil, f) == jconv.foldable(hwio_shape, bin_dil, f)
    assert ck.pair_supported(oihw_shape, bin_dil, f) == j_pair_supported(hwio_shape, bin_dil, f)
    assert ck.wgrad_supported(oihw_shape, bin_dil, ci) == j_wgrad_supported(hwio_shape, bin_dil, ci)


def test_guard_values():
    assert tconv.foldable((64, 64, 5, 13), 1, 256)
    assert not tconv.foldable((64, 64, 5, 13), 1, 85)
    assert ck.wgrad_supported((64, 64, 5, 13), 1, 64)
    assert not ck.wgrad_supported((64, 2, 5, 13), 1, 2)
    assert not ck.pair_supported((64, 64, 3, 13), 1, 256)
