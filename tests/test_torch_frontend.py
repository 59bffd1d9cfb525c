"""The port's Mel frontend, SpecAugment, interpolation, smoothing and
losses against the JAX package on the CPU.

Tolerances: mel power relative 1e-4 of each example's peak (two FFT
libraries in float32); SpecAugment fed the numbers JAX drew must give the
identical mask (exact); interpolation and smoothing 1e-6; losses rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.losses import losses as jl
from mod_extraction_tpu.ops.corners import smoothen as j_smoothen
from mod_extraction_tpu.ops.stft import mel_filterbank as j_mel_filterbank
from mod_extraction_tpu.ops.stft import mel_spectrogram as j_mel
from mod_extraction_tpu.ops.stft import spec_augment as j_spec_augment
from mod_extraction_tpu.utils.interp import linear_interpolate_last_dim as j_interp
from mod_extraction_tpu_torch.losses import losses as tl
from mod_extraction_tpu_torch.ops.corners import smoothen
from mod_extraction_tpu_torch.ops.stft import mel_filterbank, mel_spectrogram, spec_augment
from mod_extraction_tpu_torch.utils.interp import linear_interpolate_last_dim


def jax_mask_draws(key):
    """The four uniforms `ops/stft.py::spec_augment` draws from `key`."""
    return [float(jax.random.uniform(k)) for k in jax.random.split(key, 4)]


@pytest.mark.parametrize("n_mels", [64, 256])
def test_mel_spectrogram_matches_rfft_path(rng, n_mels):
    x = rng.uniform(-0.8, 0.8, (2, 2, 6000)).astype(np.float32)
    ref = np.asarray(j_mel(jnp.asarray(x), 44100, 1024, 256, n_mels, impl="rfft"))
    out = mel_spectrogram(torch.as_tensor(x), 44100, 1024, 256, n_mels).numpy()
    assert out.shape == ref.shape == (2, 2, n_mels, 6000 // 256 + 1)
    scale = ref.max(axis=(2, 3), keepdims=True)
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-4)
    np.testing.assert_array_equal(
        mel_filterbank(44100, 1024, n_mels), j_mel_filterbank(44100, 1024, n_mels)
    )


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_spec_augment_same_draws_same_mask(rng, seed):
    spec = rng.uniform(0.1, 1.0, (2, 2, 64, 40)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(j_spec_augment(key, jnp.asarray(spec), 16, 10))
    out = spec_augment(torch.as_tensor(spec), 16, 10, jax_mask_draws(key)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_in,n_out", [(882, 88200), (345, 882), (882, 345)])
def test_linear_interpolate_matches(rng, n_in, n_out):
    x = rng.uniform(0, 1, (3, n_in)).astype(np.float32)
    ref = np.asarray(j_interp(jnp.asarray(x), n_out))
    out = linear_interpolate_last_dim(torch.as_tensor(x), n_out).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_smoothen_matches(rng):
    x = rng.uniform(0, 1, (3, 100)).astype(np.float32)
    ref = np.asarray(j_smoothen(jnp.asarray(x), 4))
    out = smoothen(torch.as_tensor(x), 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_weighted_losses_match(rng):
    y_hat = rng.uniform(0, 1, (4, 50)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 50)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0, 0.5], np.float32)
    loss_dict = {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0}
    for weights in (None, w):
        lj, mj = jl.WeightedLossDict(loss_dict)(
            jnp.asarray(y_hat), jnp.asarray(y), None if weights is None else jnp.asarray(weights)
        )
        lt, mt = tl.WeightedLossDict(loss_dict)(
            torch.as_tensor(y_hat), torch.as_tensor(y),
            None if weights is None else torch.as_tensor(weights),
        )
        assert set(mt) == set(mj) == {"l1", "fdl1", "sdl1", "mse", "loss"}
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)


# --- the matrix-product DFT frontends --------------------------------------
# "dft" is two float32 products (TF32 off): relative 1e-4 of each example's
# peak against the JAX "dft" path and against the port's own rfft path.
# "dft_bf16" rounds the windowed frames and the basis to bf16 (8 bits of
# mantissa): relative 2e-2 against the JAX "dft_bf16" path, and the same
# against the exact spectrum.


@pytest.mark.parametrize("impl,tol", [("dft", 1e-4), ("dft_bf16", 2e-2)])
def test_dft_frontends_match_jax(rng, impl, tol):
    x = rng.uniform(-0.8, 0.8, (2, 2, 6000)).astype(np.float32)
    ref = np.asarray(j_mel(jnp.asarray(x), 44100, 1024, 256, 64, impl=impl))
    out = mel_spectrogram(torch.as_tensor(x), 44100, 1024, 256, 64, impl=impl).numpy()
    exact = mel_spectrogram(torch.as_tensor(x), 44100, 1024, 256, 64, impl="rfft").numpy()
    assert out.shape == ref.shape
    scale = ref.max(axis=(2, 3), keepdims=True)
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol)
    np.testing.assert_allclose(out / scale, exact / scale, atol=tol)


def test_auto_frontend_is_rfft_and_unknown_is_refused(rng):
    x = torch.as_tensor(rng.uniform(-0.8, 0.8, (1, 1, 3000)).astype(np.float32))
    assert torch.equal(mel_spectrogram(x, impl="auto"), mel_spectrogram(x, impl="rfft"))
    assert torch.equal(mel_spectrogram(x), mel_spectrogram(x, impl="rfft"))
    with pytest.raises(ValueError):
        mel_spectrogram(x, impl="stft")
