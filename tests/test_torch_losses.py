"""The stage-2 losses of the port (esr, dc) and the weighted loss dict
holding them, against the JAX package on the CPU, with and without
per-example weights (zero weights included).  Tolerance: rtol 1e-5
(float32 reductions in another order; dc squares a mean error that is
small against the signal, so its last digits carry most of the rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu import losses as jl
from mod_extraction_tpu_torch.losses import losses as tl


def _data(rng):
    y = (0.5 * rng.standard_normal((5, 1, 900))).astype(np.float32)
    y_hat = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    return y_hat, y


@pytest.mark.parametrize("name", ["esr", "dc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_esr_dc_match_jax(name, weighted, rng):
    y_hat, y = _data(rng)
    w = np.array([1, 0, 1, 1, 0], np.float32) if weighted else None
    ref = getattr(jl, f"{name}_loss")(jnp.asarray(y_hat), jnp.asarray(y),
                                      None if w is None else jnp.asarray(w))
    out = tl._LOSS_REGISTRY[name](torch.from_numpy(y_hat), torch.from_numpy(y),
                                  None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_stage2_loss_dict_matches_jax(rng):
    y_hat, y = _data(rng)
    w = np.array([1, 1, 0, 1, 0], np.float32)
    cfg = {"l1": 1.0, "esr": 0.0, "dc": 0.0}
    _, mj = jl.WeightedLossDict(cfg)(jnp.asarray(y_hat), jnp.asarray(y), jnp.asarray(w))
    _, mt = tl.WeightedLossDict(cfg)(torch.from_numpy(y_hat), torch.from_numpy(y), torch.from_numpy(w))
    assert set(mt) == set(mj) == {"l1", "esr", "dc", "loss"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)


# --- the spectral losses ---------------------------------------------------
# rtol 1e-4: two FFT libraries in float32 under a log (log_mel_l1) or a
# norm ratio plus a log (mrstft).


def _audio(rng, b=3, t=6000):
    y = (0.3 * rng.standard_normal((b, 1, t))).astype(np.float32)
    y_hat = (y + 0.05 * rng.standard_normal(y.shape)).astype(np.float32)
    return y_hat, y


@pytest.mark.parametrize("weighted", [False, True])
def test_log_mel_l1_matches_jax(rng, weighted):
    y_hat, y = _audio(rng)
    w = np.array([1, 0, 1], np.float32) if weighted else None
    ref = jl.log_mel_l1_loss(jnp.asarray(y_hat), jnp.asarray(y), None if w is None else jnp.asarray(w))
    out = tl.log_mel_l1_loss(torch.from_numpy(y_hat), torch.from_numpy(y),
                             None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


def test_mrstft_matches_jax(rng):
    y_hat, y = _audio(rng)
    ref = jl.mr_stft_loss(jnp.asarray(y_hat), jnp.asarray(y))
    out = tl.mr_stft_loss(torch.from_numpy(y_hat), torch.from_numpy(y))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)
    assert float(out) > 0
    # a single resolution's magnitudes, frame for frame (1e-4 of the peak)
    from mod_extraction_tpu.losses.losses import _stft_mag as j_stft_mag

    mj = np.asarray(j_stft_mag(jnp.asarray(y[:, 0]), 512, 50, 240))
    mt = tl._stft_mag(torch.from_numpy(y[:, 0]), 512, 50, 240).numpy()
    assert mt.shape == mj.shape
    np.testing.assert_allclose(mt, mj, atol=1e-4 * mj.max())


def test_spectral_losses_in_the_loss_dict(rng):
    y_hat, y = _audio(rng)
    cfg = {"l1": 1.0, "mrstft": 0.5, "log_mel_l1": 0.0}
    lj, mj = jl.WeightedLossDict(cfg)(jnp.asarray(y_hat), jnp.asarray(y))
    lt, mt = tl.WeightedLossDict(cfg)(torch.from_numpy(y_hat), torch.from_numpy(y))
    assert set(mt) == set(mj) == {"l1", "mrstft", "log_mel_l1", "loss"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    with pytest.raises(KeyError):
        tl.WeightedLossDict({"stft": 1.0})
