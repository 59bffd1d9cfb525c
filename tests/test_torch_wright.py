"""The leftover functions of the port against the JAX package on the CPU:
the Wright losses (`losses/wright.py`), `get_loss_func_by_name` (every
name, and the `KeyError`), `utils/interp.py::linear_resample`,
`ops/corners.py::corners_to_mod_sig` (empty masks too) and
`ops/stft.py::spectrogram` at powers 1, 2 and 0.5 (and
`log_mel_spectrogram`).

Tolerances: the Wright losses 1e-6 relative, the registry's 1e-5 (float32,
a reduction or a spectrogram each); the FIR outputs, the resampling and the
rebuilt LFO 1e-6 max-abs; the spectrograms 1e-5 relative to their largest
value (two FFT libraries), the log-mel 1e-4 max-abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.losses import losses as jlosses
from mod_extraction_tpu.losses import wright as jwright
from mod_extraction_tpu.ops import corners as jcorners
from mod_extraction_tpu.ops import stft as jstft
from mod_extraction_tpu.utils import interp as jinterp
from mod_extraction_tpu_torch.losses import losses as tlosses
from mod_extraction_tpu_torch.losses import wright as twright
from mod_extraction_tpu_torch.ops import corners as tcorners
from mod_extraction_tpu_torch.ops import stft as tstft
from mod_extraction_tpu_torch.utils import interp as tinterp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def pair(rng):
    """(output, target): (T, B, 1) signals, the layout of Wright's code."""
    tgt = rng.standard_normal((300, 3, 1)).astype(np.float32)
    out = (tgt + 0.3 * rng.standard_normal((300, 3, 1)) + 0.05).astype(np.float32)
    return out, tgt


@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("name", ["wright_esr_loss", "wright_dc_loss"])
def test_wright_losses_match_jax(name, eps, pair):
    out, tgt = pair
    got = getattr(twright, name)(_t(out), _t(tgt), eps)
    want = getattr(jwright, name)(jnp.asarray(out), jnp.asarray(tgt), eps)
    _close(got, want)


@pytest.mark.parametrize("low_pass", [False, True], ids=["pre_emph", "pre_emph_low_pass"])
def test_wright_pre_emph_matches_jax(low_pass, pair):
    out, tgt = pair
    got = twright.wright_pre_emph(_t(out), _t(tgt), [-0.95, 1.0], low_pass)
    want = jwright.wright_pre_emph(jnp.asarray(out), jnp.asarray(tgt), [-0.95, 1.0], low_pass)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, rtol=0, atol=1e-6)
    if not low_pass:  # the FIR is not flipped: y[t] = c0 x[t - 1] + c1 x[t]
        _close(got[0][1:], -0.95 * out[:-1] + out[1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(jlosses._LOSS_REGISTRY))
def test_get_loss_func_by_name_matches_jax(name, rng):
    y = rng.uniform(-0.9, 0.9, (2, 1, 4096)).astype(np.float32)
    y_hat = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    fn = tlosses.get_loss_func_by_name(name)
    assert fn is tlosses._LOSS_REGISTRY[name]
    _close(fn(_t(y_hat), _t(y)), jlosses.get_loss_func_by_name(name)(jnp.asarray(y_hat), jnp.asarray(y)),
           rtol=1e-5)


def test_get_loss_func_by_name_unknown():
    for get in (tlosses.get_loss_func_by_name, jlosses.get_loss_func_by_name):
        with pytest.raises(KeyError, match="Unknown loss: wright_esr"):
            get("wright_esr")


@pytest.mark.parametrize("n_in,n_out", [(345, 88200), (88, 2000), (100, 37), (5, 1), (9, 9)])
def test_linear_resample_matches_jax(n_in, n_out, rng):
    x = rng.standard_normal((2, 3, n_in)).astype(np.float32)
    got = tinterp.linear_resample(_t(x), n_out)
    want = jinterp.linear_resample(jnp.asarray(x), n_out)
    assert got.shape == want.shape
    _close(got, want, rtol=0, atol=1e-6)


def _masks(rng, t, n_top, n_bot):
    top, bot = np.zeros(t, np.int32), np.zeros(t, np.int32)
    idx = rng.choice(np.arange(1, t - 1), n_top + n_bot, replace=False)
    top[idx[:n_top]], bot[idx[n_top:]] = 1, 1
    return top, bot


@pytest.mark.parametrize("n_top,n_bot", [(3, 3), (1, 4), (5, 1), (0, 3), (2, 0), (0, 0)])
def test_corners_to_mod_sig_matches_jax(n_top, n_bot, rng):
    top, bot = _masks(rng, 200, n_top, n_bot)
    got = tcorners.corners_to_mod_sig(_t(top), _t(bot))
    want = jcorners.corners_to_mod_sig(jnp.asarray(top), jnp.asarray(bot))
    _close(got, want, rtol=0, atol=1e-6)
    if n_top == 0 or n_bot == 0:
        assert not got.any()


@pytest.mark.parametrize("power", [2.0, 1.0, 0.5])
def test_spectrogram_matches_jax(power, rng):
    x = rng.uniform(-0.9, 0.9, (2, 2, 3001)).astype(np.float32)
    got = tstft.spectrogram(_t(x), 256, 64, power)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), 256, 64, power, impl="rfft"))
    assert got.shape == want.shape == (2, 2, 129, 3001 // 64 + 1)
    _close(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_log_mel_spectrogram_matches_jax(rng):
    x = rng.uniform(-0.9, 0.9, (2, 1, 4000)).astype(np.float32)
    got = tstft.log_mel_spectrogram(_t(x), 8000, 256, 64, 32)
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x), 8000, 256, 64, 32, impl="rfft"))
    _close(got, want, rtol=0, atol=1e-4)
