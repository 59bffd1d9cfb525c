"""The port's TCN family (`mod_extraction_tpu_torch/models/tcn.py`) against
the JAX package's (`mod_extraction_tpu/models/tcn.py`) on the CPU.  The
port's seeded weights are carried to JAX by `models/convert.py::
tcn_state_dict_to_flax` (a flax init on the CPU takes seconds a module),
and the flax -> port direction is held bit for bit by the round trip.

Cases: TCNBlock and TCN causal and non-causal, stride 1 and 2 at odd T
(explicit padding 0, so the residual's centre and causal crops both cut),
with and without LayerNorm; FiLM with its batch norm in train mode (the
running statistics it leaves, flax's biased variance at momentum 0.99) and
then in eval mode; SpectralTCN and SpectralDSTCN (latent and output); the
cached causal TCN streamed in uneven chunks against one call of itself and
against JAX's cached call; `calc_receptive_field`; the convert round trip
flax -> port -> flax bit for bit.

Tolerance: 1e-5 max-abs on every output and running statistic (float32,
other conv sum orders); the spectral models' log-spectrogram inputs reach
|x| ~ 16, so their outputs are held at 1e-5 relative to their largest
magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.models import tcn as jtcn
from mod_extraction_tpu_torch.models import tcn as ttcn
from mod_extraction_tpu_torch.models.convert import tcn_flax_to_state_dict, tcn_state_dict_to_flax

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(module):
    """The flax variables holding `module`'s weights (and BN statistics)."""
    return jax.tree.map(jnp.asarray, tcn_state_dict_to_flax(module.state_dict()))


def _close(got: torch.Tensor, want, tol=TOL, rel=False):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0) if rel else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * scale)


BLOCK_CASES = {
    "causal_s1": dict(is_causal=True, stride=1, use_ln=False),
    "causal_s2_ln": dict(is_causal=True, stride=2, use_ln=True),
    "noncausal_pad0_s2": dict(is_causal=False, stride=2, padding=0, use_ln=False),
    "noncausal_same_s1_ln": dict(is_causal=False, stride=1, padding=None, use_ln=True),
    "noncausal_same_s2": dict(is_causal=False, stride=2, padding=None, use_ln=True),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_tcn_block_matches_jax(case, rng):
    kw = BLOCK_CASES[case]
    x = rng.standard_normal((2, 3, 41)).astype(np.float32)
    jb = jtcn.TCNBlock(3, 5, kernel_size=5, dilation=2, **kw)
    tb = ttcn.TCNBlock(3, 5, kernel_size=5, dilation=2, **kw)
    want = jb.apply(_variables(tb), jnp.asarray(x))
    got = tb(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("is_causal", [True, False], ids=["causal", "noncausal"])
def test_tcn_stack_matches_jax(is_causal, rng):
    kw = dict(dilations=(1, 2, 4), in_ch=4, kernel_size=3, strides=(1, 2, 1), use_ln=True,
              is_causal=is_causal, padding=0 if is_causal else None)
    x = rng.standard_normal((2, 4, 63)).astype(np.float32)
    tm = ttcn.TCN((6, 6, 5), **kw)
    _close(tm(torch.from_numpy(x)), jtcn.TCN((6, 6, 5), **kw).apply(_variables(tm), jnp.asarray(x)))


def test_film_batch_norm_train_then_eval(rng):
    """One train call (batch statistics, running statistics updated as
    flax's) and then one eval call (running statistics) against JAX."""
    kw = dict(dilations=(1, 2), in_ch=3, kernel_size=3, cond_dim=2, use_film_bn=True, use_ln=True)
    x = rng.standard_normal((3, 3, 37)).astype(np.float32)
    x2 = rng.standard_normal((3, 3, 37)).astype(np.float32)
    cond = rng.standard_normal((3, 2)).astype(np.float32)
    jm, tm = jtcn.TCN((4, 4), **kw), ttcn.TCN((4, 4), **kw)
    variables = _variables(tm)
    assert "batch_stats" in variables
    want, mutated = jm.apply(variables, jnp.asarray(x), jnp.asarray(cond), train=True,
                             mutable=["batch_stats"])
    tm.train()
    _close(tm(torch.from_numpy(x), torch.from_numpy(cond)), want)
    stats = tcn_flax_to_state_dict({"batch_stats": _np(mutated["batch_stats"])})
    for k, v in stats.items():
        _close(tm.state_dict()[k], v.numpy())
    assert any(not np.allclose(v.numpy(), 1.0) for k, v in stats.items() if k.endswith("running_var"))
    tm.eval()
    want_eval = jm.apply({"params": variables["params"], **mutated}, jnp.asarray(x2), jnp.asarray(cond))
    _close(tm(torch.from_numpy(x2), torch.from_numpy(cond)), want_eval)


SPECTRAL = dict(n_samples=2000, n_fft=128, hop_len=32, kernel_size=5, out_channels=(8, 8, 6),
                dilations=(1, 2, 4))


def test_spectral_tcn_matches_jax(rng):
    x = rng.uniform(-0.8, 0.8, (2, 2, 2000)).astype(np.float32)
    tm = ttcn.SpectralTCN(latent_dim=2, seed=4, **SPECTRAL)
    mod_j, lat_j = jtcn.SpectralTCN(latent_dim=2, **SPECTRAL).apply(_variables(tm), jnp.asarray(x))
    mod_t, lat_t = tm(torch.from_numpy(x), mask_draws=[0.5] * 4)
    assert mod_t.shape == mod_j.shape == (2, 2, 2000 // 32 + 1)
    _close(mod_t, mod_j, rel=True)
    _close(lat_t, lat_j, rel=True)


def test_spectral_tcn_reads_only_channel_0(rng):
    """Both packages take `spectrogram(x)[:, 0]`: under `use_dry`
    (cat(dry, wet)) the extractor sees only the dry signal, and a change of
    the wet channel changes neither output."""
    x = rng.uniform(-0.8, 0.8, (1, 2, 2000)).astype(np.float32)
    y = x.copy()
    y[:, 1] = rng.uniform(-0.8, 0.8, 2000)
    jm, tm = jtcn.SpectralTCN(**SPECTRAL), ttcn.SpectralTCN(**SPECTRAL)
    variables = _variables(tm)
    np.testing.assert_array_equal(np.asarray(jm.apply(variables, jnp.asarray(x))[0]),
                                  np.asarray(jm.apply(variables, jnp.asarray(y))[0]))
    assert torch.equal(tm(torch.from_numpy(x))[0], tm(torch.from_numpy(y))[0])


def test_spectral_dstcn_matches_jax(rng):
    x = rng.uniform(-0.8, 0.8, (3, 1, 2001)).astype(np.float32)
    kw = dict(SPECTRAL, n_samples=2001, strides=(2, 2, 2), n_fc_units=7, latent_dim=2)
    tm = ttcn.SpectralDSTCN(seed=5, **kw)
    want = jtcn.SpectralDSTCN(**kw).apply(_variables(tm), jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 2)
    _close(got, want)


def test_cached_tcn_streams_in_uneven_chunks(rng):
    """The cached causal TCN over uneven chunks equals one call of itself,
    and each chunk JAX's cached call on the same chunk and carried state."""
    kw = dict(dilations=(1, 2, 4), in_ch=2, kernel_size=3, is_causal=True, is_cached=True)
    x = rng.standard_normal((2, 2, 90)).astype(np.float32)
    jm, tm = jtcn.TCN((4, 4, 3), **kw), ttcn.TCN((4, 4, 3), **kw)
    variables = _variables(tm)
    full, _ = tm(torch.from_numpy(x))
    state_t = state_j = None
    outs, start = [], 0
    for n in (1, 37, 52):
        xc = x[:, :, start : start + n]
        y_t, state_t = tm(torch.from_numpy(xc), stream_state=state_t)
        y_j, state_j = jm.apply(variables, jnp.asarray(xc), stream_state=state_j)
        _close(y_t, y_j)
        for st, sj in zip(state_t, state_j):  # (B, C, n) here, (B, n, C) in JAX
            _close(st, np.swapaxes(np.asarray(sj), 1, 2))
        outs.append(y_t)
        start += n
    assert start == x.shape[-1]
    torch.testing.assert_close(torch.cat(outs, -1), full, rtol=0, atol=TOL)


@pytest.mark.parametrize("ks,dils", [(13, (1, 2, 4, 8, 16)), (3, (1, 4, 16))])
def test_receptive_field_matches_jax(ks, dils):
    chans = (4,) * len(dils)
    assert ttcn.TCN(chans, dils, kernel_size=ks).calc_receptive_field() == \
        jtcn.TCN(chans, dils, kernel_size=ks).calc_receptive_field()
    assert ttcn.TCN((4, 4, 4), kernel_size=3).calc_receptive_field() == 1 + 2 * (1 + 4 + 16)


@pytest.mark.parametrize("which", ["tcn_film", "spectral_tcn", "spectral_dstcn"])
def test_convert_round_trip_bit_for_bit(which, rng):
    if which == "tcn_film":
        jm = jtcn.TCN((4, 3), (1, 2), in_ch=2, kernel_size=3, cond_dim=2, use_film_bn=True)
        args = (jnp.zeros((2, 2, 20)), jnp.zeros((2, 2)))
    elif which == "spectral_tcn":
        jm, args = jtcn.SpectralTCN(**SPECTRAL), (jnp.zeros((1, 1, 2000)),)
    else:
        jm, args = jtcn.SpectralDSTCN(**SPECTRAL), (jnp.zeros((1, 1, 2000)),)
    # the shapes of a flax init, filled with random numbers
    variables = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32),
                             jax.eval_shape(jm.init, jax.random.PRNGKey(7), *args))
    back = tcn_state_dict_to_flax(tcn_flax_to_state_dict(variables))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype and np.array_equal(flat_a[k], flat_b[k]), k
