"""The port's Spectral2DCNN, holding the shipped r7 extractor weights
through `models/convert.py`, against the JAX module on the CPU.

A short clip (4410 samples, 64 mels: the conv weights depend on neither)
keeps the JAX compile small.  Tolerances: float32 compute 1e-4 max-abs on
the sigmoid output and 1e-3 relative on the latent (conv sums reordered
over six layers); bf16 convs 2e-2 on the output (both frameworks round the
conv inputs and outputs to bf16, at slightly different places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.models import Spectral2DCNN as JSpectral2DCNN
from mod_extraction_tpu.models.common import max_pool_floor as j_max_pool_floor
from mod_extraction_tpu.ops.conv import conv2d_same as j_conv2d_same
from mod_extraction_tpu.train.checkpoints import load_weights
from mod_extraction_tpu_torch.models.common import max_pool_floor
from mod_extraction_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_spectral_2dcnn,
)
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.ops.conv import conv2d_same

R7 = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
PAPER = dict(
    in_ch=2, n_samples=4410, sr=44100, n_fft=1024, hop_len=256, n_mels=64,
    kernel_size=(5, 13), out_channels=(64,) * 6,
    temp_dilations=(1, 1, 2, 4, 8, 16), pool_size=(2, 1),
    freq_mask_amount=0.25, time_mask_amount=0.25,
)


def _audio(rng, b=2):
    return rng.uniform(-0.6, 0.6, (b, 2, PAPER["n_samples"])).astype(np.float32)


@pytest.mark.parametrize(
    "dtype,out_tol", [("float32", 1e-4), ("bfloat16", 2e-2)]
)
def test_r7_weights_forward_matches_jax(rng, dtype, out_tol):
    x = _audio(rng)
    params = {"params": load_weights(R7)}
    j_model = JSpectral2DCNN(**PAPER, compute_dtype=dtype)
    out_j, lat_j = j_model.apply(params, jnp.asarray(x))
    t_model = load_spectral_2dcnn(R7, device="cpu", **PAPER, compute_dtype=dtype)
    with torch.no_grad():
        out_t, lat_t = t_model(torch.as_tensor(x))
    assert tuple(out_t.shape) == out_j.shape == (2, 1, 4410 // 256 + 1)
    assert tuple(lat_t.shape) == lat_j.shape == (2, 64, 4410 // 256 + 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=out_tol)
    if dtype == "float32":
        lat_j = np.asarray(lat_j)
        np.testing.assert_allclose(
            lat_t.numpy(), lat_j, atol=1e-3 * np.abs(lat_j).max()
        )


def test_features_bypass_matches_jax(rng):
    feats = rng.uniform(1e-4, 2.0, (2, 2, 32, 20)).astype(np.float32)
    x = np.zeros((2, 2, 100), np.float32)
    params = {"params": load_weights(R7)}
    j_model = JSpectral2DCNN(**PAPER)
    out_j, _ = j_model.apply(params, jnp.asarray(x), features=jnp.asarray(feats))
    t_model = load_spectral_2dcnn(R7, device="cpu", **PAPER)
    with torch.no_grad():
        out_t, _ = t_model(torch.as_tensor(x), features=torch.as_tensor(feats))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)


def test_converter_accepts_a_live_flax_tree():
    """A nested (params-rooted) flax tree converts like the npz."""
    tree = {"params": jax.tree.map(np.asarray, load_weights(R7))}
    sd_tree = flax_to_state_dict(tree)
    sd_npz = flax_to_state_dict(R7)
    assert sd_tree.keys() == sd_npz.keys() == Spectral2DCNN(**PAPER).state_dict().keys()
    for k in sd_npz:
        torch.testing.assert_close(sd_tree[k], sd_npz[k], rtol=0, atol=0)
    assert tuple(sd_npz["convs.1.weight"].shape) == (64, 64, 5, 13)
    assert tuple(sd_npz["out.weight"].shape) == (1, 64)


def test_max_pool_eq_mask_backward_matches_jax(rng):
    """Ties (forced by rounding to a coarse grid) get the cotangent on
    every tied element, as the JAX eq-mask VJP does."""
    x = np.round(rng.uniform(-1, 1, (2, 7, 5, 3)) * 4) / 4  # (B, H, W, C)
    x = x.astype(np.float32)
    g = rng.uniform(-1, 1, (2, 3, 5, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_max_pool_floor(a, (2, 1)), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    y = max_pool_floor(xt, (2, 1))
    y.backward(torch.as_tensor(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_j)
    )


@pytest.mark.parametrize(
    "kernel,bin_dil,temp_dil",
    [((5, 13), 1, 1), ((5, 13), 1, 2), ((5, 13), 1, 16), ((4, 6), 2, 3)],
)
def test_conv2d_same_matches_jax_with_gradients(rng, kernel, bin_dil, temp_dil):
    """Time-dilated layers run as an undilated conv over time phases; the
    value and both gradients match the JAX lax conv (float32, 1e-4 of the
    largest magnitude: reordered sums)."""
    kf, kt = kernel
    x = rng.standard_normal((2, 12, 37, 3)).astype(np.float32)  # NHWC
    w = rng.standard_normal((kf, kt, 3, 4)).astype(np.float32)  # HWIO
    g = rng.standard_normal((2, 12, 37, 4)).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda a, k: j_conv2d_same(a, k, bin_dil, temp_dil), jnp.asarray(x), jnp.asarray(w)
    )
    gx_j, gw_j = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    wt = torch.as_tensor(w).permute(3, 2, 0, 1).requires_grad_(True)
    y_t = conv2d_same(xt, wt, None, bin_dil, temp_dil)
    y_t.backward(torch.as_tensor(g).permute(0, 3, 1, 2))
    for got, want in (
        (y_t.detach().permute(0, 2, 3, 1), y_j),
        (xt.grad.permute(0, 2, 3, 1), gx_j),
        (wt.grad.permute(2, 3, 1, 0), gw_j),
    ):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


# --- compute-path options: the small model against the JAX module ---------
# float32, the same converted weights.  Tolerances: output 1e-5 max-abs and
# latent 1e-4 of its largest magnitude for options that only reorder float32
# sums; "dft_bf16" rounds the windowed frames to bf16 (about 0.5 % noise on
# the power spectrum), and a bf16 trunk ("compute" activation I/O) rounds
# every layer: 2e-2 on the sigmoid output, both sides rounding at slightly
# different places.

SMALL = dict(
    in_ch=2, n_samples=8192, sr=44100, n_fft=512, hop_len=256, n_mels=32,
    kernel_size=(5, 13), out_channels=(8, 8, 8), temp_dilations=(1, 2, 4), pool_size=(2, 1),
)
OPTIONS = [
    dict(conv_impl="freq_folded"),
    dict(conv_impl="pair"),
    dict(wgrad_impl="pallas"),
    dict(wgrad_impl="s2b"),
    dict(grad_barrier=True),
    dict(grad_barrier="l0"),
    dict(conv_impl="pair", wgrad_impl="pallas", grad_barrier="all"),
    dict(stft_impl="dft"),
    dict(stft_impl="rfft"),
    dict(stft_impl="dft_bf16"),
    dict(act_io_dtype="compute"),
    dict(act_io_dtype="compute", compute_dtype="bfloat16"),
]


def _small_pair(opts):
    x = (0.3 * np.random.default_rng(3).standard_normal((2, 2, 8192))).astype(np.float32)
    j_model = JSpectral2DCNN(**SMALL, **opts)
    params = JSpectral2DCNN(**SMALL).init(jax.random.PRNGKey(0), jnp.asarray(x))
    t_model = Spectral2DCNN(**SMALL, **opts)
    t_model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return x, j_model, params, t_model


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_option_forward_matches_jax(opts):
    x, j_model, params, t_model = _small_pair(opts)
    out_j, lat_j = j_model.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out_t, lat_t = t_model(torch.as_tensor(x))
    loose = opts.get("stft_impl") == "dft_bf16" or opts.get("compute_dtype") == "bfloat16"
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-2 if loose else 1e-5)
    if not loose:
        lat_j = np.asarray(lat_j)
        np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=1e-4 * np.abs(lat_j).max())
    # the options never change a parameter's name or shape
    assert t_model.state_dict().keys() == Spectral2DCNN(**SMALL).state_dict().keys()


@pytest.mark.parametrize(
    "opts",
    [dict(conv_impl="pair"), dict(wgrad_impl="s2b"), dict(wgrad_impl="pallas"),
     dict(conv_impl="freq_folded"), dict(grad_barrier="all"), dict(act_io_dtype="compute")],
    ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()),
)
def test_option_gradients_match_jax(monkeypatch, opts):
    """Parameter gradients of sum(out^2) in each configuration against the
    JAX module in the same configuration.  1e-4 of each leaf's largest
    magnitude (float32, reordered sums); with `wgrad_impl="pallas"` the conv
    weights of the 8-channel layers carry K6's bf16 rounding of x and dy on
    both sides (the TPU kernel runs in interpret mode, substituted on the
    name the JAX model imported): 2e-2, the kernel's own bound."""
    import functools

    import mod_extraction_tpu.models.spectral_2dcnn as jmod
    from mod_extraction_tpu.ops.pallas_conv import make_conv2d_custom as j_make

    monkeypatch.setattr(jmod, "make_conv2d_custom", functools.partial(j_make, interpret=True))
    x, j_model, params, t_model = _small_pair(opts)
    grads_j = jax.grad(lambda p: jnp.sum(j_model.apply(p, jnp.asarray(x))[0] ** 2))(params)
    g_j = flax_to_state_dict(jax.tree.map(np.asarray, grads_j))
    (t_model(torch.as_tensor(x))[0] ** 2).sum().backward()
    for k, p in t_model.named_parameters():
        want = g_j[k].numpy()
        kernel_leaf = opts.get("wgrad_impl") == "pallas" and k in ("convs.1.weight", "convs.2.weight")
        tol = 2e-2 if kernel_leaf else 1e-4
        np.testing.assert_allclose(p.grad.numpy(), want, atol=tol * np.abs(want).max(), err_msg=k)


def test_unknown_options_are_refused():
    for kw in (dict(conv_impl="cudnn"), dict(wgrad_impl="triton"), dict(act_io_dtype="bf16")):
        with pytest.raises(AssertionError):
            Spectral2DCNN(**SMALL, **kw)
    with pytest.raises(ValueError):
        with torch.no_grad():
            Spectral2DCNN(**SMALL, stft_impl="fft")(torch.zeros(1, 2, 8192))
