"""The port's LSTM effect model against the JAX package on the CPU: the
forward (plain K3 version) against `LSTMEffectModel.apply` and
`lstm_effect_model_pallas` in interpret mode, state continuation across a
cut, gradients through the port's K4/K5 autograd function (plain versions)
against `jax.vjp` of `lstm_effect_model_pallas_train` in interpret mode, the
converter on a shipped checkpoint, and `torch.nn.LSTM` as a second oracle
of the recurrence.

Tolerances (float32, sums reordered): outputs and states 1e-5 max-abs;
every gradient leaf within 1e-4 of its largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.models.lstm import LSTMEffectModel as JLSTM
from mod_extraction_tpu.ops.pallas_lstm import (
    lstm_effect_model_pallas,
    lstm_effect_model_pallas_train,
)
from mod_extraction_tpu.train.checkpoints import load_weights
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, load_lstm_effect_model
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel, lstm_init_state
from mod_extraction_tpu_torch.ops import lstm_kernels as lk

LSTM64 = "models/lstm_64__lfo_2dcnn_r7__sim_flanger.npz"
ATOL = 1e-5
GRAD_REL = 1e-4


def _setup(rng, b, t, hid, lat=1, state=False):
    jm = JLSTM(in_ch=1, out_ch=1, n_hidden=hid, latent_dim=lat)
    x = (0.3 * rng.standard_normal((b, 1, t))).astype(np.float32)
    latent = rng.uniform(0, 1, (b, lat, t)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x, latent, (np.zeros((b, hid), np.float32),) * 2)
    params = jax.tree.map(np.asarray, params)
    if state:
        h0 = (0.1 * rng.standard_normal((b, hid))).astype(np.float32)
        c0 = (0.1 * rng.standard_normal((b, hid))).astype(np.float32)
    else:
        h0 = c0 = np.zeros((b, hid), np.float32)
    tm = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=hid, latent_dim=lat)
    tm.load_state_dict(flax_lstm_to_state_dict(params))
    return jm, params, tm, x, latent, h0, c0


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_matches_jax_scan_and_pallas(rng):
    b, t, hid = 3, 700, 16
    jm, params, tm, x, latent, h0, c0 = _setup(rng, b, t, hid, state=True)
    y_ref, (h_ref, c_ref) = jm.apply(params, x, latent, (h0, c0))
    y_pal, (h_pal, c_pal) = lstm_effect_model_pallas(
        params, x, latent, (h0, c0), t_chunk=256, interpret=True
    )
    with torch.no_grad():
        y, (h, c) = tm(_t(x), _t(latent), (_t(h0), _t(c0)))
    for ours, ref, pal in ((y, y_ref, y_pal), (h, h_ref, h_pal), (c, c_ref, c_pal)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(pal), rtol=0, atol=ATOL)


def test_state_continuation_across_a_cut(rng):
    """Two calls with the carried state equal one call (the streaming and
    TBPTT contract), and both equal the JAX kernel."""
    b, t, hid, cut = 2, 512, 16, 320
    jm, params, tm, x, latent, h0, c0 = _setup(rng, b, t, hid)
    y_pal, _ = lstm_effect_model_pallas(params, x, latent, (h0, c0), t_chunk=128, interpret=True)
    with torch.no_grad():
        y_full, _ = tm(_t(x), _t(latent), (_t(h0), _t(c0)))
        y1, st = tm(_t(x[:, :, :cut]), _t(latent[:, :, :cut]), (_t(h0), _t(c0)))
        y2, _ = tm(_t(x[:, :, cut:]), _t(latent[:, :, cut:]), st)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(), y_full.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_pal), rtol=0, atol=ATOL)


@pytest.mark.parametrize("b,t,hid", [(3, 300, 16), (2, 60, 160)])
def test_gradients_match_jax_vjp(b, t, hid, rng):
    """Every parameter leaf, dx, dlatent, dh0 and dc0 through the port's
    K4/K5 autograd function against the JAX custom VJP, for cotangents on
    y, hn and cn."""
    jm, params, tm, x, latent, h0, c0 = _setup(rng, b, t, hid, state=True)
    dy = rng.standard_normal((b, 1, t)).astype(np.float32)
    dhn = rng.standard_normal((b, hid)).astype(np.float32)
    dcn = rng.standard_normal((b, hid)).astype(np.float32)

    def f(p, x_, lat_, h_, c_):
        y, (hn, cn) = lstm_effect_model_pallas_train(p, x_, lat_, (h_, c_), interpret=True)
        return y, hn, cn

    (y_ref, hn_ref, cn_ref), vjp = jax.vjp(f, params, x, latent, h0, c0)
    gp, gx, glat, gh0, gc0 = vjp((jnp.asarray(dy), jnp.asarray(dhn), jnp.asarray(dcn)))
    gp = gp["params"]

    xt, latt, h0t, c0t = (_t(a).requires_grad_() for a in (x, latent, h0, c0))
    y, (hn, cn) = tm(xt, latt, (h0t, c0t))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    torch.autograd.backward((y, hn, cn), (_t(dy), _t(dhn), _t(dcn)))
    pairs = [
        (tm.w_ih.grad, gp["w_ih"]), (tm.w_hh.grad, gp["w_hh"]), (tm.b_gates.grad, gp["b_gates"]),
        (tm.fc_kernel.grad, gp["fc"]["kernel"]), (tm.fc_bias.grad, gp["fc"]["bias"]),
        (xt.grad, gx), (latt.grad, glat), (h0t.grad, gh0), (c0t.grad, gc0),
    ]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        err = np.abs(ours.numpy() - ref).max()
        assert err <= GRAD_REL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_plain_backward_matches_autograd(rng):
    """The plain K5 (manual reverse loop) equals autograd through the plain
    forward loop: the contract the CUDA K5 is held to on the card."""
    b, t, hid, in_dim = 2, 80, 8, 2
    g = torch.Generator().manual_seed(3)
    seq = torch.rand(b, in_dim, t, generator=g)
    xres = seq[:, 1:]
    w_ih, w_hh = (0.4 * torch.randn(*s, generator=g) for s in ((in_dim, 4 * hid), (hid, 4 * hid)))
    bias = 0.1 * torch.randn(4 * hid, generator=g)
    fc_k, fc_b = torch.randn(hid, 1, generator=g), torch.randn(1, generator=g)
    h0, c0 = (0.2 * torch.randn(b, hid, generator=g) for _ in range(2))
    leaves = [seq, h0, c0, w_ih, w_hh, bias]
    for a in leaves:
        a.requires_grad_()
    _, hn, cn, hs, cs = lk.lstm_forward_plain(seq, xres.detach(), h0, c0, w_ih, w_hh, bias,
                                              fc_k, fc_b, save_states=True)
    dh_in = torch.randn(b, t, hid, generator=g)
    dhn, dcn = torch.randn(b, hid, generator=g), torch.randn(b, hid, generator=g)
    ref = torch.autograd.grad((hs, hn, cn), leaves, (dh_in, dhn, dcn))
    dseq, dh0, dc0, dw_ih, dw_hh, db = lk.lstm_backward_plain(
        seq.detach(), hs.detach(), cs.detach(), h0.detach(), c0.detach(), w_ih.detach(),
        w_hh.detach(), bias.detach(), dh_in, dhn, dcn,
    )
    for ours, r in zip((dseq, dh0, dc0, dw_ih, dw_hh, db), ref):
        assert (ours - r).abs().max().item() <= GRAD_REL * r.abs().max().item()


def test_converter_on_shipped_checkpoint(rng):
    """The shipped sim-flanger LSTM-64, converted, computes what the JAX
    model computes with the same weights."""
    b, t = 2, 400
    jm = JLSTM(in_ch=1, out_ch=1, n_hidden=64, latent_dim=1)
    params = {"params": load_weights(LSTM64)}
    tm = load_lstm_effect_model(LSTM64, device="cpu")
    assert (tm.n_hidden, tm.latent_dim, tm.out_ch) == (64, 1, 1)
    x = (0.3 * rng.standard_normal((b, 1, t))).astype(np.float32)
    latent = rng.uniform(0, 1, (b, 1, t)).astype(np.float32)
    z = np.zeros((b, 64), np.float32)
    y_ref, (h_ref, _) = jm.apply(params, x, latent, (z, z))
    with torch.no_grad():
        y, (h, _) = tm(_t(x), _t(latent), lstm_init_state(b, 64))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=0, atol=ATOL)
    # a live flax tree converts to the same state_dict
    live = flax_lstm_to_state_dict(jax.tree.map(np.asarray, params))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(live[k].numpy(), v.numpy())


def test_recurrence_matches_torch_nn_lstm(rng):
    """torch's own LSTM (fused bias = bias_ih, zero bias_hh) gives the same
    per-step h and final state as the port's plain recurrence."""
    b, t, hid = 3, 200, 16
    _, _, tm, x, latent, h0, c0 = _setup(rng, b, t, hid, state=True)
    ref = torch.nn.LSTM(2, hid)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(tm.w_ih.T)
        ref.weight_hh_l0.copy_(tm.w_hh.T)
        ref.bias_ih_l0.copy_(tm.b_gates)
        ref.bias_hh_l0.zero_()
        seq = torch.cat([_t(latent), _t(x)], 1)
        hs_ref, (hn_ref, cn_ref) = ref(seq.permute(2, 0, 1), (_t(h0)[None], _t(c0)[None]))
        _, hn, cn, hs, _ = lk.lstm_forward_plain(
            seq, _t(x), _t(h0), _t(c0), tm.w_ih, tm.w_hh, tm.b_gates, tm.fc_kernel,
            tm.fc_bias, save_states=True,
        )
    np.testing.assert_allclose(hs.numpy(), hs_ref.permute(1, 0, 2).numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(hn.numpy(), hn_ref[0].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(cn.numpy(), cn_ref[0].numpy(), rtol=0, atol=ATOL)


def test_init_is_seeded_and_uniform():
    a = LSTMEffectModel(n_hidden=64, generator=torch.Generator().manual_seed(7))
    b = LSTMEffectModel(n_hidden=64, generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    for p in (a.w_ih, a.w_hh, a.b_gates):
        assert p.abs().max().item() <= 1.0 / 8.0
