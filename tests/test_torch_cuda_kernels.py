"""The port's CUDA kernels (K1 flanger/chorus delay line, K2 phaser cascade,
K3/K4/K5 LSTM effect model, K6 conv weight gradient) against their plain
PyTorch versions on the card.

Marked `cuda`; each test skips without a GPU (the kernels have no interpret
mode).  This file imports torch, numpy and the port only, so it also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances, those of `scripts/tpu_parity_gate.py` (the kernel and the
plain version round the same float32 recurrence in a different order of
fused operations): 1e-4 max-abs on outputs and states; every gradient leaf
within 5e-4 of its largest magnitude.  K6 sums exact bf16 products in
float32 in another order than its plain version: 1e-3 of the largest |dW|;
against the float32 reference its bf16 operands show: 2e-2."""

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch.data.synthetic import (
    batch_to_torch,
    flanger_max_delay_samples,
    make_interwoven_batch,
)
from mod_extraction_tpu_torch.ops import conv_kernels, fx_kernels, lstm_kernels
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch

TOL = 1e-4
GRAD_REL = 5e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")


def _u(rng, lo, hi, shape):
    return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,lo", [(485, 0.0), (1764, 485.0)], ids=["flanger", "chorus"])
def test_flanger_kernel_matches_plain(d, lo):
    _need_cuda()
    rng = np.random.default_rng(d)
    b, c, t = 6, 2, 3000
    x = _u(rng, -0.9, 0.9, (b, c, t))
    delay = _u(rng, 0, 1, (b, c, t)) * (d - 1 - lo - 1e-3) + lo
    fb, depth, mix = (_u(rng, a, 1.0, (b, 1, 1)) for a in (0.0, 0.25, 0.25))
    fx_kernels.reset_launch_counts()
    out = fx_kernels.flanger(x, delay, 0.7 * fb, depth, mix, d)
    assert fx_kernels.LAUNCHES["flanger"] == 1
    ref = fx_kernels.flanger_plain(x, delay, 0.7 * fb, depth, mix, d)
    assert (out - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_phaser_kernel_matches_plain():
    _need_cuda()
    rng = np.random.default_rng(1)
    b, c, t = 6, 2, 3000
    x, g = _u(rng, -0.9, 0.9, (b, c, t)), _u(rng, 0.001, 30.0, (b, c, t))
    fb, mix = _u(rng, 0.0, 0.7, (b, 1, 1)), _u(rng, 0.2, 1.0, (b, 1, 1))
    fx_kernels.reset_launch_counts()
    out = fx_kernels.phaser(x, g, fb, mix, 6)
    assert fx_kernels.LAUNCHES["phaser"] == 1
    ref = fx_kernels.phaser_plain(x, g, fb, mix, 6)
    assert (out - ref).abs().max().item() <= TOL


@pytest.mark.cuda
def test_render_batch_on_card_matches_cpu():
    """An interwoven batch rendered with the kernels on the card equals the
    same batch rendered with the plain versions on the CPU."""
    _need_cuda()
    sr, n = 44100.0, 4410
    cfg = RenderConfig(
        sr=sr, n_samples=n, effects=(2, 3),
        max_delay_samples=flanger_max_delay_samples(30.0, 10.0, sr),
    )
    batch = make_interwoven_batch(4, 6, n, sr)
    _, wet_gpu, mod_gpu, _ = render_batch(batch_to_torch(batch, "cuda"), cfg)
    _, wet_cpu, mod_cpu, _ = render_batch(batch_to_torch(batch, "cpu"), cfg)
    assert (wet_gpu.cpu() - wet_cpu).abs().max().item() <= TOL
    assert (mod_gpu.cpu() - mod_cpu).abs().max().item() <= 1e-5


def _lstm_inputs(b, t, hid, in_dim=2, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hid)
    seq = _u(rng, 0.0, 1.0, (b, in_dim, t))
    seq[:, -1] = 0.3 * torch.as_tensor(rng.standard_normal((b, t)).astype(np.float32), device="cuda")
    return dict(
        seq=seq, xres=seq[:, -1:].contiguous(),
        h0=_u(rng, -0.3, 0.3, (b, hid)), c0=_u(rng, -0.3, 0.3, (b, hid)),
        w_ih=_u(rng, -k, k, (in_dim, 4 * hid)), w_hh=_u(rng, -k, k, (hid, 4 * hid)),
        b=_u(rng, -k, k, (4 * hid,)), fc_k=_u(rng, -k, k, (hid, 1)), fc_b=_u(rng, -k, k, (1,)),
    )


# H 16 and 64 take the register-resident kernels, H 160 (the shipped chorus
# model's width) and H 50 (not a multiple of 4) the generic ones; T around
# the forward chunk of 64 and the backward chunk of 32, and ragged
LSTM_HIDDEN = [16, 64, 160, 50]
LSTM_SHAPES = [(5, 300), (1, 1), (1, 63), (5, 64), (1, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", LSTM_SHAPES)
@pytest.mark.parametrize("hid", LSTM_HIDDEN)
def test_lstm_forward_kernels_match_plain(hid, b, t):
    """K3 and K4: y, hn, cn and K4's saved hs, cs and gate activations."""
    _need_cuda()
    assert lstm_kernels.fast_path(hid) == (hid in (16, 32, 64))
    a = _lstm_inputs(b, t, hid)
    lstm_kernels.reset_launch_counts()
    out3 = lstm_kernels.lstm_forward(**a)
    out4 = lstm_kernels.lstm_train_forward(**a)
    assert lstm_kernels.LAUNCHES["lstm_forward"] == lstm_kernels.LAUNCHES["lstm_train_forward"] == 1
    ref = lstm_kernels.lstm_forward_plain(**a, save_states=True)
    assert len(out4) == len(ref) == 6 and out4[5].shape == (b, t, 4 * hid)
    for got, want in zip(out3, ref[:3]):
        assert (got - want).abs().max().item() <= TOL
    for got, want in zip(out4, ref):
        assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", LSTM_SHAPES)
@pytest.mark.parametrize("hid", LSTM_HIDDEN)
def test_lstm_backward_kernel_matches_plain(hid, b, t):
    """K5 against the plain reverse loop on the same saved states and gate
    activations, and bit-identical from run to run (fixed-order reduction)."""
    _need_cuda()
    a = _lstm_inputs(b, t, hid, seed=1)
    _, _, _, hs, cs, gates = lstm_kernels.lstm_forward_plain(**a, save_states=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    dh_in = torch.randn(b, t, hid, device="cuda", generator=g)
    dhn, dcn = (torch.randn(b, hid, device="cuda", generator=g) for _ in range(2))
    args = (a["seq"], hs, cs, gates, a["h0"], a["c0"], a["w_ih"], a["w_hh"], dh_in, dhn, dcn)
    got = lstm_kernels.lstm_backward(*args)
    again = lstm_kernels.lstm_backward(*args)
    want = lstm_kernels.lstm_backward_plain(*args)
    for x, y, z in zip(got, want, again):
        assert x.shape == y.shape
        assert (x - y).abs().max().item() <= GRAD_REL * y.abs().max().item()
        assert torch.equal(x, z)


@pytest.mark.cuda
def test_lstm_generic_kernels_serve_a_fast_width():
    """With `ALLOW_FAST` off, H 64 runs on the generic kernels and agrees
    with the register-resident ones within the kernels' tolerance."""
    _need_cuda()
    a = _lstm_inputs(3, 100, 64, seed=3)
    fast = lstm_kernels.lstm_train_forward(**a)
    lstm_kernels.ALLOW_FAST = False
    try:
        assert not lstm_kernels.fast_path(64)
        generic = lstm_kernels.lstm_train_forward(**a)
    finally:
        lstm_kernels.ALLOW_FAST = True
    for x, y in zip(fast, generic):
        assert (x - y).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 160])
def test_lstm_training_pair_matches_autograd_of_plain(hid):
    """The K4/K5 autograd function against autograd through the plain
    forward: the loss and every gradient leaf, dh0 and dc0 included."""
    _need_cuda()
    a = _lstm_inputs(4, 257, hid, seed=2)
    x, lat = a["seq"][:, 1:].contiguous(), a["seq"][:, :1].contiguous()
    tgt = torch.randn(4, 1, 257, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    names = ("w_ih", "w_hh", "b", "fc_k", "fc_b")

    def grads(fn):
        leaves = [a[n].clone().requires_grad_() for n in names]
        xs, ls, h0, c0 = (v.clone().requires_grad_() for v in (x, lat, a["h0"], a["c0"]))
        y, hn, cn = fn(*leaves, xs, ls, h0, c0)
        loss = ((y - tgt) ** 2).mean() + (hn**2).mean() + (cn**2).mean()
        loss.backward()
        return loss.item(), [v.grad for v in (*leaves, xs, ls, h0, c0)]

    def plain(w_ih, w_hh, b, fc_k, fc_b, xs, ls, h0, c0):
        return lstm_kernels.lstm_forward_plain(torch.cat([ls, xs], 1), xs, h0, c0, w_ih, w_hh, b, fc_k, fc_b)

    loss_k, g_k = grads(lstm_kernels.lstm_effect_model_train)
    loss_p, g_p = grads(plain)
    assert abs(loss_k - loss_p) <= 1e-6 + 1e-4 * abs(loss_p)
    for got, want in zip(g_k, g_p):
        assert (got - want).abs().max().item() <= GRAD_REL * want.abs().max().item()


# (B, Ci, Co, F, T, kf, kt, dil): ragged T, channel counts below and above
# one 64-channel tile, every trunk dilation, other odd kernels
WGRAD_CASES = [
    (2, 16, 8, 6, 57, 5, 13, 4),
    (2, 64, 64, 9, 345, 5, 13, 1),
    (3, 64, 64, 8, 345, 5, 13, 16),
    (1, 8, 8, 4, 131, 5, 13, 2),
    (2, 72, 80, 5, 70, 5, 13, 8),
    (2, 16, 16, 7, 40, 3, 7, 1),
    (2, 8, 16, 5, 33, 1, 5, 3),
    (1, 16, 8, 9, 50, 7, 3, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,co,f,t,kf,kt,dil", WGRAD_CASES)
def test_conv_wgrad_kernel_matches_plain(b, ci, co, f, t, kf, kt, dil):
    """K6 against its plain version and the float32 reference, bit-identical
    from launch to launch (fixed-order two-pass sum), one count per call."""
    _need_cuda()
    rng = np.random.default_rng(b * 1000 + t)
    x = torch.as_tensor((0.3 * rng.standard_normal((b, ci, f, t))).astype(np.float32), device="cuda")
    dy = torch.as_tensor((0.3 * rng.standard_normal((b, co, f, t))).astype(np.float32), device="cuda")
    conv_kernels.reset_launch_counts()
    got = conv_kernels.conv2d_wgrad_tapcat(x, dy, kf, kt, dil)
    again = conv_kernels.conv2d_wgrad_tapcat(x.to(torch.bfloat16), dy.to(torch.bfloat16), kf, kt, dil)
    assert conv_kernels.LAUNCHES["conv_wgrad"] == 2
    assert tuple(got.shape) == (co, ci, kf, kt) and got.dtype == torch.float32
    assert torch.equal(got, again)
    plain = conv_kernels.conv2d_wgrad_plain(x, dy, kf, kt, dil)
    ref = conv_kernels.conv2d_wgrad_reference(x, dy, kf, kt, dil)
    scale = ref.abs().max().item()
    assert (got - plain).abs().max().item() <= 1e-3 * scale
    assert (got - ref).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
def test_conv_wgrad_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    x = torch.zeros(1, 12, 4, 20, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_kernels.conv2d_wgrad_tapcat(x, x, 5, 13, 1)
    x = torch.zeros(1, 8, 4, 20, device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        conv_kernels.conv2d_wgrad_tapcat(x, x, 9, 13, 1)
    with pytest.raises(ValueError, match="odd"):
        conv_kernels.conv2d_wgrad_tapcat(x, x, 4, 13, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("wgrad", ["pallas", "xla", "s2b"])
def test_custom_conv_on_card_matches_cpu(wgrad):
    """The conv with a chosen backward, bf16 on the card, against the same
    function in float32 on the CPU from the same bf16-exact inputs: y and
    every gradient within 2e-2 of the largest magnitude (bf16 outputs)."""
    _need_cuda()
    rng = np.random.default_rng(5)

    def exact(shape, s=1.0):
        return torch.as_tensor((s * rng.standard_normal(shape)).astype(np.float32)).bfloat16().float()

    x, w, b, g = exact((2, 8, 8, 40)), exact((16, 8, 5, 13), 0.1), exact((16,)), exact((2, 16, 8, 40))
    out = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        args = [a.to(dev, dt).requires_grad_(True) for a in (x, w, b)]
        conv = conv_kernels.make_conv2d_custom(2, wgrad_impl=wgrad, with_bias=True)
        y = conv(*args)
        y.backward(g.to(dev, dt))
        out[dev] = [y.detach().float().cpu()] + [a.grad.float().cpu() for a in args]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
