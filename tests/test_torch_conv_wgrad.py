"""K6's plain version and the conv with an explicitly chosen backward
(`ops/conv_kernels.py`) against the JAX package on the CPU.

`conv2d_wgrad_plain` is what the CUDA kernel is held against on the card, so
here it is held against the TPU kernel run in interpret mode
(`conv2d_wgrad_tapcat(interpret=True)`) on the same numpy inputs: both round
the operands to bf16 and sum exact products in float32, so only the order of
the sums differs: 1e-3 of the largest |dW|.  Against the float32 reference
the bf16 rounding of the operands shows: 2e-2 of the largest |dW| (the
bounds of `scripts/tpu_parity_gate.py` and `tests/test_pallas_conv.py`).

The autograd function is compared with `make_conv2d_custom(...,
interpret=True)` in float32: y 2e-5, dx 2e-4, dw 2e-3 and db 2e-4 max-abs,
the JAX package's own bounds for these combinations (reordered sums; dw of
"pallas" also carries the bf16 rounding, which bf16-exact inputs remove).

The port's tensors are NCHW / OIHW, the JAX ones NHWC / HWIO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import pallas_conv as jpc
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.ops import conv_kernels as ck


def nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def oihw(w):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


# (B, F, T, ci, co, dil, tile_t, chunk_f): the JAX package's own cases
CASES = [
    (2, 16, 48, 8, 8, 1, 32, 4),
    (2, 8, 48, 16, 8, 2, 32, 4),
    (1, 8, 96, 8, 8, 4, 32, 4),
    (1, 8, 128, 8, 8, 4, 16, 8),  # halo > tile: three dy copies on the TPU
]


@pytest.mark.parametrize("b,f,t,ci,co,dil,tile_t,chunk_f", CASES)
def test_plain_wgrad_matches_tpu_kernel_interpreted(b, f, t, ci, co, dil, tile_t, chunk_f):
    x, dy = _rand((b, f, t, ci), 0), _rand((b, f, t, co), 1)
    want = np.asarray(jpc.conv2d_wgrad_tapcat(
        jnp.asarray(x), jnp.asarray(dy), dil=dil, tile_t=tile_t, chunk_f=chunk_f, interpret=True
    ))
    ref = np.asarray(jpc.conv2d_wgrad_reference(jnp.asarray(x), jnp.asarray(dy), dil=dil))
    got = ck.conv2d_wgrad_plain(nchw(x), nchw(dy), 5, 13, dil)
    assert tuple(got.shape) == (co, ci, 5, 13) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(hwio(got), want, atol=1e-3 * scale)
    np.testing.assert_allclose(hwio(got), ref, atol=2e-2 * scale)
    # the wrapper takes the plain version for CPU tensors, and the port's
    # float32 reference is the JAX one
    assert torch.equal(ck.conv2d_wgrad_tapcat(nchw(x), nchw(dy), 5, 13, dil), got)
    ref_t = ck.conv2d_wgrad_reference(nchw(x), nchw(dy), 5, 13, dil)
    np.testing.assert_allclose(hwio(ref_t), ref, atol=1e-5 * scale)


def test_plain_wgrad_other_kernel_sizes():
    """kf, kt odd and not (5, 13), against the port's float32 reference."""
    x, dy = nchw(_rand((2, 6, 31, 8), 2)), nchw(_rand((2, 6, 31, 16), 3))
    for kf, kt, dil in ((3, 7, 1), (1, 5, 3), (7, 3, 2)):
        got = ck.conv2d_wgrad_plain(x, dy, kf, kt, dil)
        ref = ck.conv2d_wgrad_reference(x, dy, kf, kt, dil)
        assert tuple(got.shape) == (16, 8, kf, kt)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-2 * ref.abs().max().item())
    with pytest.raises(ValueError):
        ck.conv2d_wgrad_plain(x, dy, 4, 13, 1)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))


COMBOS = [
    # fwd, dgrad, wgrad, with_bias
    ("pair", "pair", "xla", False),
    ("pair", "lax", "xla", False),
    ("lax", "pair", "xla", False),
    ("lax", "lax", "xla", True),
    ("lax", "lax", "pallas", True),
    ("lax", "lax", "s2b", True),
    ("lax", "autodiff", "pallas", False),
]


@pytest.mark.parametrize("fwd,dgrad,wgrad,with_bias", COMBOS)
def test_custom_conv_matches_jax(rng, fwd, dgrad, wgrad, with_bias):
    t_dil = 2
    # inputs exact in bf16, so that K6's rounding of x and g loses nothing
    x = _bf16_exact(rng.standard_normal((2, 8, 40, 8)))
    w = (0.1 * rng.standard_normal((5, 13, 8, 16))).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    g = _bf16_exact(rng.standard_normal((2, 8, 40, 16)))

    j_conv = jpc.make_conv2d_custom(
        t_dil, fwd_impl=fwd, dgrad_impl=dgrad, wgrad_impl=wgrad, interpret=True,
        with_bias=with_bias, barrier=with_bias,
    )
    j_args = (jnp.asarray(x), jnp.asarray(w)) + ((jnp.asarray(b),) if with_bias else ())
    y_j = j_conv(*j_args)
    grads_j = jax.grad(
        lambda *a: jnp.sum(j_conv(*a) * jnp.asarray(g)), argnums=tuple(range(len(j_args)))
    )(*j_args)

    t_conv = ck.make_conv2d_custom(
        t_dil, fwd_impl=fwd, dgrad_impl=dgrad, wgrad_impl=wgrad, with_bias=with_bias
    )
    t_args = [nchw(x).requires_grad_(True), oihw(w).requires_grad_(True)]
    if with_bias:
        t_args.append(torch.as_tensor(b).requires_grad_(True))
    y_t = t_conv(*t_args)
    y_t.backward(nchw(g))

    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(nhwc(t_args[0].grad), np.asarray(grads_j[0]), atol=2e-4)
    np.testing.assert_allclose(hwio(t_args[1].grad), np.asarray(grads_j[1]), atol=2e-3)
    if with_bias:
        np.testing.assert_allclose(t_args[2].grad.numpy(), np.asarray(grads_j[2]), atol=2e-4)


def test_same_pallas_wgrad_conv_matches_jax():
    """`make_conv2d_same_pallas_wgrad`: y, dx and dw against the JAX
    function in interpret mode (float32 inputs: dw carries K6's bf16
    rounding on both sides, 1e-3 of the largest |dw|)."""
    b, f, t, ci, co, dil = 2, 8, 48, 8, 8, 2
    x, w, g = _rand((b, f, t, ci), 4), _rand((5, 13, ci, co), 5) * 0.1, _rand((b, f, t, co), 6)
    j_conv = jpc.make_conv2d_same_pallas_wgrad(dil, interpret=True)
    dx_j, dw_j = jax.grad(
        lambda a, k: jnp.sum(j_conv(a, k) * jnp.asarray(g)), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    xt, wt = nchw(x).requires_grad_(True), oihw(w).requires_grad_(True)
    y_t = ck.make_conv2d_same_pallas_wgrad(dil)(xt, wt)
    y_t.backward(nchw(g))
    np.testing.assert_allclose(nhwc(y_t), np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx_j), atol=1e-5)
    dw_j = np.asarray(dw_j)
    np.testing.assert_allclose(hwio(wt.grad), dw_j, atol=1e-3 * np.abs(dw_j).max())


@pytest.mark.parametrize("kernel", [(5, 13), (5, 6), (4, 7)])
def test_custom_conv_library_passes_equal_autograd(rng, kernel):
    """dgrad "autodiff" and wgrad "xla" are the library's own backward
    passes (called directly for an odd kernel, through autograd of the
    forward for an even one): y, dx, dw and db equal autograd of
    `conv2d_same` bit for bit in float32 on the CPU, db to 1e-5 as below."""
    from mod_extraction_tpu_torch.ops.conv import conv2d_same

    kf, kt = kernel
    x = torch.as_tensor(rng.standard_normal((2, 3, 8, 29)).astype(np.float32))
    w = torch.as_tensor((0.1 * rng.standard_normal((4, 3, kf, kt))).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((4,)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((2, 4, 8, 29)).astype(np.float32))
    conv = ck.make_conv2d_custom(3, fwd_impl="lax", dgrad_impl="autodiff", wgrad_impl="xla", with_bias=True)
    out = []
    for fn in (conv, lambda a, k, c: conv2d_same(a, k, c, 1, 3)):
        args = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*args)
        y.backward(g)
        out.append([y.detach()] + [t.grad for t in args])
    for got, want in zip(out[0][:3], out[1][:3]):
        assert torch.equal(got, want)
    torch.testing.assert_close(out[0][3], out[1][3], rtol=0, atol=1e-5 * out[1][3].abs().max().item())


def test_custom_conv_rejects_unknown_options():
    for kw in (dict(fwd_impl="folded"), dict(wgrad_impl="cudnn"), dict(dgrad_impl="xla")):
        with pytest.raises(ValueError):
            ck.make_conv2d_custom(1, **kw)


@pytest.mark.parametrize("mode", [True, "all", "l0"])
def test_grad_barrier_gradients_bit_exact(rng, mode):
    """`grad_barrier` selects the custom function with its float32 db and
    never the math: in float32 on the CPU the loss and the gradient of every
    conv weight, PReLU slope and head parameter equal the default path's
    bit for bit.  The conv biases are the one place where the function does
    its own arithmetic (db = the float32 sum of the cotangent, where the
    default path leaves db to the library's conv backward, which adds the
    same numbers in its own order): 1e-5 of the leaf's largest magnitude."""
    kw = dict(
        in_ch=2, n_samples=8192, sr=44100, n_fft=512, hop_len=256, n_mels=32,
        kernel_size=(5, 13), out_channels=(8, 8, 8), temp_dilations=(1, 2, 4), pool_size=(2, 1),
    )
    x = torch.as_tensor((0.3 * rng.standard_normal((2, 2, 8192))).astype(np.float32))
    m0, m1 = Spectral2DCNN(**kw), Spectral2DCNN(grad_barrier=mode, **kw)
    m1.load_state_dict(m0.state_dict())
    losses = []
    for m in (m0, m1):
        loss = (m(x)[0] ** 2).sum()
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    for (k, p0), (_, p1) in zip(m0.named_parameters(), m1.named_parameters()):
        assert p0.grad is not None and p0.grad.abs().max() > 0, k
        if k.startswith("convs.") and k.endswith(".bias"):
            torch.testing.assert_close(
                p1.grad, p0.grad, rtol=0, atol=1e-5 * p0.grad.abs().max().item(), msg=k
            )
        else:
            assert torch.equal(p0.grad, p1.grad), k


# ---------------------------------------------------------------------------
# the trunk's default conv on the card, with K6 as its weight gradient; on CPU
# tensors K6's wrapper takes its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dil", [1, 2, 4, 8, 16])
def test_kernel_wgrad_conv_on_cpu(dil):
    """`conv2d_same_phases_kernel_wgrad` at each trunk dilation, 345 frames
    (a multiple of no dilation but 1), the cotangent in the phase form with
    zeros in the phases' padding (as K7's backward leaves it): the forward
    and dx equal `conv2d_same_phases` and its autograd bit for bit; dW is
    K6's plain version on the unphased operands, bit for bit in the weight's
    dtype, and within 2e-2 of the largest |dW| of the float32 reference."""
    from mod_extraction_tpu_torch.ops.conv import conv2d_same_phases, from_time_phases, time_phases

    gen = torch.Generator().manual_seed(dil)
    x = torch.randn(2, 8, 6, 345, generator=gen).to(torch.bfloat16)
    w = (0.1 * torch.randn(16, 8, 5, 13, generator=gen)).to(torch.bfloat16)
    g = torch.randn(2, 16, 6, 345, generator=gen).to(torch.bfloat16)
    g_ph = time_phases(g, dil) if dil > 1 else g
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ya, da = conv2d_same_phases(xa, wa, None, 1, dil)
    (dxa,) = torch.autograd.grad(ya, xa, g_ph)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yb, db = ck.conv2d_same_phases_kernel_wgrad(xb, wb, dil)
    dxb, dwb = torch.autograd.grad(yb, (xb, wb), g_ph)
    assert da == db == dil and yb.shape == (2 * dil, 16, 6, -(-345 // dil))
    assert torch.equal(ya, yb)
    assert torch.equal(dxa, dxb)
    assert dwb.dtype == torch.bfloat16
    g_u = from_time_phases(g_ph, dil, 345) if dil > 1 else g
    assert torch.equal(g_u, g)
    assert torch.equal(dwb, ck.conv2d_wgrad_plain(x, g, 5, 13, dil).to(torch.bfloat16))
    ref = ck.conv2d_wgrad_reference(x, g, 5, 13, dil)
    assert (dwb.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


def test_kernel_wgrad_conv_without_input_gradient():
    """Layer 1 of a trunk whose input needs no gradient: dW alone, and no
    data pass."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 4, 30, generator=gen)
    w = (0.1 * torch.randn(8, 8, 5, 13, generator=gen)).requires_grad_(True)
    y, d = ck.conv2d_same_phases_kernel_wgrad(x, w, 4)
    g = torch.randn(y.shape, generator=gen)
    (dw,) = torch.autograd.grad(y, w, g)
    from mod_extraction_tpu_torch.ops.conv import from_time_phases

    g_u = from_time_phases(g, 4, 30)
    # the phases' padding of g (t >= 30) is no frame: K6 reads T frames only
    assert torch.equal(dw, ck.conv2d_wgrad_plain(x, g_u, 5, 13, 4))


@pytest.mark.parametrize("phases,t", [(2, 345), (16, 345), (3, 64)])
def test_channels_last_copy_of_phases_on_cpu(phases, t):
    """K6's operand copy from the phase form: frames back in order, the
    phases' padding dropped, bf16, channels last."""
    from mod_extraction_tpu_torch.ops.conv import time_phases

    a = torch.randn(2, 8, 3, t)
    got = ck.channels_last_bf16(time_phases(a, phases), phases, t)
    assert torch.equal(got, a.permute(0, 2, 3, 1).to(torch.bfloat16))


def test_wgrad_takes_a_phase_form_cotangent_on_cpu():
    """`conv2d_wgrad_tapcat(..., dy_phases=d)` is the same function of the
    unphased cotangent, and refuses a cotangent of another phase count."""
    from mod_extraction_tpu_torch.ops.conv import time_phases

    gen = torch.Generator().manual_seed(5)
    x, g = torch.randn(2, 8, 3, 45, generator=gen), torch.randn(2, 8, 3, 45, generator=gen)
    got = ck.conv2d_wgrad_tapcat(x, time_phases(g, 4), 5, 13, 4, dy_phases=4)
    assert torch.equal(got, ck.conv2d_wgrad_plain(x, g, 5, 13, 4))
    with pytest.raises(ValueError, match="time phases"):
        ck.conv2d_wgrad_tapcat(x, time_phases(g, 4), 5, 13, 4, dy_phases=2)
