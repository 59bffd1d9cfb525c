"""The trunk's block between two convs on the CPU (`ops/trunk_kernels.py`):
its plain version against the eager composition of `models/common.py`'s
functions, and `Spectral2DCNN` against its forward as composed before the
block existed, bit for bit, forward and backward.

The card's kernel (K7) is held against the plain version in
`tests/test_torch_trunk_block_cuda.py`."""

import pytest
import torch

from mod_extraction_tpu_torch.models.common import PReLU, layer_norm_no_affine, max_pool_floor
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.ops import trunk_kernels as tk
from mod_extraction_tpu_torch.ops.conv import conv2d_same, from_time_phases, time_phases
from mod_extraction_tpu_torch.ops.launches import launch_counts, reset_launch_counts
from mod_extraction_tpu_torch.ops.stft import mel_spectrogram

FRAMES = 37


def _composed(y, bias, alpha, blk):
    """The chain as the model composed it: the conv's output (bias added
    after the product), `max_pool_floor`, the `PReLU` module,
    `layer_norm_no_affine`, the cast."""
    h = from_time_phases(y, blk.phases, blk.width) if blk.phases > 1 else y
    if bias is not None:
        h = h + bias.to(h.dtype)[None, :, None, None]
    h = max_pool_floor(h, (blk.pool, 1))
    act = PReLU(alpha.shape[0], keep_dtype=blk.narrow)
    del act.alpha
    act.alpha = alpha  # the leaf the gradient is taken for
    h = act(h)
    if blk.ln:
        h = layer_norm_no_affine(h, dims=(2, 3), stat_dtype=torch.float32 if blk.narrow else None)
    return h.to(blk.out_dtype)


def _inputs(b, c, h, d, dtype, seed, ties=False, zeros=False, w=FRAMES):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(b, c, h, w, generator=gen)
    if ties:
        y = torch.round(y * 2) / 2
    if zeros:
        y[:, :, : h // 2] = 0
    y = time_phases(y, d) if d > 1 else y
    bias = torch.randn(c, generator=gen) * (0.0 if ties or zeros else 0.3)
    alpha = torch.rand(c, generator=gen) * 0.6 - 0.1
    return y.to(dtype), bias, alpha


def _grads(fn, y, bias, alpha, blk):
    leaves = [t.detach().clone().requires_grad_() for t in (y, bias, alpha)]
    out = fn(*leaves, blk)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out.dtype)
    return [out, *torch.autograd.grad(out, leaves, g)]


CASES = {
    "main": dict(),
    "ln_off": dict(ln=False),
    "last": dict(ln=False, out_dtype=torch.float32),
    "compute": dict(narrow=True),
    "compute_ln_off": dict(narrow=True, ln=False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("data", ["plain", "ties", "zeros", "phases", "tail"])
def test_plain_block_is_the_composed_chain(dtype, case, data):
    """Bit for bit, forward and the three gradients: ties in a window (the
    cotangent reaches every tied element), x = 0 at PReLU, a time-phased
    input read through its phases, a floor-mode tail row."""
    d = 4 if data == "phases" else 1
    h = 9 if data == "tail" else 8
    y, bias, alpha = _inputs(2, 3, h, d, dtype, seed=len(data) + len(case),
                             ties=data == "ties", zeros=data == "zeros")
    opts = dict(CASES[case])
    if dtype == torch.float32 and opts.get("out_dtype") is None:
        opts["out_dtype"] = torch.float32
    blk = tk.Block(phases=d, width=FRAMES, pool=2, **opts)
    reset_launch_counts()
    got = _grads(tk.trunk_block, y, bias, alpha, blk)
    want = _grads(_composed, y, bias, alpha, blk)
    for name, a, b in zip(("out", "dy", "dbias", "dalpha"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert set(launch_counts().values()) == {0}  # the CPU path launches nothing
    if data == "ties":
        dy = got[1].reshape(-1, 2, FRAMES)  # the pool's windows: pairs of rows
        assert (dy != 0).all(dim=1).any()
    if data == "tail":
        assert (got[1][:, :, -1] == 0).all()


def test_no_grad_saves_nothing():
    y, bias, alpha = _inputs(2, 3, 8, 2, torch.bfloat16, seed=3)
    bias.requires_grad_()
    with torch.no_grad():
        out = tk.trunk_block(y, bias, alpha, tk.Block(phases=2, width=FRAMES))
    assert out.grad_fn is None and not out.requires_grad


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    y = torch.empty(2, 3, 8, FRAMES, device="meta", dtype=torch.bfloat16)
    alpha = torch.empty(3, device="meta")
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="meta"):
        tk.trunk_block(y, None, alpha, tk.Block())
    assert tk.LAUNCHES == {"trunk_block_fwd": 0, "trunk_block_bwd": 0}


def test_the_block_is_counted_with_the_other_kernels():
    assert {"trunk_block_fwd", "trunk_block_bwd"} <= set(launch_counts())


def _forward_as_composed(m, x):
    """`Spectral2DCNN.forward` (no SpecAugment) as composed before the
    block: LayerNorm, conv with its bias, pool, PReLU, layer by layer."""
    spec = mel_spectrogram(x, int(m.sr), m.n_fft, m.hop_len, m.n_mels, impl=m.stft_impl)
    h = torch.log(torch.clamp(spec, min=m.eps))
    cd = m.compute_dtype
    if m.act_compute:
        h = h.to(cd)
    for conv, prelu, b_dil, t_dil in zip(m.convs, m.prelus, m.bin_dil, m.temp_dil):
        if m.use_ln:
            h = layer_norm_no_affine(h, dims=(2, 3), stat_dtype=torch.float32 if m.act_compute else None)
        h = conv2d_same(h.to(cd), conv.weight.to(cd), conv.bias.to(cd), b_dil, t_dil)
        h = max_pool_floor(h, m.pool_size)
        h = prelu(h)
    latent = h.to(torch.float32).mean(dim=2)
    out = torch.sigmoid(m.out(latent.transpose(1, 2)))
    return out.transpose(1, 2), latent


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act_io_dtype", ["float32", "compute"])
@pytest.mark.parametrize("use_ln", [True, False], ids=["ln", "no_ln"])
def test_model_on_the_cpu_is_what_it_was(compute_dtype, act_io_dtype, use_ln):
    m = Spectral2DCNN(in_ch=2, n_samples=4096, n_fft=256, hop_len=64, n_mels=32, out_channels=[4, 4, 4],
                      temp_dilations=[1, 2, 4], pool_size=(2, 1), use_ln=use_ln, compute_dtype=compute_dtype,
                      act_io_dtype=act_io_dtype, seed=3)
    with torch.no_grad():
        for p in m.parameters():  # biases and alphas off their initial values
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    x = torch.randn(2, 2, 4096, generator=torch.Generator().manual_seed(0))
    reset_launch_counts()
    got = m(x)
    want = _forward_as_composed(m, x)
    params = list(m.parameters())
    g_got = torch.autograd.grad(got[0].sum() + got[1].square().sum(), params)
    g_want = torch.autograd.grad(want[0].sum() + want[1].square().sum(), params)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert set(launch_counts().values()) == {0}
