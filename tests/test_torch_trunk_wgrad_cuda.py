"""The trunk's default conv on the card takes its weight gradient from K6
(`ops/conv_kernels.py::conv2d_same_phases_kernel_wgrad`), held against the
library's route (autograd of `conv2d_same_phases`) on the extractor of the
benchmark's stage-1 cell at batch 4.

Marked `cuda`; each test skips without a GPU (K6 has no interpret mode).
This file imports torch, numpy and the port only, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trunk_wgrad_cuda.py

What is held.  The forward output and the input's gradient are the
library route's bit for bit, and so is every gradient K6 does not compute
(layer 0's weight, the biases, PReLU, the head): the route changes only the
five 64-channel layers' weight gradients.  Those are K6's: within 1e-3 of
the largest |dW| of the library's, plus one bf16 step of the value (both
are float32 sums in different orders rounded once to bf16, where a sum on
either side of a rounding boundary lands one step apart), and bit for bit
from one backward to the next.  cuDNN runs deterministic here, so that the
library's own passes repeat their bits.  A forward without gradients (no
grad mode, or a frozen extractor as TBPTT conditions on it) launches no
K6."""

import pytest
import torch

from mod_extraction_tpu_torch.models import spectral_2dcnn
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.ops import conv_kernels as ck
from mod_extraction_tpu_torch.ops.conv import conv2d_same_phases, from_time_phases, time_phases
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

SR, N_SAMPLES, B = 44100, 88200, 4
FRAMES = N_SAMPLES // 256 + 1
# benchmark/configs/pipeline_h64.json's extractor
EXTRACTOR = dict(in_ch=2, n_mels=256, kernel_size=(5, 13), out_channels=[64] * 6,
                 temp_dilations=[1, 1, 2, 4, 8, 16], pool_size=(2, 1), freq_mask_amount=0.25,
                 time_mask_amount=0.25)
DRAWS = [0.31, 0.62, 0.47, 0.15]
K6_LAYERS = [f"convs.{i}.weight" for i in range(1, 6)]
DW_REL, BF16_STEP = 1e-3, 2.0**-7


@pytest.fixture
def deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no interpret mode)")
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def _model():
    return Spectral2DCNN(n_samples=N_SAMPLES, sr=SR, compute_dtype="bfloat16", seed=3, **EXTRACTOR).cuda()


def _inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    audio = torch.zeros(B, 2, N_SAMPLES, device="cuda")
    feats = torch.rand(B, 2, EXTRACTOR["n_mels"], FRAMES, generator=gen, device="cuda") + 1e-3
    g = torch.randn(B, 1, FRAMES, generator=gen, device="cuda")
    return audio, feats, g


def _library_route(monkeypatch):
    """The trunk's convs as before K6 took their weight gradient."""
    monkeypatch.setattr(spectral_2dcnn, "wgrad_supported", lambda *a: False)


def _backward(model, audio, feats, g):
    """(output, d feats, {leaf: grad}, K6 launches) of a train-mode forward
    (SpecAugment on) and the backward of <output, g>."""
    model.zero_grad(set_to_none=True)
    f = feats.clone().requires_grad_(True)
    ck.reset_launch_counts()
    out, _ = model(audio, mask_draws=DRAWS, features=f)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return out.detach(), f.grad.detach(), grads, ck.LAUNCHES["conv_wgrad"]


@pytest.mark.cuda
def test_stage1_backward_takes_k6_weight_gradients(deterministic, monkeypatch):
    audio, feats, g = _inputs()
    model = _model()
    out, dx, grads, n_k6 = _backward(model, audio, feats, g)
    out2, dx2, grads2, n_k6_2 = _backward(model, audio, feats, g)
    assert n_k6 == n_k6_2 == 5, "K6 takes the five 64-channel layers' weight gradients"
    for k in K6_LAYERS:
        assert torch.equal(grads[k], grads2[k]), f"{k}: two backwards from the same state differ"
    with monkeypatch.context() as m:
        _library_route(m)
        lib_out, lib_dx, lib_grads, lib_k6 = _backward(model, audio, feats, g)
    assert lib_k6 == 0
    assert torch.equal(out, lib_out), "forward not the library route's bit for bit"
    assert torch.equal(dx, lib_dx), "the input's gradient not the library route's bit for bit"
    for k, v in lib_grads.items():
        if k in K6_LAYERS:
            scale = v.abs().max().item()
            err = (grads[k] - v).abs()
            bad = (err > DW_REL * scale + BF16_STEP * v.abs()).sum().item()
            print(f"{k}: K6 vs library max {err.max().item() / scale:.3e} of max|dW| ({bad} outside)")
            assert bad == 0, f"{k}: {bad} of {v.numel()} elements outside the limit"
        else:
            assert torch.equal(grads[k], v), f"{k}: a gradient K6 does not compute differs"


@pytest.mark.cuda
def test_no_gradient_no_k6(deterministic, monkeypatch):
    """No grad mode, and a frozen extractor (TBPTT's conditioning, and its
    forward with grad mode on): the library's forward alone, 0 launches."""
    audio, feats, _ = _inputs()
    model = _model()
    ck.reset_launch_counts()
    with torch.no_grad():
        out = model(audio, mask_draws=DRAWS, features=feats)[0]
    assert ck.LAUNCHES["conv_wgrad"] == 0
    with monkeypatch.context() as m, torch.no_grad():
        _library_route(m)
        assert torch.equal(out, model(audio, mask_draws=DRAWS, features=feats)[0])
    task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=16), RenderConfig(sr=SR, n_samples=N_SAMPLES), lfo_model=model,
        device="cuda")
    assert not any(p.requires_grad for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    dry, wet = (0.1 * torch.randn(B, 1, N_SAMPLES, generator=gen, device="cuda") for _ in range(2))
    ck.reset_launch_counts()
    task._condition(dry, wet, None, None)
    with torch.enable_grad():
        task._extract_mod_sig(dry, wet, None)
    assert ck.LAUNCHES["conv_wgrad"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("phases,f,t", [(2, 6, 345), (4, 3, 57), (16, 2, 345), (3, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_channels_last_copy_reads_time_phases(deterministic, phases, f, t, dtype):
    """K6's operand copy from the phase form equals torch's reorder, cast
    and permute bit for bit; the phases' padded tail is dropped."""
    a = time_phases(torch.randn(3, 72, f, t, device="cuda"), phases).to(dtype).contiguous()
    got = ck.channels_last_bf16(a, phases, t)
    want = from_time_phases(a, phases, t).permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dil", [1, 2, 4, 8, 16])
def test_kernel_wgrad_conv_at_the_cell_shapes(deterministic, dil):
    """The Function on one trunk layer at batch 4 (64 channels, the cell's
    rows for the dilation, 345 frames, a cotangent with zeros in the
    phases' padding as K7's backward leaves it): forward and dx the library
    route's bit for bit, dW K6's on the unphased cotangent bit for bit."""
    rows = {1: 128, 2: 64, 4: 32, 8: 16, 16: 8}[dil]
    gen = torch.Generator(device="cuda").manual_seed(dil)
    x = torch.randn(B, 64, rows, FRAMES, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.05 * torch.randn(64, 64, 5, 13, generator=gen, device="cuda")).to(torch.bfloat16)
    g = torch.randn(B, 64, rows, FRAMES, generator=gen, device="cuda").to(torch.bfloat16)
    g_ph = time_phases(g, dil).contiguous() if dil > 1 else g
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ya, da = conv2d_same_phases(xa, wa, None, 1, dil)
    dxa, _ = torch.autograd.grad(ya, (xa, wa), g_ph)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ck.reset_launch_counts()
    yb, db = ck.conv2d_same_phases_kernel_wgrad(xb, wb, dil)
    dxb, dwb = torch.autograd.grad(yb, (xb, wb), g_ph)
    assert ck.LAUNCHES["conv_wgrad"] == 1 and da == db == dil
    assert torch.equal(ya, yb) and torch.equal(dxa, dxb)
    assert dwb.dtype == torch.bfloat16
    assert torch.equal(dwb, ck.conv2d_wgrad_tapcat(x, g, 5, 13, dil).to(torch.bfloat16))
