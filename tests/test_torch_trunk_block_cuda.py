"""K7, the trunk's block between two convs (`ops/trunk_kernels.py`,
`csrc/trunk_block.cu`), against its plain version on the card.

Marked `cuda`; each test skips without a GPU (the kernels have no interpret
mode).  This file imports torch, numpy and the port only, so it also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trunk_block_cuda.py

Tolerances.  The forward is held bit for bit: the kernels round at the
plain version's points (the biased conv output, PReLU, LayerNorm's result,
the casts) and LayerNorm's statistics are torch's own reductions.  The
backward's sums run in another order: LayerNorm's two backward sums, and
dalpha's and the bias gradient's sums over (B, H, W).  A value rounded to
bf16 after such a sum may land one bf16 step away (2^-7 of its magnitude at
most), or, near zero, differ by the sum's own error (1e-5 of the tensor's
largest magnitude); float32 results: 1e-5 relative and of the largest
magnitude.  dalpha and dbias sum up to 4.4 million terms a channel: 1e-3
of the largest channel's magnitude, plus one bf16 step where they are
rounded to bf16."""

import pytest
import torch

from mod_extraction_tpu_torch.ops import trunk_kernels as tk
from mod_extraction_tpu_torch.ops.conv import time_phases

BF16_STEP = 2.0**-7
NEAR_ZERO = 1e-5
F32_REL = 1e-5
SUM_REL = 1e-3

# the blocks of the benchmark's extractor cell (pipeline_h64): conv rows H,
# time phases d over its 345 frames
CELL = {"L0": (256, 1), "L1": (128, 1), "L5": (8, 16)}
FRAMES = 345


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")


def _inputs(b, c, h, d, dtype, seed, ties=False, w=FRAMES):
    """A conv output in its phase form (B*d, C, H, ceil(W/d)), a bias and
    an alpha (float32 parameters), all on the card."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(b, c, h, w, generator=gen)
    if ties:  # few distinct values: most windows tie
        y = torch.round(y * 2) / 2
    y = time_phases(y, d) if d > 1 else y
    bias = torch.randn(c, generator=gen) * (0.0 if ties else 0.3)
    alpha = torch.rand(c, generator=gen) * 0.6 - 0.1
    return (y.to(dtype).cuda().contiguous(), bias.cuda(), alpha.cuda())


def _run(fn, y, bias, alpha, blk, g_seed=7):
    """fn's output and the gradients of <out, g> for a fixed random g."""
    y, bias, alpha = (None if t is None else t.detach().clone().requires_grad_() for t in (y, bias, alpha))
    out = fn(y, bias, alpha, blk)
    gen = torch.Generator().manual_seed(g_seed)
    g = torch.randn(out.shape, generator=gen).to(out.dtype).cuda()
    leaves = [t for t in (y, bias, alpha) if t is not None]
    grads = list(torch.autograd.grad(out, leaves, g))
    dy, dalpha = grads[0], grads[-1]
    return out, dy, None if bias is None else grads[1], dalpha


def _close(k, p, bf16_rounded):
    k, p = k.float(), p.float()
    scale = p.abs().max().item()
    if bf16_rounded:
        tol = BF16_STEP * p.abs() + NEAR_ZERO * scale
    else:
        tol = F32_REL * (p.abs() + scale)
    bad = ((k - p).abs() > tol).sum().item()
    return bad == 0, f"{bad} of {p.numel()} outside; max diff {(k - p).abs().max().item():.3e}, scale {scale:.3e}"


def _sums_close(k, p, bf16_rounded):
    k, p = k.float(), p.float()
    tol = SUM_REL * p.abs().max().item() + (BF16_STEP * p.abs() if bf16_rounded else 0)
    ok = bool(((k - p).abs() <= tol).all())
    return ok, f"max diff {(k - p).abs().max().item():.3e} of {p.abs().max().item():.3e}"


def _check(y, bias, alpha, blk):
    kern = _run(tk.trunk_block, y, bias, alpha, blk)
    plain = _run(tk.trunk_block_plain, y, bias, alpha, blk)
    in_bf16 = y.dtype == torch.bfloat16
    assert torch.equal(kern[0], plain[0]), "forward not bit for bit"
    ok, msg = _close(kern[1], plain[1], in_bf16)
    assert ok, f"conv cotangent: {msg}"
    if bias is not None:
        ok, msg = _sums_close(kern[2], plain[2], in_bf16)
        assert ok, f"bias gradient: {msg}"
    ok, msg = _sums_close(kern[3], plain[3], in_bf16 and blk.narrow)
    assert ok, f"dalpha: {msg}"
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("layer", list(CELL))
def test_cell_shapes_match_plain(layer):
    """The cell's blocks (bf16 convs, act I/O float32, LayerNorm on) at batch 4."""
    _need_cuda()
    h, d = CELL[layer]
    y, bias, alpha = _inputs(4, 64, h, d, torch.bfloat16, seed=h + d)
    _check(y, bias, alpha, tk.Block(phases=d, width=FRAMES, pool=2))


@pytest.mark.cuda
def test_cell_l0_at_batch_99():
    _need_cuda()
    y, bias, alpha = _inputs(99, 64, 256, 1, torch.bfloat16, seed=99)
    _check(y, bias, alpha, tk.Block(pool=2))


SETTINGS = [
    # (conv dtype, narrow, ln, out dtype)
    (torch.bfloat16, False, True, torch.bfloat16),   # the main path
    (torch.bfloat16, False, False, torch.bfloat16),  # use_ln off
    (torch.bfloat16, False, False, torch.float32),   # the last block
    (torch.bfloat16, True, True, torch.bfloat16),    # act_io_dtype "compute"
    (torch.bfloat16, True, False, torch.bfloat16),
    (torch.float32, False, True, torch.float32),
    (torch.float32, True, True, torch.float32),
    (torch.float32, False, False, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: f"{str(s[0])[6:]}-narrow{int(s[1])}-ln{int(s[2])}-{str(s[3])[6:]}")
@pytest.mark.parametrize("d", [1, 2, 16])
def test_settings_match_plain(setting, d):
    """Each dtype and option setting, a floor-mode tail row (H 33, pool 2),
    phases and none."""
    _need_cuda()
    dtype, narrow, ln, out_dtype = setting
    y, bias, alpha = _inputs(3, 5, 33, d, dtype, seed=d)
    _check(y, bias, alpha, tk.Block(phases=d, width=FRAMES, pool=2, ln=ln, narrow=narrow, out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 3, 4])
def test_other_pools_and_no_bias(pool):
    _need_cuda()
    y, _, alpha = _inputs(2, 3, 46, 4, torch.bfloat16, seed=pool)
    _check(y, None, alpha, tk.Block(phases=4, width=FRAMES, pool=pool))


@pytest.mark.cuda
def test_ties_send_the_cotangent_to_every_tied_element():
    _need_cuda()
    y, bias, alpha = _inputs(2, 4, 64, 2, torch.bfloat16, seed=5, ties=True)
    kern, plain = _check(y, bias, alpha, tk.Block(phases=2, width=FRAMES, pool=2))
    # the same elements get a cotangent: the eq mask is exact on both sides
    assert torch.equal(kern[1] != 0, plain[1] != 0)
    # ... and ties are common here: windows where both rows carry it
    both = ((plain[1] != 0).reshape(-1, 2, plain[1].shape[-1])).all(dim=1).sum().item()
    assert both > 1000


@pytest.mark.cuda
def test_x_zero_at_prelu_takes_slope_one():
    """Biased conv outputs of exactly 0 (windows of zeros): slope 1, as
    `where(x >= 0, ...)` gives."""
    _need_cuda()
    y, bias, alpha = _inputs(2, 3, 16, 1, torch.bfloat16, seed=11)
    y[:, :, :8] = 0
    _check(y, torch.zeros_like(bias), alpha, tk.Block(pool=2))


@pytest.mark.cuda
def test_strided_conv_output_is_read_where_it_lies():
    """A view with rows further apart than its frames (the `[..., :W]` of
    a phase form) and a channel-sliced tensor, against their copies."""
    _need_cuda()
    y, bias, alpha = _inputs(2, 6, 32, 1, torch.bfloat16, seed=13, w=FRAMES + 1)
    view = y[:, 1:5, :, :FRAMES]
    assert view.stride(2) == FRAMES + 1
    blk = tk.Block(pool=2)
    a = _run(tk.trunk_block, view, bias[1:5], alpha[1:5], blk)
    b = _run(tk.trunk_block, view.contiguous(), bias[1:5], alpha[1:5], blk)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    _check(view, bias[1:5], alpha[1:5], blk)


@pytest.mark.cuda
def test_relaunch_is_bit_identical():
    _need_cuda()
    y, bias, alpha = _inputs(8, 64, 128, 1, torch.bfloat16, seed=17)
    blk = tk.Block(pool=2)
    a = _run(tk.trunk_block, y, bias, alpha, blk)
    b = _run(tk.trunk_block, y, bias, alpha, blk)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_no_grad_saves_nothing_and_counts_one_forward():
    _need_cuda()
    y, bias, alpha = _inputs(2, 4, 32, 2, torch.bfloat16, seed=19)
    bias.requires_grad_()
    tk.reset_launch_counts()
    with torch.no_grad():
        out = tk.trunk_block(y, bias, alpha, tk.Block(phases=2, width=FRAMES))
    assert out.grad_fn is None
    assert tk.LAUNCHES == {"trunk_block_fwd": 1, "trunk_block_bwd": 0}
    ref = tk.trunk_block_plain(y, bias.detach(), alpha, tk.Block(phases=2, width=FRAMES))
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_what_the_kernels_do_not_take_raises():
    _need_cuda()
    y, bias, alpha = _inputs(2, 4, 32, 1, torch.bfloat16, seed=23)
    blk = tk.Block()
    with pytest.raises(ValueError, match="kernels take"):
        tk.trunk_block(y.half(), bias, alpha, blk)
    with pytest.raises(ValueError, match="kernels take"):
        tk.trunk_block(y, bias, alpha, blk._replace(out_dtype=torch.float16))
    with pytest.raises(ValueError, match="back to back"):
        tk.trunk_block(y.transpose(2, 3), bias, alpha, blk)
    with pytest.raises(ValueError, match="bias must be float32"):
        tk.trunk_block(y, bias.double(), alpha, blk)
    with pytest.raises(ValueError, match="alpha must be float32"):
        tk.trunk_block(y, bias, alpha[:3], blk)
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.empty(1, 1, 16, 300000, dtype=torch.bfloat16, device="cuda")
        tk.trunk_block(big, None, alpha[:1], blk)


@pytest.mark.cuda
def test_model_step_counts_six_and_six():
    """The paper's extractor on the card: a forward + backward launches K7
    six times each way, the forward alone under no_grad six and none."""
    _need_cuda()
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN

    m = Spectral2DCNN(in_ch=2, out_channels=[64] * 6, temp_dilations=[1, 1, 2, 4, 8, 16], pool_size=(2, 1),
                      n_mels=256, compute_dtype="bfloat16").cuda()
    x = torch.randn(2, 2, 88200, device="cuda") * 0.1
    tk.reset_launch_counts()
    out, latent = m(x)
    (out.sum() + latent.sum()).backward()
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {"trunk_block_fwd": 6, "trunk_block_bwd": 6}
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())
    tk.reset_launch_counts()
    with torch.no_grad():
        m(x)
    assert tk.LAUNCHES == {"trunk_block_fwd": 6, "trunk_block_bwd": 0}
