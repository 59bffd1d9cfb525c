"""The port's CUDA kernels (K1 flanger/chorus delay line, K2 phaser cascade)
against their plain PyTorch versions on the card.

Marked `cuda`; each test skips without a GPU (the kernels have no interpret
mode).  This file imports torch, numpy and the port only, so it also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: 1e-4 max-abs, the kernel tolerance of
`scripts/tpu_parity_gate.py` (the kernel and the plain version round the
same float32 recurrence in a different order of fused operations)."""

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch.data.synthetic import (
    batch_to_torch,
    flanger_max_delay_samples,
    make_interwoven_batch,
)
from mod_extraction_tpu_torch.ops import fx_kernels
from mod_extraction_tpu_torch.train.render import RenderConfig, render_batch

TOL = 1e-4


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
