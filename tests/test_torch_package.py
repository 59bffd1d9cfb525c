"""Package boundary of the PyTorch port: it imports no JAX and nothing of
the JAX package, its entry points refuse a CUDA request without a card,
and its kernel wrappers never answer a non-CPU tensor with the plain
version."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mod_extraction_tpu_torch
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_interwoven_batch
from mod_extraction_tpu_torch.models.convert import load_spectral_2dcnn
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.ops import conv_kernels, fx_kernels, lstm_kernels
from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask
from mod_extraction_tpu_torch.train.render import RenderConfig
from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask
from mod_extraction_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mod_extraction_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mod_extraction_tpu")
R7 = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    # whole top-level name: `mod_extraction_tpu_torch` is not the JAX package
    return module.split(".")[0] in FORBIDDEN


def test_no_jax_imports_in_package_or_chip_smoke():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imported_modules(f)
        if _forbidden(m)
    ]
    assert not bad, bad
    assert _forbidden("mod_extraction_tpu.ops.fx")
    assert not _forbidden("mod_extraction_tpu_torch.ops.fx")


def test_package_imports_with_jax_blocked():
    mods = [
        m.name
        for m in pkgutil.walk_packages(
            mod_extraction_tpu_torch.__path__, "mod_extraction_tpu_torch."
        )
    ]
    assert "mod_extraction_tpu_torch.train.lfo_task" in mods
    for new in ("ops.conv_kernels", "ops.lfo", "models.random_lfo"):
        assert f"mod_extraction_tpu_torch.{new}" in mods
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(sr=44100.0, n_samples=4410, effects=(2,), max_delay_samples=485)
    model = Spectral2DCNN(in_ch=2, n_samples=4410, out_channels=(4,), n_mels=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LFOExtractionTask(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_spectral_2dcnn(R7, in_ch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TBPTTEffectModelingTask(LSTMEffectModel(n_hidden=8), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_to_torch(make_interwoven_batch(0, 3, 4410, 44100.0))
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    x = torch.empty(2, 1, 64, device="meta")
    p = torch.empty(2, 1, 1, device="meta")
    fx_kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="meta"):
        fx_kernels.flanger(x, x, p, p, p, 16)
    with pytest.raises(RuntimeError, match="meta"):
        fx_kernels.phaser(x, x, p, p, 6)
    assert fx_kernels.LAUNCHES == {"flanger": 0, "phaser": 0}


def test_lstm_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """Neither K3, K4 nor K5 answers a non-CPU tensor with its plain
    version."""
    b, t, hid = 2, 16, 8
    m = dict(device="meta")
    seq, xres = torch.empty(b, 2, t, **m), torch.empty(b, 1, t, **m)
    h = torch.empty(b, hid, **m)
    w = (torch.empty(2, 4 * hid, **m), torch.empty(hid, 4 * hid, **m), torch.empty(4 * hid, **m),
         torch.empty(hid, 1, **m), torch.empty(1, **m))
    lstm_kernels.reset_launch_counts()
    for fn in (lstm_kernels.lstm_forward, lstm_kernels.lstm_train_forward):
        with pytest.raises(RuntimeError, match="meta"):
            fn(seq, xres, h, h, *w)
    hs, gates = torch.empty(b, t, hid, **m), torch.empty(b, t, 4 * hid, **m)
    with pytest.raises(RuntimeError, match="meta"):
        lstm_kernels.lstm_backward(seq, hs, hs, gates, h, h, *w[:2], hs, h, h)
    assert set(lstm_kernels.LAUNCHES.values()) == {0}


def test_conv_wgrad_wrapper_does_not_fall_back_off_the_cpu(monkeypatch):
    """K6's wrapper answers only a CPU tensor with the plain version: a
    tensor elsewhere raises, and a CUDA tensor goes to the kernel's build
    (stubbed here to show the path taken) and never to the plain version."""
    x = torch.empty(2, 8, 4, 20, device="meta")
    conv_kernels.reset_launch_counts()

    def no_plain(*a, **k):
        raise AssertionError("the plain version was taken for a non-CPU tensor")

    monkeypatch.setattr(conv_kernels, "conv2d_wgrad_plain", no_plain)
    with pytest.raises(RuntimeError, match="meta"):
        conv_kernels.conv2d_wgrad_tapcat(x, x, 5, 13, 1)

    class FakeCuda:
        """Stands for a tensor on a card: only what the wrapper reads before
        it loads the kernel."""
        device = torch.device("cuda", 0)
        ndim, shape = 4, (2, 8, 4, 20)

    def no_card():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(conv_kernels, "_load", no_card)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        conv_kernels.conv2d_wgrad_tapcat(FakeCuda(), FakeCuda(), 5, 13, 1)
    assert conv_kernels.LAUNCHES == {"conv_wgrad": 0}


def test_model_with_kernel_wgrad_loads_the_shipped_weights():
    """Every compute-path option leaves the parameter names alone, so the
    shipped .npz loads in the hand-written weight-gradient configuration."""
    model = load_spectral_2dcnn(
        R7, device="cpu", in_ch=2, out_channels=(64,) * 6, temp_dilations=(1, 1, 2, 4, 8, 16),
        pool_size=(2, 1), wgrad_impl="pallas", conv_impl="pair", grad_barrier="l0",
        act_io_dtype="compute", stft_impl="dft",
    )
    assert model.wgrad_impl == "pallas" and len(model.convs) == 6
