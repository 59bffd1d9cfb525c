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


# the port's entry points outside the package
PORT_SCRIPTS = ("chip_smoke.py", "bench_torch.py", "scripts/export_torch_models.py",
                "scripts/bench_torch_streaming.py", "scripts/train_torch.py", "scripts/validate_torch.py",
                "scripts/extract_torch_weights.py", "scripts/validate_ckpt_torch.py",
                "scripts/run_eval_grid_torch.py", "scripts/make_sim_effect_data_torch.py",
                "scripts/make_sim_chorus_gt_control_torch.py", "scripts/resample_torch.py",
                "scripts/fit_ddp_torch.py", "scripts/make_synthetic_corpus_torch.py",
                "scripts/split_datasets_torch.py", "scripts/generate_preproc_datasets_torch.py",
                "scripts/measure_phaser_warmup_delta_torch.py", "scripts/write_model_cards_torch.py",
                "scripts/import_reference_weights_torch.py")
# the training entry point's modules (config/CLI, data pipeline, Trainer)
ENTRY_MODULES = ("cli", "native", "train.loop", "data.wav", "data.datasets", "data.loader",
                 "data.corpus", "data.modules", "evaluation.tables")
# data parallelism, the media hooks and the resampler
DP_MEDIA_RESAMPLE_MODULES = ("parallel.dist", "parallel.dryrun", "utils.plotting", "ops.resample")


def test_no_jax_imports_in_package_or_chip_smoke():
    files = sorted(PKG.rglob("*.py")) + [ROOT / f for f in PORT_SCRIPTS]
    assert len(files) > 15
    for new in ("export/streaming.py", "paths.py", "train/checkpoints.py", "utils/timing.py", "models/torch_port.py"):
        assert PKG / new in files
    for new in ENTRY_MODULES + DP_MEDIA_RESAMPLE_MODULES:
        assert PKG / (new.replace(".", "/") + ".py") in files
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
    for new in ("ops.conv_kernels", "ops.lfo", "models.random_lfo", "export.streaming", "paths",
                "train.checkpoints", "utils.timing", "models.torch_port") + ENTRY_MODULES + DP_MEDIA_RESAMPLE_MODULES:
        assert f"mod_extraction_tpu_torch.{new}" in mods
    scripts = [str(ROOT / f) for f in PORT_SCRIPTS if f != "chip_smoke.py"]
    code = (
        "import sys, importlib, importlib.util\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"for i, f in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_training_eval_and_chip_smoke_do_not_import_matplotlib():
    """matplotlib is imported only for `custom.log_media`: the CLI, the
    Trainer, the eval path, the training scripts and `chip_smoke.py` import
    without it (the GPU machine has none)."""
    scripts = [str(ROOT / f) for f in ("chip_smoke.py", "scripts/train_torch.py", "scripts/validate_torch.py",
                                        "scripts/run_eval_grid_torch.py", "scripts/validate_ckpt_torch.py",
                                        "scripts/resample_torch.py", "scripts/split_datasets_torch.py",
                                        "scripts/generate_preproc_datasets_torch.py",
                                        "scripts/measure_phaser_warmup_delta_torch.py")]
    code = (
        "import sys, importlib, importlib.util\n"
        "sys.modules['matplotlib'] = None\n"
        "for m in ('cli', 'train.loop', 'evaluation.tables', 'parallel.dist', 'parallel.dryrun', 'ops.resample',\n"
        "          'ops.launches', 'models', 'ops', 'utils', 'data', 'parallel', 'losses'):\n"
        "    importlib.import_module('mod_extraction_tpu_torch.' + m)\n"
        f"for i, f in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "try:\n"
        "    importlib.import_module('mod_extraction_tpu_torch.utils.plotting')\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
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
    from mod_extraction_tpu_torch import cli

    r7 = "configs/train_em_sim_flanger_r7.yml"
    for entry in (lambda: cli.RunConfig(cli.load_yaml_with_includes(r7)), lambda: cli.fit(r7),
                  lambda: cli.validate("configs/eval_lfo.yml"),
                  lambda: cli.validate_many([("", cli.load_yaml_with_includes("configs/eval_lfo.yml"))])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
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


def test_build_hash_covers_included_headers(monkeypatch, tmp_path):
    """The build cache key of a CUDA source changes with any header it
    includes from `csrc/` (quoted includes, followed through headers), and
    with nothing outside them, so a changed header never reuses a stale
    library."""
    from mod_extraction_tpu_torch.ops import cuda_build

    (tmp_path / "a.cu").write_text('#include "h1.cuh"\n#include <cuda.h>\nint a;\n')
    (tmp_path / "h1.cuh").write_text('#pragma once\n#include "h2.cuh"\n')
    (tmp_path / "h2.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build.source_digest("a.cu")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert cuda_build.source_digest("a.cu") == first
    (tmp_path / "h2.cuh").write_text("// v2\n")
    assert cuda_build.source_digest("a.cu") != first


def test_repo_kernel_sources_hash_their_shared_header(monkeypatch):
    """`csrc/conv_wgrad.cu` and `csrc/fx.cu` include `csrc/hopper.cuh`; their
    cache keys read the header's bytes, `csrc/lstm.cu`'s does not."""
    from mod_extraction_tpu_torch.ops import cuda_build

    for src in ("conv_wgrad.cu", "fx.cu"):
        assert '#include "hopper.cuh"' in (cuda_build.CSRC / src).read_text()
    before = {src: cuda_build.source_digest(src) for src in ("conv_wgrad.cu", "fx.cu", "lstm.cu")}
    real = cuda_build.Path.read_bytes

    def edited(path):
        data = real(path)
        return data + b"// edited\n" if path.name == "hopper.cuh" else data

    monkeypatch.setattr(cuda_build.Path, "read_bytes", edited)
    assert cuda_build.source_digest("conv_wgrad.cu") != before["conv_wgrad.cu"]
    assert cuda_build.source_digest("fx.cu") != before["fx.cu"]
    assert cuda_build.source_digest("lstm.cu") == before["lstm.cu"]  # lstm.cu does not include it


def test_streaming_entry_points_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    """The serving path defaults to the card and raises without one; the
    export itself (files and a trace) runs on the CPU."""
    from mod_extraction_tpu_torch.export import streaming

    w = "models/lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz"
    target = streaming.export_streaming_model(w, str(tmp_path), "m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: streaming.StreamingEffectModel(w), lambda: streaming.init_stream_state(2, 64),
               lambda: streaming.load_streaming_model(target),
               lambda: streaming.load_compiled_processor(target)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert streaming.load_streaming_model(target, device="cpu").device.type == "cpu"


def test_lstm_forward_operator_cpu_implementation_is_plain(monkeypatch):
    """K3's registered operator answers a CPU tensor with
    `lstm_forward_plain` and launches nothing."""
    g = torch.Generator().manual_seed(0)
    b, t, hid = 2, 5, 4
    args = [torch.rand(*s, generator=g) for s in
            ((b, 2, t), (b, 1, t), (b, hid), (b, hid), (2, 4 * hid), (hid, 4 * hid), (4 * hid,), (hid, 1), (1,))]
    want = lstm_kernels.lstm_forward_plain(*args)
    calls = []
    plain = lstm_kernels.lstm_forward_plain
    monkeypatch.setattr(lstm_kernels, "lstm_forward_plain", lambda *a: calls.append(a) or plain(*a))
    lstm_kernels.reset_launch_counts()
    got = torch.ops.mod_extraction_tpu_torch.lstm_forward(*args)
    assert len(calls) == 1 and all(x is y for x, y in zip(calls[0], args))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert set(lstm_kernels.LAUNCHES.values()) == {0}
    assert lstm_kernels.lstm_forward_op._opoverload is torch.ops.mod_extraction_tpu_torch.lstm_forward.default
