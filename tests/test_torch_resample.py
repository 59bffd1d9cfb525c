"""The port's resampler (`mod_extraction_tpu_torch/ops/resample.py`) against
the JAX package's `ops/resample.py` on the CPU: the FIR bank bit for bit,
the output within 1e-6 max-abs (float32 dot products of 13-51 taps summed
in another order) on `tests/test_resample.py`'s rate pairs, the shapes and
the identity, and `scripts/resample_torch.py` against `scripts/resample.py`
(the same PCM16 files, within one step of 16-bit rounding)."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from mod_extraction_tpu.ops import resample as jres
from mod_extraction_tpu_torch.data.wav import wav_read, wav_write
from mod_extraction_tpu_torch.ops import resample as tres

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
PAIRS = [(4, 3), (3, 4), (44100, 48000), (48000, 16000)]


@pytest.mark.parametrize("orig,new", PAIRS)
def test_matches_jax(rng, orig, new):
    x = rng.standard_normal(400).astype(np.float32)
    got = tres.resample(x, orig, new, device="cpu")
    want = jres.resample(x, orig, new)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("orig,new", [(44100, 48000), (48000, 44100), (44100, 22050), (44100, 11025)])
def test_matches_jax_on_a_second_of_audio(rng, orig, new):
    x = (0.5 * rng.standard_normal((2, orig))).astype(np.float32)
    got = tres.resample(torch.from_numpy(x), orig, new, device="cpu")
    np.testing.assert_allclose(got.numpy(), jres.resample(x, orig, new), rtol=0, atol=TOL)


@pytest.mark.parametrize("orig,new", PAIRS)
def test_kernel_bank_is_jaxs(orig, new):
    import math

    g = math.gcd(orig, new)
    got, want = tres._kernel_bank(orig // g, new // g), jres._kernel_bank(orig // g, new // g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (tres.LOWPASS_FILTER_WIDTH, tres.ROLLOFF) == (jres.LOWPASS_FILTER_WIDTH, jres.ROLLOFF)


def test_identity_and_shapes(rng):
    x = rng.standard_normal((2, 3, 100)).astype(np.float32)
    same = tres.resample(x, 44100, 44100, device="cpu")
    np.testing.assert_array_equal(same.numpy(), x)
    assert tuple(tres.resample(x, 22050, 44100, device="cpu").shape) == (2, 3, 200)
    assert tuple(tres.resample(x, 44100, 22050, device="cpu").shape) == (2, 3, 50)
    assert tuple(tres.resample(x[0, 0, :99], 3, 4, device="cpu").shape) == (132,)  # ceil(99 * 4 / 3)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tres.resample(np.zeros(10, np.float32), 3, 4)


def test_script_writes_what_the_jax_script_writes(tmp_path, rng, monkeypatch):
    src = tmp_path / "in"
    src.mkdir()
    for i, sr in enumerate((44100, 48000)):
        wav_write(str(src / f"f{i}.wav"), (0.4 * rng.standard_normal((1, sr // 4))).astype(np.float32), sr)
    (src / "notes.txt").write_text("not audio")
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["resample.py", str(src), str(tmp_path / "jax"), "16000"])
    runpy.run_path(os.path.join(ROOT, "scripts", "resample.py"), run_name="__main__")
    spec = runpy.run_path(os.path.join(ROOT, "scripts", "resample_torch.py"))
    spec["main"]([str(src), str(tmp_path / "torch"), "16000", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax")) == ["f0.wav", "f1.wav"]
    for name in ("f0.wav", "f1.wav"):
        (a, sa), (b, sb) = wav_read(str(tmp_path / "torch" / name)), wav_read(str(tmp_path / "jax" / name))
        assert sa == sb == 16000 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 32767 + 1e-7)
