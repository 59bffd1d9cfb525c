"""The port's plotting and media hooks (`mod_extraction_tpu_torch/utils/
plotting.py`) against the JAX package's `utils/plotting.py` on the CPU.

Every matplotlib call that draws data (`Axes.plot`, `Axes.imshow`) and every
title is recorded on both sides and compared: the plot helpers' arrays and
titles exactly (the same numpy code); the log spectrogram of the port's
`_log_spec` bit for bit; the written wavs byte for byte where the audio is
the same.  The media callbacks run through each package's own task, tiny
and float32, from the same JAX-initialised weights, on the same batch: the
LFO overlays' arrays within 1e-5 and the wet spectrograms within 1e-3 in
the log domain (float32 render and extractor sums in another order), the
titles' L1% equal, the written dry / wet / wet_hat wavs within one PCM16
step.  Every PNG a helper writes is checked to be a PNG."""

import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import optax
import pytest
import torch

matplotlib.use("Agg")

import torch_ddp_workers as W  # noqa: E402
from mod_extraction_tpu.utils import plotting as jplot  # noqa: E402
from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch  # noqa: E402
from mod_extraction_tpu_torch.data.wav import wav_read  # noqa: E402
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict  # noqa: E402
from mod_extraction_tpu_torch.utils import plotting as tplot  # noqa: E402


def _png_ok(path):
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(path) > 1000


@pytest.fixture
def drawn(monkeypatch):
    """Records the data of every `plot` / `imshow` and every title, in
    order, and still draws them."""
    from matplotlib.axes import Axes

    calls = []
    for name in ("plot", "imshow", "set_title"):
        orig = getattr(Axes, name)

        def rec(self, *args, _orig=orig, _name=name, **kw):
            calls.append((_name, [np.array(a, copy=True) if not isinstance(a, str) else a for a in args]))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, name, rec)
    return calls


def _split(calls, n_sides=2):
    half = len(calls) // n_sides
    assert len(calls) == n_sides * half
    return calls[:half], calls[half:]


def _assert_same_drawing(a, b, atol=0.0, spec_atol=0.0):
    assert [c[0] for c in a] == [c[0] for c in b]
    for (name, x), (_, y) in zip(a, b):
        if name == "set_title":
            assert x == y
            continue
        for u, v in zip(x, y):
            np.testing.assert_allclose(u, v, rtol=0, atol=spec_atol if name == "imshow" else atol)


@pytest.mark.parametrize("n", [4096, 8192, 1001])
def test_log_spec_is_jaxs(rng, n):
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tplot._log_spec(audio), jplot._log_spec(audio))


def test_plot_spectrogram_draws_and_writes_what_jax_does(tmp_path, rng, drawn):
    audio = (rng.standard_normal(8192) * 0.1).astype(np.float32)
    paths = [mod.plot_spectrogram(audio, "spec", title="t", sr=44100.0, save_dir=str(tmp_path / side),
                                  save_audio=True)
             for mod, side in ((jplot, "jax"), (tplot, "torch"))]
    _assert_same_drawing(*_split(drawn))
    for p in paths:
        _png_ok(p)
    with open(tmp_path / "jax" / "spec.wav", "rb") as a, open(tmp_path / "torch" / "spec.wav", "rb") as b:
        assert a.read() == b.read()
    y, sr = wav_read(str(tmp_path / "torch" / "spec.wav"))
    assert sr == 44100 and y.shape[-1] == 8192 and abs(float(np.ravel(y)[0])) < 1e-3  # faded in


@pytest.mark.parametrize("with_gt", [True, False], ids=["overlay", "estimate_only"])
def test_plot_mod_sig_draws_what_jax_does(tmp_path, rng, drawn, with_gt):
    gt = rng.uniform(0, 1, 345).astype(np.float32)
    est = np.clip(gt[:340] + 0.05, 0, 1)
    for mod, side in ((jplot, "jax"), (tplot, "torch")):
        _png_ok(mod.plot_mod_sig(est, gt if with_gt else None, save_name="mod", save_dir=str(tmp_path / side)))
    a, b = _split(drawn)
    _assert_same_drawing(a, b)
    assert ("l1:" in a[-1][1][0]) == with_gt


@pytest.mark.parametrize("n", [1, 3])
def test_plot_waveforms_stacked_draws_what_jax_does(tmp_path, rng, drawn, n):
    w = [(rng.standard_normal(4096) * 0.2).astype(np.float32) for _ in range(n)]
    labels = ["dry", "wet", "wet_hat"][:n]
    for mod, side in ((jplot, "jax"), (tplot, "torch")):
        _png_ok(mod.plot_waveforms_stacked(w, labels, save_name="wf", save_dir=str(tmp_path / side)))
    _assert_same_drawing(*_split(drawn))


class _Trainer:
    """What a media callback reads of its Trainer."""

    def __init__(self, task, out_dir):
        self.task, self.corpus, self.out_dir, self.run_name = task, None, out_dir, "run"


def _tasks(kind):
    """(JAX task, its params, the port's task with the same weights)."""
    from mod_extraction_tpu.models import LSTMEffectModel as JLSTM
    from mod_extraction_tpu.models import Spectral2DCNN as JCNN
    from mod_extraction_tpu.train.lfo_task import LFOExtractionTask as JLFO
    from mod_extraction_tpu.train.render import RenderConfig as JRender
    from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JTBPTT

    cfg = JRender(sr=W.SR, n_samples=W.N, effects=(1, 2, 3), max_delay_samples=89)
    adamw = optax.adamw(1e-4, b1=0.8, b2=0.99)
    if kind == "lfo":
        j = JLFO(model=JCNN(**W.CNN), render_cfg=cfg, optimizer=adamw, loss_dict=W.LOSSES)
        params = j.init_state(jax.random.PRNGKey(0)).params
        sd = {k: v.numpy() for k, v in flax_to_state_dict(jax.tree.map(np.asarray, params)).items()}
        return j, params, W.lfo_task(sd)
    j = JTBPTT(effect_model=JLSTM(in_ch=1, out_ch=1, n_hidden=W.HID, latent_dim=1), render_cfg=cfg,
               lfo_model=None, optimizer=adamw, lstm_impl="scan", **W.TBPTT)
    params = j.init_state(jax.random.PRNGKey(0)).params
    sd = {k: v.numpy() for k, v in flax_lstm_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    return j, params, W.tbptt_task(sd)


def test_lfo_media_callback_draws_what_jax_does(tmp_path, drawn):
    j_task, params, t_task = _tasks("lfo")
    batch = make_synthetic_batch(4, 6, W.N, W.SR, "flanger")
    state = t_task.generator.get_state()
    jplot.lfo_media_callback()(_Trainer(j_task, str(tmp_path / "jax")), params,
                               jax.tree.map(jnp.asarray, batch), 3)
    tplot.lfo_media_callback()(_Trainer(t_task, str(tmp_path / "torch")), batch_to_torch(batch, "cpu"), 3)
    assert torch.equal(t_task.generator.get_state(), state)  # the task's draws untouched
    a, b = _split(drawn)
    assert len(a) == 4 * 5  # four examples: two lines and a title, an image and a title
    _assert_same_drawing(a, b, atol=1e-5, spec_atol=1e-3)
    names = sorted(os.listdir(tmp_path / "torch" / "run_media" / "ep3"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "run_media" / "ep3"))
    assert names == sorted(f"{i}_{k}.png" for i in range(4) for k in ("mod_sig", "wet"))
    for n in names:
        _png_ok(tmp_path / "torch" / "run_media" / "ep3" / n)


def test_em_media_callback_writes_what_jax_does(tmp_path, drawn):
    j_task, params, t_task = _tasks("tbptt")
    batch = make_synthetic_batch(5, 3, W.N, W.SR, "flanger")
    jplot.em_media_callback()(_Trainer(j_task, str(tmp_path / "jax")), params,
                              jax.tree.map(jnp.asarray, batch), 0)
    tplot.em_media_callback()(_Trainer(t_task, str(tmp_path / "torch")), batch_to_torch(batch, "cpu"), 0)
    a, b = _split(drawn)
    _assert_same_drawing(a, b, atol=1e-5)
    jdir, tdir = (tmp_path / side / "run_media" / "ep0" for side in ("jax", "torch"))
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert names == sorted([f"{i}_waveforms.png" for i in range(3)]
                           + [f"{i}_{k}.wav" for i in range(3) for k in ("dry", "wet", "wet_hat")])
    for n in names:
        if n.endswith(".wav"):
            (x, sx), (y, sy) = wav_read(str(tdir / n)), wav_read(str(jdir / n))
            assert sx == sy == int(W.SR) and x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=1.0 / 32767 + 1e-7, err_msg=n)
        else:
            _png_ok(tdir / n)
