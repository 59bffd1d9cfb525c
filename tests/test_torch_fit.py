"""The port's `cli.fit` against the JAX package's on the CPU, and the port's
Trainer behaviour (`mod_extraction_tpu_torch/train/loop.py`).

Both packages' `fit` run the same tiny configs from the same corpus:
* LFO extraction: an f32 Spectral2DCNN (two 4-channel layers, 16 mels, no
  SpecAugment, so JAX's mask key draws nothing), the interwoven flanger +
  chorus + phaser data module on a device corpus, a cosine schedule with
  AdamW's config default weight decay (0.01), warm-started from a
  JAX-initialised `.npz`, three batches of 4;
* TBPTT: an H 8 LSTM (warm-started from a JAX-initialised `.npz`) on a tiny
  frozen extractor, dry/wet pairs (whose `seed`, `device_corpus` and
  `transfer_dtype` both CLIs drop, as they drop them from the shipped
  configs), lr 1e-5, one batch,
  `discard_invalid_lfos: false` (a random extractor's LFO fails every
  validity rule).

Tolerances: every `train_step` loss and the epoch's val loss rtol 1e-4; the
final weights atol 1e-5 (LFO) and 2e-5 (TBPTT), those of
`tests/test_torch_lfo_task.py` and `tests/test_torch_tbptt_task.py` (a first
Adam step moves a weight by about lr * g / (|g| + eps), so a gradient that
is nearly zero may move differently by a fraction of lr).  The JAX Trainer
runs on a one-device mesh, as the port's does.  Also: the TBPTT extractor
conditioned on the wet signal alone (`use_dry: false`) against JAX's.
"""

import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.data.wav import wav_write
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict
from mod_extraction_tpu_torch.train.loop import Trainer
from mod_extraction_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, N = 8000, 2000  # LFO fit
N_TBPTT = 8192  # 33 extractor frames, 26 after smoothing: 5 chunks of 1024 after the warm-up
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the suite runs in
    several processes at once, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(rng, n):
    """Decaying plucks over noise: never silent, PCM16-exact after writing."""
    t = np.arange(n) / SR
    x = 0.05 * rng.standard_normal(n)
    for start in rng.uniform(0, n / SR, 6):
        f = rng.uniform(80, 600)
        env = np.where(t >= start, np.exp(-(t - start) * 4.0), 0.0)
        x += 0.3 * env * np.sin(2 * np.pi * f * t)
    return (0.8 * x / np.abs(x).max()).astype(np.float32)


def write_corpus(root, n_files=(3, 2), dur_s=1.5, wet=False):
    """`root/{train,val}` wavs at SR; with `wet`, `dry/` and `wet/` pairs
    (the wet is the dry with a feedback comb)."""
    rng = np.random.default_rng(11)
    for split, n in zip(("train", "val"), n_files):
        for i in range(n):
            x = _audio(rng, int(dur_s * SR))
            name = f"f{i}_{100 + 10 * i}bpm.wav"
            if not wet:
                os.makedirs(os.path.join(root, split), exist_ok=True)
                wav_write(os.path.join(root, split, name), x, SR)
                continue
            y = x.copy()
            for k in range(37, len(y)):
                y[k] += 0.5 * y[k - 37]
            y = (0.9 * y / np.abs(y).max()).astype(np.float32)
            for side, a in (("dry", x), ("wet", y)):
                os.makedirs(os.path.join(root, split, side), exist_ok=True)
                wav_write(os.path.join(root, split, side, name), a, SR)


TINY_CNN = dict(in_ch=2, n_fft=256, hop_len=64, n_mels=16, kernel_size=[3, 5],
                out_channels=[4, 4], temp_dilations=[1, 2], pool_size=[2, 1],
                freq_mask_amount=0.0, time_mask_amount=0.0, compute_dtype="float32")
TINY_EXTRACTOR = dict(TINY_CNN, n_fft=512, hop_len=256)  # TBPTT assumes 256-sample frames


def jax_weights(path, kind, n_samples):
    """A JAX-initialised bare-weights `.npz` of the tiny CNN / extractor /
    LSTM."""
    import jax
    import jax.numpy as jnp

    from mod_extraction_tpu.models import LSTMEffectModel, Spectral2DCNN
    from mod_extraction_tpu.models.lstm import lstm_init_state
    from mod_extraction_tpu.train.checkpoints import save_weights

    key = jax.random.PRNGKey(7)
    if kind == "lstm":
        m = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=8, latent_dim=1)
        params = m.init(key, jnp.zeros((2, 1, 64)), jnp.zeros((2, 1, 64)), lstm_init_state(2, 8))
    else:
        cfg = TINY_CNN if kind == "cnn" else TINY_EXTRACTOR
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
        m = Spectral2DCNN(n_samples=n_samples, sr=SR, **cfg)
        params = m.init(key, jnp.zeros((1, 2, n_samples)))
    save_weights(path, params["params"])
    return path


FL_MOD = {"rate_hz": {"min": 0.5, "max": 3.0}, "phase": {"min": 0.0, "max": 6.28318530718},
          "shapes": ["cos", "rect_cos", "inv_rect_cos", "tri", "saw", "rsaw"], "exp": 1.0}


def interwoven_datasets():
    def fl(mmd, mdw_min):
        return {"dataset_name": "flanger_chorus", "fx_config": {"mod_sig": FL_MOD, "flanger": {
            "max_min_delay_ms": mmd, "max_lfo_delay_ms": 10.0, "feedback": {"min": 0.0, "max": 0.7},
            "min_delay_width": {"min": mdw_min, "max": 1.0}, "width": {"min": 0.25, "max": 1.0},
            "depth": {"min": 0.25, "max": 1.0}, "mix": {"min": 0.25, "max": 1.0}}}}

    phaser = {"dataset_name": "pedalboard_phaser", "fx_config": {"pedalboard_phaser": {
        "rate_hz": {"min": 0.5, "max": 3.0}, "depth": {"min": 0.2, "max": 1.0},
        "centre_frequency_hz": {"min": 70.0, "max": 3500.0}, "feedback": {"min": 0.0, "max": 0.7},
        "mix": {"min": 0.2, "max": 1.0}}}}
    return [fl(1.0, 0.0), fl(30.0, 0.367), phaser]


def lfo_config(corpus, weights, **custom):
    return {
        "seed_everything": 3,
        "custom": {"model_name": "m", "dataset_name": "lfo", "cpu_batch_size": 4,
                   "cpu_train_num_examples_per_epoch": 12, "cpu_val_num_examples_per_epoch": 4,
                   "log_every_n_steps": 1, "init_weights_path": weights, **custom},
        "trainer": {"max_epochs": 1},
        "data": {"class_path": "mod_extraction.data_modules.InterwovenDataModule", "init_args": {
            "batch_size": 99, "num_workers": 2, "transfer_dtype": "int16", "device_corpus": True,
            "shared_args": {"n_samples": N, "sr": SR, "ext": "wav", "silence_fraction_allowed": 0.1,
                            "silence_threshold_energy": 1e-4, "n_retries": 10, "check_dataset": True},
            "shared_train_args": {"input_dir": os.path.join(corpus, "train"), "num_examples_per_epoch": 8000},
            "shared_val_args": {"input_dir": os.path.join(corpus, "val"), "num_examples_per_epoch": 2000},
            "train_dataset_args": interwoven_datasets(), "val_dataset_args": interwoven_datasets()}},
        "model": {"class_path": "mod_extraction.lightning.LFOExtraction", "init_args": {
            "use_dry": True, "model_smooth_n_frames": 4, "should_stretch": False,
            "loss_dict": {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0},
            "model": {"class_path": "mod_extraction.models.Spectral2DCNN", "init_args": dict(TINY_CNN)}}},
        "optimizer": {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-4, "betas": [0.8, 0.99]},
                      "lr_schedule": {"name": "cosine", "warmup_steps": 1, "decay_steps": 4, "end_lr": 1e-6}},
    }


def tbptt_config(corpus, lstm_weights, extractor_weights):
    d = {split: {side: os.path.join(corpus, split, side) for side in ("dry", "wet")}
         for split in ("train", "val")}
    return {
        "seed_everything": 4,
        "custom": {"model_name": "lstm", "dataset_name": "tbptt", "cpu_batch_size": 3,
                   "cpu_train_num_examples_per_epoch": 3, "cpu_val_num_examples_per_epoch": 3,
                   "log_every_n_steps": 1, "init_weights_path": lstm_weights},
        "trainer": {"max_epochs": 1},
        "data": {"class_path": "mod_extraction.data_modules.RandomAudioChunkDryWetDataModule", "init_args": {
            "batch_size": 32, "num_workers": 2, "train_num_examples_per_epoch": 512,
            "val_num_examples_per_epoch": 128, "n_samples": N_TBPTT, "sr": SR,
            "dry_train_dir": d["train"]["dry"], "dry_val_dir": d["val"]["dry"],
            "wet_train_dir": d["train"]["wet"], "wet_val_dir": d["val"]["wet"],
            # both CLIs drop the keys this module takes only through **kw
            # (its datasets then draw from seed 0, on float32 wire audio): a
            # port that passed them on would draw other examples
            "transfer_dtype": "int16", "device_corpus": True, "check_dataset": False, "seed": 5}},
        "model": {"class_path": "mod_extraction.lightning.TBPTTLFOEffectModeling", "init_args": {
            "warmup_n_samples": 1024, "step_n_samples": 1024,
            "effect_model": {"class_path": "mod_extraction.models.LSTMEffectModel",
                             "init_args": {"in_ch": 1, "out_ch": 1, "n_hidden": 8, "latent_dim": 1}},
            "lfo_model": {"class_path": "mod_extraction.models.Spectral2DCNN", "init_args": dict(TINY_EXTRACTOR)},
            "lfo_model_weights_path": extractor_weights, "freeze_lfo_model": True, "use_dry": True,
            "model_smooth_n_frames": 8, "should_stretch": True, "max_n_corners": 16,
            "discard_invalid_lfos": False, "loss_dict": {"l1": 1.0, "esr": 0.0, "dc": 0.0}}},
        "optimizer": {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-5, "betas": [0.8, 0.99]}},
    }


def write_config(tmp_path, name, cfg):
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def records(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "*_metrics.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_jax_fit(cfg_path, out_dir, monkeypatch):
    """The JAX package's `fit` on a one-device mesh."""
    from mod_extraction_tpu import cli as jcli
    from mod_extraction_tpu.parallel.mesh import make_mesh
    from mod_extraction_tpu.train import loop as jloop

    monkeypatch.setattr(jloop, "make_mesh", lambda: make_mesh(1))
    return jcli.fit(cfg_path, out_dir=out_dir)


def compare_logs(port_out, jax_out):
    p, j = records(port_out), records(jax_out)
    p_steps = [r for r in p if r["phase"] == "train_step"]
    j_steps = [r for r in j if r["phase"] == "train_step"]
    assert [r["step"] for r in p_steps] == [r["step"] for r in j_steps]
    for a, b in zip(p_steps, j_steps):
        assert math.isclose(a["loss"], b["loss"], rel_tol=LOSS_RTOL), (a, b)
        if "lr" in b:
            assert math.isclose(a["lr"], b["lr"], rel_tol=1e-6), (a["lr"], b["lr"])
    (pe,), (je,) = [r for r in p if r["phase"] == "epoch"], [r for r in j if r["phase"] == "epoch"]
    assert math.isclose(pe["val/loss"], je["val/loss"], rel_tol=LOSS_RTOL), (pe, je)
    return p_steps


@pytest.fixture(scope="module")
def lfo_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("lfo")
    corpus = str(root / "corpus")
    write_corpus(corpus)
    weights = jax_weights(str(root / "cnn.npz"), "cnn", N)
    return root, corpus, weights


def test_lfo_fit_matches_jax(lfo_setup, tmp_path, monkeypatch):
    root, corpus, weights = lfo_setup
    cfg_path = write_config(tmp_path, "lfo.yml", lfo_config(corpus, weights))
    task = tcli.fit(cfg_path, out_dir=str(tmp_path / "port"), device="cpu")
    state = run_jax_fit(cfg_path, str(tmp_path / "jax"), monkeypatch)
    steps = compare_logs(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the line after update u shows the lr of update u + 1: the warm-up's
    # end (the first update ran at lr 0)
    assert len(steps) == 3 and math.isclose(steps[0]["lr"], 1e-4, rel_tol=1e-6)
    want = flax_to_state_dict(jax_device_get(state.params))
    got = task.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    group = task.optimizer.param_groups[0]
    assert group["weight_decay"] == 0.01 and group["betas"] == (0.8, 0.99)
    assert math.isclose(group["lr"], tcli.build_lr(lfo_config(corpus, weights)["optimizer"])(3), rel_tol=1e-12)


def jax_device_get(tree):
    import jax

    return jax.device_get(tree)


def test_tbptt_fit_matches_jax(tmp_path, monkeypatch):
    corpus = str(tmp_path / "pairs")
    write_corpus(corpus, n_files=(2, 1), dur_s=1.5, wet=True)
    lstm = jax_weights(str(tmp_path / "lstm.npz"), "lstm", N_TBPTT)
    extractor = jax_weights(str(tmp_path / "extractor.npz"), "extractor", N_TBPTT)
    cfg_path = write_config(tmp_path, "tbptt.yml", tbptt_config(corpus, lstm, extractor))
    task = tcli.fit(cfg_path, out_dir=str(tmp_path / "port"), device="cpu")
    assert task.updates_per_batch == 5
    state = run_jax_fit(cfg_path, str(tmp_path / "jax"), monkeypatch)
    steps = compare_logs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(steps) == 1
    want = flax_lstm_to_state_dict(jax_device_get(state.params))
    got = task.effect_model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- the Trainer


def test_steps_per_dispatch_logs_every_step(lfo_setup, tmp_path):
    """`custom.steps_per_dispatch: 2` (which groups compiled steps in the
    JAX package, and has no effect in the port's Python loop) over three
    batches: one log record a step."""
    root, corpus, weights = lfo_setup
    cfg = lfo_config(corpus, weights, steps_per_dispatch=2)
    tcli.fit(cfg, out_dir=str(tmp_path), device="cpu")
    steps = [r for r in records(str(tmp_path)) if r["phase"] == "train_step"]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["audio_sec_per_sec"] > 0 for r in steps)


def test_profile_window(lfo_setup, tmp_path):
    """`custom.profile_dir` with `profile_steps=(1, 2)`: the iteration after
    the first step is profiled; its summary goes to the metric log and, with
    the device's busiest events and its spans, to `<run>_profile.json`
    beside the trace."""
    root, corpus, weights = lfo_setup
    cfg = lfo_config(corpus, weights, profile_dir=str(tmp_path / "prof"))
    tcli.fit(cfg, out_dir=str(tmp_path / "out"), device="cpu", profile_steps=(1, 2))
    recs = records(str(tmp_path / "out"))
    phases = [r["phase"] for r in recs]
    assert phases == ["train_step", "train_step", "profile", "train_step", "epoch"]
    prof = recs[2]
    assert prof["wall_ms"] > 0 and prof["device_busy_ms"] == 0.0 and prof["idle_share"] == 1.0
    assert prof["loader_wait_ms"] > 0 and prof["batch_copy_ms"] > 0
    (summary,) = glob.glob(str(tmp_path / "prof" / "*_profile.json"))
    with open(summary) as f:
        saved = json.load(f)
    assert saved["wall_ms"] == prof["wall_ms"] and saved["top_device_ms"] == []
    assert glob.glob(str(tmp_path / "prof" / "*_trace.json"))
    # the window's spans: its step and its loader wait, read from the span store, then cleared
    assert saved["spans"]["lfo.step"]["count"] == 1
    assert saved["spans"]["trainer.loader_wait"]["host_ms"] == prof["loader_wait_ms"]
    assert spans.records() == []


def test_resume_wins_over_warm_start_and_continues_the_steps(lfo_setup, tmp_path):
    root, corpus, weights = lfo_setup
    cfg = lfo_config(corpus, weights)
    out = str(tmp_path)
    first = tcli.fit(cfg, out_dir=out, device="cpu", max_epochs=1)
    trained = {k: v.clone() for k, v in first.model.state_dict().items()}
    ckpt_dir = os.path.join(out, "m__lfo_ckpts")
    assert sorted(os.listdir(ckpt_dir)) == ["best.json", "best.pt", "last.json", "last.pt", "meta.json"]
    # no epoch left to run: the resumed task holds `last`, not the warm start
    resumed = tcli.fit(cfg, out_dir=out, device="cpu", resume=True, max_epochs=1)
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert resumed.scheduler.last_epoch == first.scheduler.last_epoch == 3
    again = tcli.fit(cfg, out_dir=out, device="cpu", resume=True, max_epochs=2)
    steps = [r["step"] for r in records(out) if r["phase"] == "train_step"]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert again.scheduler.last_epoch == 6
    epochs = [r["epoch"] for r in records(out) if r["phase"] == "epoch"]
    assert epochs == [0, 1]
    # a fresh run (no resume) warm-starts from the .npz again
    fresh = tcli.fit(cfg, out_dir=str(tmp_path / "fresh"), device="cpu", max_epochs=0)
    want = flax_to_state_dict(weights)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_nan_loss_raises(lfo_setup, tmp_path, monkeypatch):
    from mod_extraction_tpu_torch.train.lfo_task import LFOExtractionTask

    root, corpus, weights = lfo_setup
    real = LFOExtractionTask.train_step

    def nan_step(self, batch, corpus=None, mask_draws=None):
        m = real(self, batch, corpus, mask_draws)
        return dict(m, loss=m["loss"] * float("nan"))

    monkeypatch.setattr(LFOExtractionTask, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tcli.fit(lfo_config(corpus, weights), out_dir=str(tmp_path), device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "m__lfo_ckpts", "last.pt"))


def test_validate_from_npz_and_from_last(lfo_setup, tmp_path, capsys):
    root, corpus, weights = lfo_setup
    cfg = lfo_config(corpus, weights)
    out = str(tmp_path)
    tcli.fit(cfg, out_dir=out, device="cpu")
    (epoch,) = [r for r in records(out) if r["phase"] == "epoch"]
    # `last` under the run's checkpoint directory, validated as the eval run
    last = os.path.join(out, "m__lfo_ckpts", "last.pt")
    from_last = tcli.validate(dict(cfg, ckpt_path=last), out_dir=out, device="cpu")
    assert math.isclose(from_last["loss"], epoch["val/loss"], rel_tol=1e-6)
    # the warm-start weights, before any update
    from_npz = tcli.validate(dict(cfg, ckpt_path=weights), out_dir=out, device="cpu")
    untrained = tcli.fit(cfg, out_dir=str(tmp_path / "untrained"), device="cpu", max_epochs=0)
    trainer = Trainer(untrained, untrained_dm(cfg), out_dir=str(tmp_path / "untrained"))
    assert math.isclose(from_npz["loss"], trainer.validate()["loss"], rel_tol=1e-6)
    assert set(from_npz) == set(from_last) and from_npz["loss"] != from_last["loss"]
    assert "val/loss" in capsys.readouterr().out


def untrained_dm(cfg):
    return tcli.RunConfig(cfg, device="cpu").data_module


def test_train_script_parses_as_the_jax_one():
    """`scripts/train_torch.py` takes the optional config of
    `scripts/train.py` (same default) plus `--device`."""
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    train, jax_train = load("train_torch"), load("train")
    assert train.parse_args([]).config == jax_train.config_name
    args = train.parse_args(["configs/train_em_sim_flanger_r7.yml", "--device", "cpu"])
    assert (args.config, args.device) == ("configs/train_em_sim_flanger_r7.yml", "cpu")
    assert train.parse_args(["x.yml"]).device == "cuda"
    validate, jax_validate = load("validate_torch"), load("validate")
    assert validate.parse_args([]).config == jax_validate.config_name
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "train_torch.py"), "--help"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "--device" in proc.stdout


def test_tbptt_use_dry_false_conditions_on_the_wet_signal_alone():
    """`use_dry: false`: the frozen extractor (one input channel) sees the
    wet signal alone, as in the JAX task; the smoothed, stretched LFO
    within 1e-5 (the tolerance of `tests/test_torch_tbptt_task.py`)."""
    import jax
    import jax.numpy as jnp

    from mod_extraction_tpu.models import LSTMEffectModel as JLSTM
    from mod_extraction_tpu.models import Spectral2DCNN as JSpectral2DCNN
    from mod_extraction_tpu.train.render import RenderConfig as JRenderConfig
    from mod_extraction_tpu.train.tbptt_task import TBPTTEffectModelingTask as JTask
    from mod_extraction_tpu_torch.data.synthetic import batch_to_torch, make_synthetic_batch
    from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    n = 8000
    tiny = dict(in_ch=1, n_samples=n, sr=float(SR), n_fft=256, hop_len=64, n_mels=16, out_channels=(4, 4),
                temp_dilations=(1, 2), pool_size=(2, 1))
    render = dict(sr=float(SR), n_samples=n, effects=(2,), max_delay_samples=89)
    task = dict(warmup_n_samples=512, step_n_samples=512, model_smooth_n_frames=8, should_stretch=True,
                discard_invalid_lfos=False, use_dry=False)
    j_lfo = JSpectral2DCNN(**tiny)
    j_params = j_lfo.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, n)))
    t_lfo = Spectral2DCNN(**tiny)
    t_lfo.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, j_params)))
    j_task = JTask(effect_model=JLSTM(n_hidden=8), render_cfg=JRenderConfig(**render), lfo_model=j_lfo,
                   lfo_params=j_params, lstm_impl="scan", **task)
    t_task = TBPTTEffectModelingTask(LSTMEffectModel(n_hidden=8), RenderConfig(**render), lfo_model=t_lfo,
                                     device="cpu", **task)
    batch = make_synthetic_batch(5, 3, n, float(SR), "flanger")
    got = t_task._prepare(batch_to_torch(batch, "cpu"))[3]
    want = jax.jit(lambda b, k: j_task._prepare(b, k)[3])(jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError):  # the dry signal would add the second channel
        TBPTTEffectModelingTask(LSTMEffectModel(n_hidden=8), RenderConfig(**render), lfo_model=t_lfo,
                                device="cpu", **dict(task, use_dry=True))._prepare(batch_to_torch(batch, "cpu"))
