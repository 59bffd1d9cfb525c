"""The port's lineage tools on the CPU: `scripts/train_resumable_torch.sh`
(`cli.fit` in chunks, each in a fresh process resuming from `last`) and
`scripts/export_best_torch.sh` (the best checkpoint, else `last`, to a bare
`.npz`), the counterparts of `scripts/train_resumable.sh` and
`scripts/export_best.sh`.

A tiny LFO-extraction config (a 2 x 4-channel f32 Spectral2DCNN, 16 mels,
flanger batches of 4 over 0.25 s clips at 8 kHz) trains two epochs in two
chunks; the second process must resume: two epoch records, the step count
carried over, and each process's launch counts logged.  The exported
weights must be the checkpoint's bit for bit and load in the port's
`Spectral2DCNN`.  The preflight's exit-code policy (a timeout warns and
carries on, another failure aborts, `SKIP_PARITY_GATE=1` skips it) is
driven through a stand-in interpreter that answers the card probe and the
kernel checks and runs everything else for real.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from mod_extraction_tpu_torch.data.wav import wav_write
from mod_extraction_tpu_torch.models.convert import flax_to_state_dict
from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(ROOT, "scripts", "train_resumable_torch.sh")
EXPORT = os.path.join(ROOT, "scripts", "export_best_torch.sh")
SR, N = 8000, 2000
RUN = "m__lineage"
TINY_CNN = dict(in_ch=2, n_fft=256, hop_len=64, n_mels=16, kernel_size=[3, 5], out_channels=[4, 4],
                temp_dilations=[1, 2], pool_size=[2, 1], freq_mask_amount=0.0, time_mask_amount=0.0,
                compute_dtype="float32")


def tiny_config(corpus: str) -> dict:
    flanger = {"dataset_name": "flanger_chorus", "fx_config": {
        "mod_sig": {"rate_hz": {"min": 0.5, "max": 3.0}, "phase": {"min": 0.0, "max": 6.28318530718},
                    "shapes": ["cos", "tri"], "exp": 1.0},
        "flanger": {"max_min_delay_ms": 1.0, "max_lfo_delay_ms": 10.0, "feedback": {"min": 0.0, "max": 0.7},
                    "min_delay_width": {"min": 0.0, "max": 1.0}, "width": {"min": 0.25, "max": 1.0},
                    "depth": {"min": 0.25, "max": 1.0}, "mix": {"min": 0.25, "max": 1.0}}}}
    return {
        "seed_everything": 3,
        "custom": {"model_name": "m", "dataset_name": "lineage", "cpu_batch_size": 4,
                   "cpu_train_num_examples_per_epoch": 8, "cpu_val_num_examples_per_epoch": 4,
                   "log_every_n_steps": 1},
        "trainer": {"max_epochs": 400},
        "data": {"class_path": "mod_extraction.data_modules.InterwovenDataModule", "init_args": {
            "batch_size": 99, "num_workers": 1,
            "shared_args": {"n_samples": N, "sr": SR, "ext": "wav", "silence_fraction_allowed": 0.1,
                            "silence_threshold_energy": 1e-4, "n_retries": 10, "check_dataset": True},
            "shared_train_args": {"input_dir": os.path.join(corpus, "train"), "num_examples_per_epoch": 800},
            "shared_val_args": {"input_dir": os.path.join(corpus, "val"), "num_examples_per_epoch": 200},
            "train_dataset_args": [flanger], "val_dataset_args": [flanger]}},
        "model": {"class_path": "mod_extraction.lightning.LFOExtraction", "init_args": {
            "use_dry": True, "model_smooth_n_frames": 4, "should_stretch": False,
            "loss_dict": {"l1": 1.0, "fdl1": 5.0, "sdl1": 10.0, "mse": 0.0},
            "model": {"class_path": "mod_extraction.models.Spectral2DCNN", "init_args": dict(TINY_CNN)}}},
        "optimizer": {"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-3}},
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("lineage")
    rng = np.random.default_rng(2)
    t = np.arange(int(1.5 * SR)) / SR
    for split, n in (("train", 3), ("val", 2)):
        os.makedirs(root / "corpus" / split)
        for i in range(n):
            x = 0.4 * np.sin(2 * np.pi * rng.uniform(80, 600) * t) + 0.05 * rng.standard_normal(len(t))
            wav_write(str(root / "corpus" / split / f"f{i}_120bpm.wav"), x.astype(np.float32), SR)
    cfg = root / "tiny.yml"
    cfg.write_text(yaml.safe_dump(tiny_config(str(root / "corpus"))))
    return root, str(cfg)


def run(cmd, env=None, timeout=300):
    full = {**os.environ, "PYTHON": sys.executable, **(env or {})}
    return subprocess.run(cmd, cwd=ROOT, env=full, capture_output=True, text=True, timeout=timeout)


def records(out_dir):
    with open(os.path.join(out_dir, f"{RUN}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(setup):
    """Two epochs in chunks of one: two processes, the second resuming."""
    root, cfg = setup
    out, log = root / "out", root / "launches.jsonl"
    proc = run([TRAIN, cfg, "2", "1"], env=dict(DEVICE="cpu", OUT_DIR=str(out), MODX_LAUNCH_LOG=str(log)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root, out, log, proc


def test_two_chunks_resume(trained):
    from mod_extraction_tpu_torch.ops.launches import read_launch_log

    root, out, log, proc = trained
    recs = records(str(out))
    assert [r["epoch"] for r in recs if r["phase"] == "epoch"] == [0, 1]
    assert [r["step"] for r in recs if r["phase"] == "train_step"] == [1, 2, 3, 4]
    assert "preflight" not in proc.stdout  # DEVICE=cpu: no card to check
    counts = read_launch_log(str(log))
    assert len(counts) == 2  # one line a chunk process
    assert all(set(c.values()) == {0} and "flanger" in c and "lstm_backward" in c for c in counts)
    assert sorted(os.listdir(out / f"{RUN}_ckpts")) == ["best.json", "best.pt", "last.json", "last.pt", "meta.json"]
    assert json.loads((out / f"{RUN}_ckpts" / "last.json").read_text()) == {"epoch": 1, "step": 4}
    # a third call with start 2 has no chunk left: nothing runs
    again = run([TRAIN, "/no/such/config.yml", "2", "1", "2"], env=dict(DEVICE="cpu", OUT_DIR=str(out)))
    assert again.returncode == 0 and len(records(str(out))) == len(recs)


def export_and_load(out, npz, ckpt_name):
    proc = run([EXPORT, RUN, str(npz)], env=dict(OUT_DIR=str(out)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[0] == f"exporting {RUN} from {out}/{RUN}_ckpts/{ckpt_name}"
    model = Spectral2DCNN(n_samples=N, sr=SR, **{k: tuple(v) if isinstance(v, list) else v
                                                 for k, v in TINY_CNN.items()})
    model.load_state_dict(flax_to_state_dict(str(npz)))
    state = torch.load(out / f"{RUN}_ckpts" / ckpt_name, map_location="cpu", weights_only=False)["task"]["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k].float()), k
    return model


def test_export_best_then_last(trained):
    root, out, _, _ = trained
    export_and_load(out, root / "best.npz", "best.pt")
    ckpts = out / f"{RUN}_ckpts"
    os.rename(ckpts / "best.pt", ckpts / "kept.pt")
    try:
        export_and_load(out, root / "last.npz", "last.pt")
    finally:
        os.rename(ckpts / "kept.pt", ckpts / "best.pt")


FAKE_PYTHON = """#!/bin/bash
# stands in for the interpreter: a card is present, the kernel checks end
# with $GATE_RC, everything else runs on the real interpreter
case "$*" in
  *cuda.is_available*) echo 1 ;;
  *"-m pytest"*) echo "kernel checks: rc $GATE_RC"; exit "$GATE_RC" ;;
  *) exec "{python}" "$@" ;;
esac
"""


@pytest.mark.parametrize("gate_rc,skip,want", [
    (0, "0", "ran"), (124, "0", "warned"), (3, "0", "aborted"), (3, "1", "skipped")])
def test_preflight_policy(setup, tmp_path, gate_rc, skip, want):
    """With a card the preflight runs the kernel checks first: rc 0 goes on,
    124 warns and goes on, another code aborts with it, and
    SKIP_PARITY_GATE=1 skips the checks.  Going on reaches the chunk, whose
    fit then finds no card here and fails."""
    root, cfg = setup
    fake = tmp_path / "python"
    fake.write_text(FAKE_PYTHON.format(python=sys.executable))
    fake.chmod(0o755)
    proc = run([TRAIN, cfg, "1", "1"], env=dict(PYTHON=str(fake), GATE_RC=str(gate_rc),
                                                SKIP_PARITY_GATE=skip, OUT_DIR=str(tmp_path / "out")))
    checked = f"kernel checks: rc {gate_rc}" in proc.stdout
    reached_fit = "CUDA was requested" in proc.stderr
    assert proc.returncode != 0
    if want == "aborted":
        assert checked and f"kernel checks FAILED (rc={gate_rc})" in proc.stdout
        assert proc.returncode == gate_rc and not reached_fit
    else:
        assert checked == (want != "skipped") and reached_fit, proc.stdout + proc.stderr
        assert ("WARNING" in proc.stdout) == (want == "warned")
    assert not (tmp_path / "out").exists()


def test_tools_name_no_jax():
    """The shell tools run the port only: no JAX module, no JAX script, no
    JAX compile cache."""
    for path in (TRAIN, EXPORT):
        text = open(path).read()
        assert "mod_extraction_tpu_torch" in text or "extract_torch_weights.py" in text
        for word in ("import jax", "mod_extraction_tpu.", "JAX_", "tpu_parity_gate", "extract_model_weights"):
            assert word not in text, (path, word)
