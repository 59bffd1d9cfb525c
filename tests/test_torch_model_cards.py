"""The port's model-card writer (`scripts/write_model_cards_torch.py`)
against the JAX script (`scripts/write_model_cards.py`) on the CPU: the
same registry, the same card for every shipped stem, the same files and
exit code from `main`, and the four contracts of `tests/test_model_cards.py`
with the metrics log written by the port's `MetricLogger`.  Cards are
compared exactly (dicts and file bytes); nothing is written into the
repo's `models/`.
"""

import contextlib
import glob
import importlib.util
import io
import os
import runpy
import shutil
import sys

import pytest

from mod_extraction_tpu_torch.train.loop import MetricLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = "lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r5"


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = load_script("write_model_cards_torch")
JAX = load_script("write_model_cards")
STEMS = sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(ROOT, "models", "*.npz")))


@pytest.fixture
def repo_without_out(tmp_path, monkeypatch):
    """A working directory holding the repo's configs and models and no
    `out/` (the training runs' metrics are gone)."""
    for d in ("configs", "models"):
        os.symlink(os.path.join(ROOT, d), tmp_path / d)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_registry_is_the_jax_scripts():
    assert PORT.REGISTRY == JAX.REGISTRY
    assert PORT.REFERENCE_IMPORTS == JAX.REFERENCE_IMPORTS
    assert (PORT.R2_EXTRACTOR, PORT.R3_EXTRACTOR, PORT.R4_EXTRACTOR) == \
        (JAX.R2_EXTRACTOR, JAX.R3_EXTRACTOR, JAX.R4_EXTRACTOR)


def test_every_shipped_npz_has_a_registered_card():
    assert STEMS
    assert [s for s in STEMS if s not in PORT.REGISTRY and s not in PORT.REFERENCE_IMPORTS] == []


def test_build_card_equals_jax_for_every_shipped_stem(repo_without_out):
    for stem in STEMS + ["not_a_registered_stem"]:
        assert PORT.build_card(stem) == JAX.build_card(stem), stem


def test_final_epoch_metrics_reads_the_port_metric_log(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    logger = MetricLogger("out", "run", tensorboard=False)
    with contextlib.redirect_stdout(io.StringIO()):
        logger.log({"phase": "train_step", "step": 1, "loss": 9.0})
        logger.log({"phase": "epoch", "epoch": 0, "step": 1, "val/loss": 0.5, "val/l1": 0.4})
        logger.log({"phase": "epoch", "epoch": 1, "step": 2, "val/loss": 0.3, "val/l1": 0.2})
    rec = PORT.final_epoch_metrics("run")
    assert rec == JAX.final_epoch_metrics("run")
    assert rec["epoch"] == 1 and rec["val/loss"] == 0.3
    assert PORT.final_epoch_metrics("absent_run") is None


def test_existing_card_metrics_survive_missing_out_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    with open("models/stem.yml", "w") as f:
        f.write("name: stem\nepochs_trained: 25\nfinal_val_metrics:\n  loss: 0.123\n  l1: 0.1\n")
    assert PORT.existing_card_metrics("stem") == (25, {"loss": 0.123, "l1": 0.1})
    assert PORT.existing_card_metrics("other") == (None, None)


def test_r5_card_pins_best_val_loss(repo_without_out):
    card = PORT.build_card(R5)
    assert card["best_val_loss"] == PORT.REGISTRY[R5]["best_val_loss"]
    assert card["train_config"] == "configs/train_lfo_interwoven_all_live_r5.yml"


def test_main_writes_the_jax_cards_and_exits_1_on_an_unregistered_stem(repo_without_out):
    """Both scripts on a temporary models dir holding three shipped stems (a
    trained extractor, an imported reference LSTM, a stage-2 model) and an
    unregistered one: the same cards byte for byte, the same lines, exit 1."""
    picks = [R5, next(iter(PORT.REFERENCE_IMPORTS)),
             next(s for s in STEMS if "parent_extractor" in PORT.REGISTRY.get(s, {}))]
    outs = {}
    for name in ("port", "jax"):
        d = repo_without_out / f"cards_{name}"
        d.mkdir()
        for stem in picks:
            shutil.copyfile(os.path.join(ROOT, "models", f"{stem}.npz"), d / f"{stem}.npz")
        (d / "unknown_stem.npz").write_bytes(b"")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            if name == "port":
                rc = PORT.main([str(d)])
            else:
                sys_argv = sys.argv
                sys.argv = ["write_model_cards.py", str(d)]
                try:
                    runpy.run_path(os.path.join(ROOT, "scripts", "write_model_cards.py"), run_name="__main__")
                    rc = 0
                except SystemExit as e:
                    rc = e.code
                finally:
                    sys.argv = sys_argv
        outs[name] = (rc, out.getvalue().replace(f"cards_{name}", "cards"), err.getvalue(),
                      {p.name: p.read_bytes() for p in sorted(d.glob("*.yml"))})
    assert outs["port"] == outs["jax"]
    rc, printed, err, cards = outs["port"]
    assert rc == 1 and "NO CARD REGISTERED for: ['unknown_stem']" in err
    assert sorted(cards) == sorted(f"{s}.yml" for s in picks) and len(printed.splitlines()) == 3
    assert all(c.startswith(b"# Model card (reference models/*.yml convention)") for c in cards.values())
