"""The port's data-preparation scripts against the JAX scripts on the CPU:
`make_synthetic_corpus_torch.py`, `split_datasets_torch.py`,
`generate_preproc_datasets_torch.py` and
`measure_phaser_warmup_delta_torch.py`.

Tolerances: the corpus, the IDMT split's files, the EGFx copies and the
dry WAVs byte for byte (the same numpy draws and the same PCM16 writer);
resampled and wet WAVs within 1 PCM16 step (the float32 renders agree to
about 1e-7, so a sample may round to the neighbouring step); `mod_sig`
within 1e-6 and `fx_params` equal; the warm-up script's cold and warm l1
within 1e-4 relative, in float32 convs (both scripts take the model
config's dtype; bf16 convs round at other places in the two frameworks).
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from mod_extraction_tpu_torch.data.wav import wav_read, wav_write

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSB = 1  # PCM16 steps
MOD_TOL = 1e-6
L1_RTOL = 1e-4


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(module_main, argv, monkeypatch):
    """A script's `main()` with `sys.argv` set to [script] + argv; its
    printed lines."""
    monkeypatch.setattr(sys, "argv", ["script"] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module_main()
    return out.getvalue().splitlines()


def run_jax_main_block(name, argv, monkeypatch):
    """A JAX script whose work sits under `if __name__ == "__main__":`, run
    as `python scripts/<name>.py argv...`."""
    import runpy

    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(ROOT, "scripts", f"{name}.py"), run_name="__main__")
    return out.getvalue().splitlines()


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def pcm16(path):
    with open(path, "rb") as f:
        data = f.read()
    return data[:44], np.frombuffer(data[44:], "<i2").astype(np.int64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- synthetic corpus


@pytest.mark.parametrize("style", ["riffs", "pads"])
def test_make_synthetic_corpus_is_byte_equal_to_jax(style, tmp_path, monkeypatch):
    port, jax = load_script("make_synthetic_corpus_torch"), load_script("make_synthetic_corpus")
    lines = {}
    for name, mod in (("port", port), ("jax", jax)):
        lines[name] = run_main(mod.main, [str(tmp_path / name), "2", "1", "2.0", "--style", style], monkeypatch)
    assert [line.replace("/port/", "/x/") for line in lines["port"]] == \
        [line.replace("/jax/", "/x/") for line in lines["jax"]]
    files = tree_files(tmp_path / "port")
    assert files == tree_files(tmp_path / "jax") and len(files) == 3
    assert all(f.split(os.sep)[-1].startswith(f"{style}_") and f.endswith("bpm.wav") for f in files)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_make_synthetic_corpus_argv_matches_jax():
    port = load_script("make_synthetic_corpus_torch")
    assert port.parse_argv([]) == ("data/idmt_4", 32, 8, 12.0, "riffs")
    assert port.parse_argv(["o", "3", "--style", "keys", "0", "1.5"]) == ("o", 3, 0, 1.5, "keys")


# ------------------------------------------------------------------- splits

IDMT_SR = 500  # a low rate keeps 512 files at about 4 MB
IDMT_SECONDS = 8.0  # longer than three bars at the slowest tempo below (7.2 s)
# 64 songs; `song_02` is a substring of `song_029`, and seed 42 draws
# `song_02` for val and not `song_029`
IDMT_SONGS = [f"song_{k:02d}" for k in range(62)] + ["song_029", "zz_0"]


def fabricate_idmt(root):
    rng = np.random.default_rng(0)
    for s, source in enumerate(("acoustic_mic", "acoustic_pickup", "Career SG", "Ibanez 2820")):
        d = os.path.join(root, source, "sub")  # files are collected recursively
        os.makedirs(d)
        for k, song in enumerate(IDMT_SONGS):
            for take in ("a", "b"):
                bpm = (100, 120, 140)[(k + s) % 3]
                x = (0.5 * rng.uniform(-1, 1, int(IDMT_SECONDS * IDMT_SR))).astype(np.float32)
                wav_write(os.path.join(d, f"{song}_{take}_{bpm}bpm.wav"), x, IDMT_SR)


def test_split_idmt_matches_jax(tmp_path, monkeypatch):
    port, jax = load_script("split_datasets_torch"), load_script("split_datasets")
    lines = {}
    for name, mod in (("port", port), ("jax", jax)):
        fabricate_idmt(str(tmp_path / name))
        lines[name] = run_main(lambda: mod.split_idmt_4(str(tmp_path / name)), [], monkeypatch)
    assert [line.replace("/port/", "/x/") for line in lines["port"]] == \
        [line.replace("/jax/", "/x/") for line in lines["jax"]]
    split = {}
    for name in ("port", "jax"):
        split[name] = {s: sorted(os.listdir(tmp_path / name / s)) for s in ("train", "val")}
    assert split["port"] == split["jax"]
    val, train = split["port"]["val"], split["port"]["train"]
    assert len(val) + len(train) == 512
    for s in ("train", "val"):
        for f in split["port"][s]:
            assert (tmp_path / "port" / s / f).read_bytes() == (tmp_path / "jax" / s / f).read_bytes(), f
    # the substring routing both scripts share: `song_029` was not drawn,
    # and its files go to val with `song_02`'s
    assert sum("__song_02_" in f for f in val) == 8 and sum("__song_029_" in f for f in val) == 8
    assert len(val) == 17 * 8
    # three bars trimmed at the parsed tempo
    audio, sr = wav_read(str(tmp_path / "port" / "train" / train[0]))
    bpm = int(train[0].split("_")[-1][:-7])
    assert sr == IDMT_SR and audio.shape[-1] == int(IDMT_SECONDS * IDMT_SR) - int(4 * 60 / bpm * 3 * IDMT_SR)


def fabricate_egfx(root):
    """Three effect directories of 20 files, the same names in each; two at
    48 kHz, one at 44.1 kHz."""
    rng = np.random.default_rng(1)
    for effect, sr in (("Chorus", 48000), ("Clean", 48000), ("Flanger", 44100)):
        os.makedirs(os.path.join(root, effect))
        for i in range(20):
            x = (0.6 * np.sin(np.arange(3000) * rng.uniform(0.01, 0.3)) + 0.1 * rng.standard_normal(3000))
            wav_write(os.path.join(root, effect, f"{i + 1}-{i % 4}.wav"), x.astype(np.float32), sr)


def test_split_egfx_matches_jax(tmp_path, monkeypatch):
    port, jax = load_script("split_datasets_torch"), load_script("split_datasets")
    lines = {}
    for name, split in (("port", lambda r: port.split_egfx(r, device="cpu")), ("jax", jax.split_egfx)):
        fabricate_egfx(str(tmp_path / name))
        lines[name] = run_main(lambda: split(str(tmp_path / name)), [], monkeypatch)
    assert lines["port"] == lines["jax"] == ["split Chorus", "split Clean", "split Flanger"]
    files = tree_files(tmp_path / "port")
    assert files == tree_files(tmp_path / "jax")
    for split, n in (("train", 15), ("val", 3), ("test", 2)):  # int(0.18 * 20), int(0.12 * 20)
        sizes = {len(os.listdir(tmp_path / "port" / split / e)) for e in ("Chorus", "Clean", "Flanger")}
        assert sizes == {n}, (split, sizes)
    worst = 0
    for f in files:
        split, effect, name = (f.split(os.sep) + [None])[:3]
        if name is None:
            continue  # a source file
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if effect == "Flanger":  # already at 44.1 kHz: copied
            assert a.read_bytes() == b.read_bytes() == (tmp_path / "port" / effect / name).read_bytes()
            continue
        (ha, xa), (hb, xb) = pcm16(a), pcm16(b)
        assert ha == hb and xa.shape == xb.shape == (2757,)  # ceil(3000 * 147 / 160) at 44.1 kHz
        worst = max(worst, int(np.abs(xa - xb).max()))
    assert worst <= LSB


# --------------------------------------------------------- preproc triplets


def gen_config(tmp_path, corpus):
    """`configs/data/gen_idmt_fl.yml` on `corpus`, at batch 4."""
    with open(os.path.join(ROOT, "configs", "data", "gen_idmt_fl.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["init_args"].update(batch_size=4, train_dir=str(corpus / "train"), val_dir=str(corpus / "val"))
    path = tmp_path / "gen_fl.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three train and two val riffs of 3 s (`data/synthetic.py`)."""
    from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus

    root = tmp_path_factory.mktemp("riffs")
    write_synthetic_corpus(str(root), 3, 2, 3.0)
    return root


def test_generate_preproc_matches_jax(corpus, tmp_path, monkeypatch):
    from mod_extraction_tpu.data.datasets import PreprocessedDataset as JaxPreprocessed

    from mod_extraction_tpu_torch.data.datasets import PreprocessedDataset

    port = load_script("generate_preproc_datasets_torch")
    cfg = gen_config(tmp_path, corpus)
    lines = {"port": run_main(port.main, [cfg, str(tmp_path / "port"), "8", "--device", "cpu"], monkeypatch),
             "jax": run_jax_main_block("generate_preproc_datasets", [cfg, str(tmp_path / "jax"), "8"], monkeypatch)}
    assert lines["port"] == lines["jax"] == ["4 examples written", "8 examples written"]
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == 24
    worst_lsb, worst_mod = 0, 0.0
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith("_dry.wav"):
            assert a.read_bytes() == b.read_bytes(), f
        elif f.endswith("_wet.wav"):
            (ha, xa), (hb, xb) = pcm16(a), pcm16(b)
            assert ha == hb
            worst_lsb = max(worst_lsb, int(np.abs(xa - xb).max()))
        else:
            pa, pb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            assert pa["mod_sig"].dtype == pb["mod_sig"].dtype == np.float32
            assert pa["mod_sig"].shape == pb["mod_sig"].shape == (882,)
            worst_mod = max(worst_mod, float(np.abs(pa["mod_sig"] - pb["mod_sig"]).max()))
            assert pa["fx_params"].item() == pb["fx_params"].item(), f
    assert worst_lsb <= LSB and worst_mod <= MOD_TOL
    # each package's dataset reads the other's output
    for ours, theirs in ((PreprocessedDataset, "jax"), (JaxPreprocessed, "port")):
        own = "port" if theirs == "jax" else "jax"
        read_theirs = ours(str(tmp_path / theirs), 88200, 44100)
        read_own = ours(str(tmp_path / own), 88200, 44100)
        assert len(read_theirs) == len(read_own) == 8
        for i in range(8):
            x, y = read_theirs.getitem(0, i), read_own.getitem(0, i)
            assert np.array_equal(x["dry"], y["dry"])
            assert np.abs(x["wet"] - y["wet"]).max() <= LSB / 32768 + 1e-9
            assert np.abs(x["mod_sig"] - y["mod_sig"]).max() <= MOD_TOL
            assert x["fx"] == y["fx"]


def test_generate_preproc_keeps_the_jax_argv():
    port = load_script("generate_preproc_datasets_torch")
    calls = []
    port.generate = lambda *a: calls.append(a) or 0
    port.main(["c.yml", "out"])
    port.main(["c.yml", "out", "16", "--device", "cpu"])
    assert calls == [("c.yml", "out", None, "cuda"), ("c.yml", "out", 16, "cpu")]


# ------------------------------------------------------ phaser warm-up delta


def test_measure_phaser_warmup_delta_matches_jax(corpus, tmp_path, monkeypatch):
    """Both scripts at batch 2 on the same val riffs, float32 convs."""
    from mod_extraction_tpu import cli as jcli

    port = load_script("measure_phaser_warmup_delta_torch")
    jax = load_script("measure_phaser_warmup_delta")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = port.main(src=str(corpus / "val"), batch=2, device="cpu", compute_dtype="float32")
    # the JAX script reads data/idmt_4/val, configs/ and models/ from the
    # working directory, at its module's BATCH, in the config's conv dtype
    (tmp_path / "data" / "idmt_4").mkdir(parents=True)
    os.symlink(corpus / "val", tmp_path / "data" / "idmt_4" / "val")
    for d in ("configs", "models"):
        os.symlink(os.path.join(ROOT, d), tmp_path / d)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "BATCH", 2)
    build = jcli.build_model

    def float32_convs(cfg, links, *a, **k):
        return build(dict(cfg, init_args=dict(cfg["init_args"], compute_dtype="float32")), links, *a, **k)

    monkeypatch.setattr(jcli, "build_model", float32_convs)
    # its printed line has five decimals: record the jitted l1's values
    import jax as jax_lib

    jit, values = jax_lib.jit, []

    def recorded(fn):
        compiled = jit(fn)
        return lambda *a: values.append(float(compiled(*a))) or values[-1]

    monkeypatch.setattr(jax_lib, "jit", recorded)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jax.main()
    line = jout.getvalue().strip()
    assert line.startswith("phaser warmup extractor delta: cold l1=") and len(values) == 2
    assert out.getvalue().strip() == (
        f"phaser warmup extractor delta: cold l1={got[0]:.5f} warm l1={got[1]:.5f} "
        f"|delta|={abs(got[0] - got[1]):.6f}")
    for g, w in zip(got, values):
        assert abs(g - w) <= L1_RTOL * abs(w), (got, values)
