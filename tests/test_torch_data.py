"""The port's host data pipeline (`mod_extraction_tpu_torch/data/`,
`native.py`) against the JAX package's, bit for bit: wav files written by
both, chunk reads at offsets, every mod-signal generator, the device
corpus, the native library, and every data module a shipped config names,
built from that config's init_args (its directories pointed at a corpus
written here, its sizes cut to two train batches and one val batch), whose
batches and corpus must be `np.array_equal`."""

import dataclasses
import filecmp
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mod_extraction_tpu.data import mods as jmods
from mod_extraction_tpu.data import wav as jwav
from mod_extraction_tpu_torch.cli import load_yaml_with_includes
from mod_extraction_tpu_torch.data import mods as tmods
from mod_extraction_tpu_torch.data import wav as twav
from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus
from mod_extraction_tpu_torch.paths import CONFIGS_DIR

SR = 44100
N_TRAIN, N_VAL, BATCH = 8, 4, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the suite runs in
    several processes at once, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), where


# ------------------------------------------------------------------ wav, mods


@pytest.mark.parametrize("bits", [16, 32])
def test_wav_write_is_byte_equal_and_reads_match_at_offsets(tmp_path, monkeypatch, bits):
    rng = np.random.default_rng(1)
    audio = (0.6 * rng.standard_normal((2, 5001))).clip(-1, 1).astype(np.float32)
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jwav.wav_write(pj, audio, 22050, bits=bits)
    twav.wav_write(pt, audio, 22050, bits=bits)
    assert filecmp.cmp(pj, pt, shallow=False)
    assert dataclasses.asdict(twav.wav_info(pt)) == dataclasses.asdict(jwav.wav_info(pj))
    from mod_extraction_tpu import native as jnative
    from mod_extraction_tpu_torch import native as tnative

    for numpy_path in (False, True):  # the C++ fast path where built, then the numpy decoder
        if numpy_path:
            for mod in (jnative, tnative):
                monkeypatch.setattr(mod, "_tried", True)
                monkeypatch.setattr(mod, "_lib", None)
        for off, n in ((0, -1), (0, 100), (123, 1000), (4990, 50), (5001, 10)):
            got, want = twav.wav_read(pt, off, n), jwav.wav_read(pj, off, n)
            assert got[1] == want[1]
            assert_tree_equal(got[0], want[0], f"offset {off} n {n}")
    mono = audio[0]
    jwav.wav_write(pj, mono, SR)
    twav.wav_write(pt, mono, SR)
    assert filecmp.cmp(pj, pt, shallow=False)


def test_mods_functions_match(tmp_path):
    x = np.random.default_rng(0).uniform(size=37).astype(np.float32)
    for n in (1, 10, 37, 100):
        assert_tree_equal(tmods.np_linear_interp(x, n), jmods.np_linear_interp(x, n))
    assert tmods.LFO_SHAPES == jmods.LFO_SHAPES
    for shape in tmods.LFO_SHAPES:
        for exp in (1.0, 0.5, 2.3):
            args = (882, 441.0, 1.7, 0.4, shape, exp)
            assert_tree_equal(tmods.np_make_mod_signal(*args), jmods.np_make_mod_signal(*args), shape)
            m = jmods.np_make_mod_signal(*args)
            assert_tree_equal(tmods.np_find_corners(m), jmods.np_find_corners(m), shape)
    for seed in range(12):
        shape = tmods.LFO_SHAPES[seed % 6]
        m = jmods.np_make_mod_signal(882, 441.0, 0.5 + seed / 4, seed / 3, shape)
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        assert_tree_equal(tmods._time_stretch_section(r_t, m[:50], 0.1, 0.3, 0.1, 0.4, 0.5),
                          jmods._time_stretch_section(r_j, m[:50], 0.1, 0.3, 0.1, 0.4, 0.5))
        assert_tree_equal(tmods.make_quasi_periodic(r_t, m, 0.1, 0.3, 0.2, 0.5, 0.4),
                          jmods.make_quasi_periodic(r_j, m, 0.1, 0.3, 0.2, 0.5, 0.4), seed)
        assert_tree_equal(tmods.make_concave_convex_mod_sig(r_t, 882, 441.0, 1.3, seed / 2),
                          jmods.make_concave_convex_mod_sig(r_j, 882, 441.0, 1.3, seed / 2), seed)
        shapes = ["cos", "tri", "saw", "rsaw"]
        assert_tree_equal(tmods.make_combined_mod_sig(r_t, 882, 441.0, 2.1, seed / 5, shapes),
                          jmods.make_combined_mod_sig(r_j, 882, 441.0, 2.1, seed / 5, shapes), seed)
        assert r_t.uniform() == r_j.uniform()  # the same number of draws


# ------------------------------------------------------- corpus, native


def test_synthetic_corpus_is_byte_equal(tmp_path, monkeypatch):
    """`write_synthetic_corpus` writes the files of
    `scripts/make_synthetic_corpus.py`, byte for byte."""
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", os.path.join(os.path.dirname(CONFIGS_DIR), "scripts", "make_synthetic_corpus.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["make_synthetic_corpus.py", str(tmp_path / "jax"), "2", "1", "1.5"])
    script.main()
    ours = write_synthetic_corpus(str(tmp_path / "port"), n_train=2, n_val=1, dur_s=1.5)
    theirs = sorted(glob.glob(str(tmp_path / "jax" / "*" / "*.wav")))
    assert [os.path.relpath(p, tmp_path / "port") for p in sorted(ours)] == \
        [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(sorted(ours), theirs))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_data_root(tmp_path_factory.mktemp("data"))


def write_data_root(root):
    """A riff corpus, dry/wet pairs named alike, and preprocessed triplets."""
    write_synthetic_corpus(str(root / "corpus"), n_train=3, n_val=2, dur_s=3.0)
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        for p in sorted(glob.glob(str(root / "corpus" / split / "*.wav"))):
            dry, _ = twav.wav_read(p)
            wet = np.tanh(2.0 * dry + 0.3 * np.roll(dry, 17, axis=-1)).astype(np.float32)
            for side, a in (("dry", dry), ("wet", wet)):
                os.makedirs(root / "pairs" / split / side, exist_ok=True)
                twav.wav_write(str(root / "pairs" / split / side / os.path.basename(p)), a, SR)
        os.makedirs(root / "preproc" / split)
        for i in range(3):
            base = str(root / "preproc" / split / f"{split}{i:03d}")
            mod = rng.uniform(size=882).astype(np.float32)
            np.savez(base + ".npz", mod_sig=mod, fx_params={
                "rate_hz": 1.5 + i, "shape": "tri", "feedback": 0.25, "ignored": 3.0})
            for side in ("dry", "wet"):
                twav.wav_write(f"{base}_{side}.wav", rng.uniform(-0.5, 0.5, 88200).astype(np.float32), SR)
    return root


def test_corpus_index_builds_the_same_array(data_root):
    from mod_extraction_tpu.data.corpus import CorpusIndex as JIndex
    from mod_extraction_tpu_torch.data.corpus import CorpusIndex as TIndex

    paths = sorted(glob.glob(str(data_root / "pairs" / "*" / "*" / "*.wav")))
    t, j = TIndex(paths), JIndex(paths)
    assert t.base == j.base and t.meta == j.meta and t.total_samples == j.total_samples
    assert_tree_equal(t.build_array(), j.build_array())
    assert t.global_index(paths[2], 0, 17) == j.global_index(paths[2], 0, 17)


def test_native_library_matches_the_jax_one(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library cannot be built")
    from mod_extraction_tpu import native as jnative
    from mod_extraction_tpu_torch import native as tnative

    assert tnative.available() and jnative.available()
    assert os.path.dirname(tnative._SO).endswith(os.path.join("mod_extraction_tpu_torch", "_build"))
    rng = np.random.default_rng(3)
    path = str(tmp_path / "x.wav")
    twav.wav_write(path, (0.4 * rng.standard_normal((2, 5000))).astype(np.float32), 22050)
    for off, n in ((0, 10), (123, 1000), (4000, 1000)):
        assert_tree_equal(tnative.wav_read_chunk(path, off, n)[0], jnative.wav_read_chunk(path, off, n)[0])
    chunk = (rng.standard_normal((1, 4000)) * np.repeat([1, 1e-4, 1], [1500, 1000, 1500])).astype(np.float32)
    for w, hop, thr in ((400, 100, 1e-6), (1000, 250, 1e-4), (4000, 1000, 1e-2)):
        assert tnative.silence_scan(chunk, w, hop, thr) == jnative.silence_scan(chunk, w, hop, thr)


# ------------------------------------------------------------ data modules


def _data_blocks():
    """(case id, data block): one case per distinct data block of the shipped
    configs, directories and sizes aside."""
    out, seen = [], set()
    for path in sorted(glob.glob(os.path.join(CONFIGS_DIR, "*.yml"))):
        cfg = load_yaml_with_includes(path)
        data = cfg.get("data")
        if "model" not in cfg or not isinstance(data, dict):
            continue
        args = dict(data.get("init_args") or {})
        key_args = {k: v for k, v in args.items()
                    if not k.endswith("_dir") and "num_examples" not in k}
        key = json.dumps([data["class_path"], key_args], sort_keys=True, default=str)
        if key not in seen:
            seen.add(key)
            case = f"{data['class_path'].rsplit('.', 1)[-1]}-{os.path.basename(path)[:-4]}"
            out.append(pytest.param(data, id=case))
    return out


DATA_BLOCKS = _data_blocks()


def _redirect(data, root):
    """The block's init_args, pointed at the corpus here, with two train
    batches and one val batch of BATCH."""
    args = json.loads(json.dumps(data.get("init_args") or {}))
    preproc = "Preprocessed" in data["class_path"]
    for k in list(args):
        if not k.endswith("_dir"):
            continue
        split = "val" if "val" in k else "train"
        if k.startswith(("dry_", "wet_")):
            args[k] = str(root / "pairs" / split / k.split("_")[0])
        else:
            args[k] = str(root / ("preproc" if preproc else "corpus") / split)
    args["batch_size"] = BATCH
    for k, v in (("train_num_examples_per_epoch", N_TRAIN), ("val_num_examples_per_epoch", N_VAL)):
        if k in args or preproc:
            args[k] = v
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        shared = args.get(f"shared_{split}_args")
        if shared is not None:
            shared["num_examples_per_epoch"] = n
            if "input_dir" in shared:
                shared["input_dir"] = str(root / "corpus" / split)
        for ds in args.get(f"{split}_dataset_args") or []:
            if "input_dir" in ds:
                pre = ds["dataset_name"] in ("preproc", "random_preproc")
                ds["input_dir"] = str(root / ("preproc" if pre else "corpus") / split)
    return args


def _mixes_wet_and_rendered(args) -> bool:
    """An interwoven block whose examples come with and without a wet chunk
    (preprocessed triplets beside rendered effects)."""
    names = {ds["dataset_name"] for ds in args.get("train_dataset_args") or []}
    return bool(names & {"preproc", "random_preproc"}) and bool(names - {"preproc", "random_preproc"})


@pytest.mark.parametrize("data", DATA_BLOCKS)
def test_data_module_batches_are_bit_equal(data, data_root):
    """Same batches from the same init_args and seed.  A batch mixing
    examples with and without a wet chunk (`train_lfo_interwoven_all.yml`)
    fails to collate in both packages; the port's threaded loader raises
    it where the JAX package's blocks, so the JAX side is read inline."""
    from mod_extraction_tpu.data.modules import get_data_module_class as jget
    from mod_extraction_tpu_torch.data.modules import get_data_module_class as tget

    args = _redirect(data, data_root)
    args.setdefault("seed", 17)
    if _mixes_wet_and_rendered(args):
        failures = []
        for get, workers in ((jget, 1), (tget, 1), (tget, 4)):
            dm = get(data["class_path"])(**dict(json.loads(json.dumps(args)), num_workers=workers))
            dm.setup("fit")
            with pytest.raises(KeyError) as err:
                list(dm.train_loader().epoch(0))
            failures.append(str(err.value))
        assert failures == ["'wet'"] * 3
        return
    modules = []
    for get in (jget, tget):
        cls = get(data["class_path"])
        dm = cls(**json.loads(json.dumps(args)))
        dm.setup("fit")
        modules.append(dm)
    j, t = modules
    assert type(t).__name__ == type(j).__name__
    assert t.render_cfg.sr == j.render_cfg.sr and t.render_cfg.n_samples == j.render_cfg.n_samples
    assert (t.render_cfg.effects, t.render_cfg.max_delay_samples) == (j.render_cfg.effects, j.render_cfg.max_delay_samples)
    assert getattr(t.render_cfg, "audio_as_wet") == getattr(j.render_cfg, "audio_as_wet")
    jc, tc = j.corpus_payload(), t.corpus_payload()
    assert (jc is None) == (tc is None)
    if tc is not None:
        assert_tree_equal(tc, jc, "corpus")
    for loader in ("train_loader", "val_loader"):
        jl, tl = getattr(j, loader)(), getattr(t, loader)()
        jb, tb = list(jl.epoch(0)), list(tl.epoch(0))
        assert len(tb) == len(jb) == (N_TRAIN if loader == "train_loader" else N_VAL) // BATCH
        for i, (a, b) in enumerate(zip(tb, jb)):
            assert_tree_equal(a, b, f"{loader} batch {i}")


def test_registries_match():
    from mod_extraction_tpu.data import datasets as jds
    from mod_extraction_tpu.data.modules import DATA_MODULE_REGISTRY as J
    from mod_extraction_tpu_torch.data import datasets as tds
    from mod_extraction_tpu_torch.data.modules import DATA_MODULE_REGISTRY as T

    assert sorted(T) == sorted(J)
    assert all(T[k].__name__ == J[k].__name__ for k in J)
    for name in ("random_audio_chunk", "random_audio_chunk_dry_wet", "random_audio_chunk_and_mod_sig",
                 "pedalboard_phaser", "phaser", "tremolo", "flanger_chorus", "preproc", "random_preproc"):
        assert tds.get_dataset_class(name).__name__ == jds.get_dataset_class(name).__name__
    with pytest.raises(ValueError):
        tds.get_dataset_class("nope")


class _CountingDataset:
    """Forty batches of tiny examples; counts the examples made."""

    def __init__(self, n: int = 160) -> None:
        self.n, self.made = n, 0

    def __len__(self) -> int:
        return self.n

    def getitem(self, epoch: int, i: int):
        self.made += 1
        return {"mod_sig": np.full(4, i, np.float32), "dry": np.zeros((1, 8), np.float32), "fx": {}}


def test_abandoned_epoch_stops_the_loader():
    """A consumer that leaves an epoch early (a NaN guard, an exception)
    ends the producer thread and the batches it had not started: none of
    the forty batches past those in flight is made."""
    import threading
    import time

    from mod_extraction_tpu_torch.data.loader import Loader

    ds = _CountingDataset()
    loader = Loader(ds, batch_size=4, num_workers=2, prefetch=1)
    epoch = loader.epoch(0)
    first = next(epoch)
    assert first["mod_sig"][:, 0].tolist() == [0, 1, 2, 3]
    # let the producer fill the queue and block on its next put: five
    # batches made (workers + prefetch in flight after the two delivered)
    deadline = time.monotonic() + 10
    while ds.made < 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    epoch.close()
    deadline = time.monotonic() + 10
    while any(t.name == "Loader.producer" for t in threading.enumerate()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(t.name == "Loader.producer" for t in threading.enumerate())
    assert ds.made == 20
