"""The port's sim-corpus generators (`scripts/make_sim_effect_data_torch.py`,
`scripts/make_sim_chorus_gt_control_torch.py`) and `ops/fx.py::
apply_flanger_chorus` against the JAX package's on the CPU.

The port renders with K1's and K2's plain versions here, the JAX package
with its `lax.scan` renderers.  Tolerances: `apply_flanger_chorus` and
each effect's wet render within 1e-4 max-abs (the float32 recurrences agree
to about 1e-7); the written dry files, the LFO draws and the control's
`.npz` records byte for byte (the same numpy seeds and draws); the written
wet files within 4 PCM16 steps (1e-4 of full scale is about 3 steps).  The
generators run at 3000-sample segments instead of 2.5 s (`SEG`): every
draw is the same, only shorter.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch.data.wav import wav_read, wav_write
from mod_extraction_tpu_torch.ops.fx import apply_flanger_chorus, ms_to_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
SR = 44100
SEG = 3000


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = load_script("make_sim_effect_data_torch")
JAX = load_script("make_sim_effect_data")
PORT_GT = load_script("make_sim_chorus_gt_control_torch")
JAX_GT = load_script("make_sim_chorus_gt_control")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the CLI

CLI_CASES = {
    "positional": ["a/train", "a/val", "outdir"],
    "flags_and_effect": ["sim_phaser", "--src-train", "t", "--src-val", "v"],
    "defaults": [],
    "flags_win": ["a", "b", "c", "--out-root", "o", "sim_chorus3", "sim_flanger2"],
    "effects_only": ["sim_chorus", "sim_chorus4"],
}


@pytest.mark.parametrize("script", ["port", "jax"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_parse_args_equals_jax(script, case):
    """The cases of `tests/test_script_cli.py`, on both generators: the same
    (src_train, src_val, out_root, effects) as the JAX script."""
    mod = PORT if script == "port" else JAX
    argv = CLI_CASES[case]
    assert mod.parse_args(list(argv)) == JAX.parse_args(list(argv))
    if case == "positional":
        assert mod.parse_args(argv)[:3] == ("a/train", "a/val", "outdir")
    if case == "defaults":
        assert mod.parse_args(argv) == ("data/idmt_4/train", "data/idmt_4/val", "data", list(JAX.ALL_EFFECTS))
    if case == "flags_and_effect":
        assert mod.parse_args(argv) == ("t", "v", "data", ["sim_phaser"])


@pytest.mark.parametrize("script", ["port", "jax"])
def test_trailing_flag_errors(script):
    mod = PORT if script == "port" else JAX
    with pytest.raises(SystemExit, match="--out-root needs a value"):
        mod.parse_args(["--out-root"])


def test_constants_and_device_flag():
    assert PORT.ALL_EFFECTS == JAX.ALL_EFFECTS and PORT.EFFECT_SEEDS == JAX.EFFECT_SEEDS
    assert (PORT.SR, int(2.5 * PORT.SR)) == (JAX.SR, JAX.SEG) == (SR, PORT.SEG)
    assert PORT_GT.REGIMES == JAX_GT.REGIMES
    assert PORT.pop_device(["sim_chorus", "--device", "cpu", "x"]) == ("cpu", ["sim_chorus", "x"])
    assert PORT.pop_device([]) == ("cuda", [])
    with pytest.raises(SystemExit, match="--device needs a value"):
        PORT.pop_device(["--device"])


# ------------------------------------------------- apply_flanger_chorus

FX_CASES = {
    "chorus": dict(max_min_delay_ms=30.0, max_lfo_delay_ms=10.0, feedback=0.3, min_delay_width=0.367,
                   width=0.8, depth=1.0, mix=0.9),
    "flanger": dict(max_min_delay_ms=1.0, max_lfo_delay_ms=4.0, feedback=0.45, min_delay_width=1.0,
                    width=0.5, depth=1.0, mix=1.0),
    "per_row": dict(max_min_delay_ms=1.0, max_lfo_delay_ms=10.0, feedback="rows", min_delay_width="rows",
                    width="rows", depth="rows", mix="rows"),
}


@pytest.mark.parametrize("mod_rank", [2, 3])
@pytest.mark.parametrize("case", sorted(FX_CASES))
def test_apply_flanger_chorus_matches_jax(case, mod_rank):
    import jax.numpy as jnp

    from mod_extraction_tpu.ops.fx import apply_flanger_chorus as jax_fc
    from mod_extraction_tpu.ops.fx import ms_to_samples as jax_ms

    rng = np.random.default_rng(len(case) + mod_rank)
    b, c, t = 3, 2, 2500
    x = rng.uniform(-0.9, 0.9, (b, c, t)).astype(np.float32)
    mod = rng.uniform(0, 1, (b, t) if mod_rank == 2 else (b, c, t)).astype(np.float32)
    kw = {k: rng.uniform(0.1, 0.9, b).astype(np.float32) if v == "rows" else v for k, v in FX_CASES[case].items()}
    got = apply_flanger_chorus(torch.from_numpy(x), torch.from_numpy(mod), SR,
                               **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    want = np.asarray(jax_fc(jnp.asarray(x), jnp.asarray(mod), SR,
                             **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL
    for ms in (0.0, 1.0, 4.0, 10.0, 30.0, 0.0113378):
        assert ms_to_samples(ms, SR) == jax_ms(ms, SR)


def test_apply_flanger_chorus_has_no_other_route():
    """A tensor off the CPU takes K1 or raises (here: a meta tensor raises
    in the wrapper, and nothing is counted)."""
    from mod_extraction_tpu_torch.ops import fx_kernels

    x = torch.empty(2, 1, 64, device="meta")
    fx_kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="meta"):
        apply_flanger_chorus(x, torch.empty(2, 64, device="meta"), SR, 1.0, 4.0)
    assert fx_kernels.LAUNCHES["flanger"] == 0


# ------------------------------------------------------ the generators


@pytest.fixture(scope="module")
def dry_source(tmp_path_factory):
    """Two short 44.1 kHz source splits (train, val) of plucked noise."""
    root = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(5)
    for split, n in (("train", 3), ("val", 2)):
        os.makedirs(root / split)
        for i in range(n):
            a = 0.5 * rng.standard_normal(2 * SEG) * np.exp(-np.arange(2 * SEG) / SEG)
            wav_write(str(root / split / f"s{i}_100bpm.wav"), a.astype(np.float32), SR)
    return root


@pytest.fixture()
def short_segments(monkeypatch):
    monkeypatch.setattr(PORT, "SEG", SEG)
    monkeypatch.setattr(JAX, "SEG", SEG)


@pytest.mark.parametrize("effect", ["sim_chorus", "sim_chorus4", "sim_flanger2", "sim_phaser"])
def test_render_matches_jax(effect, dry_source, short_segments):
    """One effect of each family (chorus, chorus with tremolo, flanger,
    phaser): the same dry windows and LFO draws, the wet within 1e-4, and
    the generators' numpy streams left in the same state."""
    outs = {}
    for name, mod in (("port", PORT), ("jax", JAX)):
        rng = np.random.default_rng(PORT.EFFECT_SEEDS[effect])
        dry = mod._load_dry(rng, str(dry_source / "train"), 3)
        wet = mod._render(effect, rng, dry, "cpu") if mod is PORT else np.asarray(mod._render(effect, rng, dry))
        outs[name] = dry, wet, rng.random()
    (d_p, w_p, r_p), (d_j, w_j, r_j) = outs["port"], outs["jax"]
    assert np.array_equal(d_p, d_j) and r_p == r_j
    assert w_p.shape == w_j.shape == (3, 1, SEG)
    assert np.abs(w_p - w_j).max() <= TOL


def _pcm(path):
    return wav_read(str(path))[0]


def test_generator_main_writes_the_jax_corpus(dry_source, short_segments, tmp_path, monkeypatch):
    """`main` of both generators for two effects: the same files, the dry
    ones byte for byte, the wet within 4 PCM16 steps."""
    args = ["--src-train", str(dry_source / "train"), "--src-val", str(dry_source / "val"),
            "sim_chorus3", "sim_flanger"]
    PORT.main(args + ["--out-root", str(tmp_path / "port"), "--device", "cpu"])
    JAX.main(args + ["--out-root", str(tmp_path / "jax")])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    assert len(files) == 2 * 2 * (48 + 8)
    assert sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav")) == files
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if "dry" in rel.parts:
            assert a.read_bytes() == b.read_bytes(), rel
        else:
            assert np.abs(_pcm(a) - _pcm(b)).max() <= 4 / 32767, rel


@pytest.mark.parametrize("regime", ["chorus", "chorus4"])
def test_gt_control_matches_jax(regime, dry_source, tmp_path):
    """`render_split` of both control generators (three examples in
    batches of two): the same triplet names, dry files and `.npz` records,
    the wet within 4 PCM16 steps."""
    mdw, width, _, seed, delay_mix, trem_mix = PORT_GT.REGIMES[regime]
    kw = dict(batch=2, min_delay_width=mdw, width=width, delay_mix=delay_mix, trem_mix=trem_mix)
    PORT_GT.render_split(np.random.default_rng(seed), str(dry_source / "val"), str(tmp_path / "port"),
                         3, SEG, device="cpu", **kw)
    JAX_GT.render_split(np.random.default_rng(seed), str(dry_source / "val"), str(tmp_path / "jax"), 3, SEG, **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 9 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npz"):
            with np.load(a, allow_pickle=True) as p, np.load(b, allow_pickle=True) as j:
                assert np.array_equal(p["mod_sig"], j["mod_sig"])
                assert p["fx_params"].item() == j["fx_params"].item()
        elif name.endswith("_dry.wav"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            assert np.abs(_pcm(a) - _pcm(b)).max() <= 4 / 32767, name


@pytest.mark.parametrize("style", ["pads", "vocal", "drums", "bass", "keys"])
def test_unseen_audio_styles_are_byte_equal(style, tmp_path, monkeypatch):
    """`write_synthetic_corpus(..., style=)` writes the unseen-audio domains
    of `scripts/make_synthetic_corpus.py --style <style>` (which the
    `--unseen-audio` sweep reads from `data/unseen_<style>/val`), byte for
    byte."""
    import sys

    from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus

    script = load_script("make_synthetic_corpus")
    monkeypatch.setattr(sys, "argv", ["make_synthetic_corpus.py", str(tmp_path / "jax"), "1", "1", "1.5",
                                      "--style", style])
    script.main()
    ours = sorted(write_synthetic_corpus(str(tmp_path / "port"), n_train=1, n_val=1, dur_s=1.5, style=style))
    theirs = sorted(str(p) for p in (tmp_path / "jax").rglob("*.wav"))
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == \
        [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    assert all(os.path.basename(p).startswith(f"{style}_") for p in ours)
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
