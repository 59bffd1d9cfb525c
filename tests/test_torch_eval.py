"""The port's eval path against the JAX package on the CPU: the eval tables,
`cli.validate_many`, `scripts/run_eval_grid_torch.py` and the weight
hand-off between the port's stages (`scripts/extract_torch_weights.py`).

Tolerances:
* tables and archives: byte-equal for the same metrics (a FAILED block's
  traceback names each script's own lines, so its first and last lines);
* the grid builders' (label, cfg) lists: equal;
* `validate_many`: the same labels and keys, metrics within rtol 1e-3 /
  atol 1e-5 (they agree to about 1e-6 relative: float32 sums in another
  order); RandomLFO variants compare structure only, as the packages draw
  the baseline's LFOs from different generators;
* the hand-off: the extracted `.npz` equals the port's weights exactly,
  and the JAX model holding it gives the port model's output within 1e-5.
"""

import copy
import importlib.util
import inspect
import math
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import test_eval_grid_variants as jax_grid_cases
from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.evaluation import tables as ttables
from test_torch_eval_cuda import (
    N_LFO,
    lfo_eval_config,
    lfo_variants,
    port_weights,
    tbptt_variants,
)
from test_torch_fit import N_TBPTT, SR, TINY_EXTRACTOR, lfo_config, tbptt_config, write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 1e-5


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GRID = load_script("run_eval_grid_torch")
JAX_GRID = jax_grid_cases._MOD
EXTRACT = load_script("extract_torch_weights")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the suite runs in
    several processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def one_device_jax(monkeypatch):
    """The JAX Trainer on a one-device mesh, as the port's runs on one."""
    from mod_extraction_tpu.parallel.mesh import make_mesh
    from mod_extraction_tpu.train import loop as jloop

    monkeypatch.setattr(jloop, "make_mesh", lambda: make_mesh(1))


# ------------------------------------------------------------------ tables

TABLE_CASES = {
    "one": {"val/loss": 0.1},
    "mixed": {"val/l1": 0.30134719610214233, "val/loss": 1.0, "val/esr": 3.0517578125e-05,
              "val/mse": 2, "val/dc": -0.0},
    "long_key": {"val/" + "a_very_long_metric_name" * 3: 123456.789, "val/x": 1e-20},
    "reprs": {"val/nan": float("nan"), "val/inf": float("inf"), "val/big": 1.7976931348623157e308,
              "val/third": 1 / 3, "val/np": float(np.float32(0.1))},
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_tables_are_byte_equal(case):
    from mod_extraction_tpu.evaluation import tables as jtables

    m = TABLE_CASES[case]
    assert ttables.format_validate_table(m) == jtables.format_validate_table(m)
    for label in ("eval ph idmt_4 cos fixed", "", "sim_chorus h160 capacity bracket " * 3):
        assert ttables.format_eval_block(m, label) == jtables.format_eval_block(m, label)


# ------------------------------------------------------- validate_many


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    write_corpus(os.path.join(root, "corpus"))
    write_corpus(os.path.join(root, "pairs"), n_files=(2, 2), dur_s=1.5, wet=True)
    return root, port_weights(root, 3)


def assert_same_results(port, jax_res, rtol=RTOL, atol=ATOL, values=True):
    assert [lb for lb, _ in port] == [lb for lb, _ in jax_res]
    for (lb, p), (_, j) in zip(port, jax_res):
        assert set(p) == set(j), lb
        if values:
            for k in j:
                assert math.isclose(p[k], float(j[k]), rel_tol=rtol, abs_tol=atol), (lb, k, p[k], j[k])


@pytest.mark.parametrize("kind", ["lfo", "tbptt"])
def test_validate_many_matches_jax(kind, eval_setup, tmp_path, one_device_jax):
    """The same variants (a data swap and a second checkpoint) through both
    packages' `validate_many`."""
    from mod_extraction_tpu import cli as jcli

    root, w = eval_setup
    variants = (lfo_variants if kind == "lfo" else tbptt_variants)(root, w)
    port = tcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "port"), device="cpu")
    jax_res = jcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "jax"))
    assert_same_results(port, jax_res)
    assert port[0][1]["loss"] != port[-1][1]["loss"]  # the second checkpoint loaded


def test_validate_many_random_lfo_structure(eval_setup, tmp_path, one_device_jax):
    """The RandomLFO baseline (nothing to load) over two data variants:
    labels and keys as in JAX."""
    from mod_extraction_tpu import cli as jcli

    root, _ = eval_setup
    rand = {"class_path": "mod_extraction.models.RandomLFO", "init_args": {  # baseline_rand_lfo.yml's
        "n_samples": N_LFO // 64, "sr": SR / 64, "use_shape_gt": True, "use_phase_gt": True,
        "use_freq_gt": True, "freq_min": 0.5, "freq_max": 3.0, "phase_error": 0.5, "freq_error": 0.25}}
    variants = []
    for label, c in lfo_variants(root, {"cnn0": "models/none.npz", "cnn1": "models/none.npz"})[:2]:
        c["model"]["init_args"]["model"] = copy.deepcopy(rand)
        c["model"]["init_args"]["model_smooth_n_frames"] = 0
        variants.append((label, c))
    port = tcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "port"), device="cpu")
    jax_res = jcli.validate_many(copy.deepcopy(variants), out_dir=str(tmp_path / "jax"))
    assert_same_results(port, jax_res, values=False)
    assert all(math.isfinite(v) for _, m in port for v in m.values())


def test_validate_many_reloads_per_variant(eval_setup, tmp_path, monkeypatch):
    """The two cases of `tests/test_validate_many.py` on the port: a second
    checkpoint changes the results.  Also: weights load only when
    `ckpt_path` changes, each time from the task's initial weights, and
    every variant's metrics are those of `validate` on its config alone."""
    root, w = eval_setup
    corpus = os.path.join(root, "corpus")
    loads = []
    real = tcli._load_eval_state
    monkeypatch.setattr(tcli, "_load_eval_state", lambda run, tr, ckpt: loads.append(ckpt) or real(run, tr, ckpt))
    variants = [("a", lfo_eval_config(corpus, w["cnn0"])), ("a again", lfo_eval_config(corpus, w["cnn0"])),
                ("b", lfo_eval_config(corpus, w["cnn1"])), ("init", lfo_eval_config(corpus))]
    res = dict(tcli.validate_many(variants, out_dir=str(tmp_path), device="cpu"))
    assert loads == [w["cnn0"], w["cnn1"], None]
    assert res["a"] == res["a again"] and res["a"]["loss"] != res["b"]["loss"]
    init = tcli.validate(lfo_eval_config(corpus), out_dir=str(tmp_path), device="cpu")
    assert res["init"] == init
    alone = tcli.validate(lfo_eval_config(corpus, w["cnn1"]), out_dir=str(tmp_path), device="cpu")
    assert res["b"] == alone


def test_validate_many_model_drift_rejected(eval_setup, tmp_path):
    root, w = eval_setup
    v1 = lfo_eval_config(os.path.join(root, "corpus"), w["cnn0"])
    v2 = copy.deepcopy(v1)
    v2["model"]["init_args"]["model_smooth_n_frames"] = 2
    with pytest.raises(AssertionError, match="model block"):
        tcli.validate_many([("a", v1), ("b", v2)], out_dir=str(tmp_path), device="cpu")


def test_validate_many_render_drift_rejected(eval_setup, tmp_path):
    """A variant whose delay line is longer renders with another
    RenderConfig: the task built for the first cannot serve it."""
    root, w = eval_setup
    v1 = lfo_eval_config(os.path.join(root, "corpus"), w["cnn0"])
    v2 = copy.deepcopy(v1)
    v2["data"]["init_args"]["fx_config"]["flanger"]["max_lfo_delay_ms"] = 10.0
    with pytest.raises(AssertionError, match="render config"):
        tcli.validate_many([("a", v1), ("b", v2)], out_dir=str(tmp_path), device="cpu")


def test_validate_prints_the_table_and_saves_latents(eval_setup, tmp_path, capsys):
    from mod_extraction_tpu.evaluation.tables import format_validate_table

    root, w = eval_setup
    cfg = lfo_eval_config(os.path.join(root, "corpus"), w["cnn0"])
    cfg["custom"]["save_latents"] = True
    metrics = tcli.validate(cfg, out_dir=str(tmp_path), device="cpu")
    assert format_validate_table({f"val/{k}": v for k, v in metrics.items()}) in capsys.readouterr().out
    latent = np.load(tmp_path / "latents" / "d.npy")
    # (batch, channels, frames) of the tiny CNN: 4 examples, 4 channels
    assert latent.shape[:2] == (4, 4) and np.isfinite(latent).all()


def test_validate_ckpt_script(eval_setup, tmp_path, monkeypatch, capsys):
    """`scripts/validate_ckpt_torch.py <config> [ckpt] --device cpu`: the
    positional checkpoint overrides the config's."""
    import yaml

    root, w = eval_setup
    script = load_script("validate_ckpt_torch")
    path = tmp_path / "model.yml"
    path.write_text(yaml.safe_dump(lfo_eval_config(os.path.join(root, "corpus"), w["cnn0"])))
    monkeypatch.chdir(tmp_path)
    a = script.main([str(path), "--device", "cpu"])
    b = script.main([str(path), w["cnn1"], "--device", "cpu"])
    assert a["loss"] != b["loss"]
    assert script.parse_args(["m.yml"]).device == "cuda"
    assert "val/loss" in capsys.readouterr().out


# ------------------------------------------------------- the grid script


def _case_kwargs(fn, **available):
    return {k: v for k, v in available.items() if k in inspect.signature(fn).parameters}


@pytest.mark.parametrize("case", sorted(n for n in dir(jax_grid_cases) if n.startswith("test_")))
def test_grid_case_on_the_port_script(case, monkeypatch, tmp_path):
    """Every case of `tests/test_eval_grid_variants.py`, run against
    `scripts/run_eval_grid_torch.py`."""
    monkeypatch.setattr(jax_grid_cases, "_MOD", GRID)
    fn = getattr(jax_grid_cases, case)
    fn(**_case_kwargs(fn, monkeypatch=monkeypatch, tmp_path=tmp_path))



def _all_groups(mod, load):
    """Every builder's (label, cfg) output of one grid script."""
    out = {}
    for name in mod.DEFAULT_GRID:
        if name == "eval_em_unseen_effect.yml":
            continue
        for per_shape in (False, True):
            out[f"{name} {per_shape}"] = mod._config_groups(name, load(name), per_shape)
    out["rand"] = list(mod._rand_suite_variants(load("eval_lfo_rand.yml")))
    out["unseen"] = list(mod._unseen_audio_groups())
    out["em_sim"] = list(mod._em_sim_variants(load("eval_em_sim.yml")))
    out["chorus"] = mod._chorus_variant(load("eval_lfo_quasi.yml"))
    return out


def test_grid_builders_equal_jax():
    from mod_extraction_tpu.cli import load_yaml_with_includes as jload

    port, jax_out = _all_groups(GRID, tcli.load_yaml_with_includes), _all_groups(JAX_GRID, jload)
    assert port.keys() == jax_out.keys()
    for k in jax_out:
        assert port[k] == jax_out[k], k
    for name in ("DEFAULT_GRID", "PER_SHAPE_LABEL", "TWO_EFFECT_LABEL", "RAND_PREFIX", "SYMMETRICAL_SHAPES",
                 "RAND_CONDITIONS", "UNSEEN_DOMAINS", "UNSEEN_EFFECT_CONFIGS", "EM_SIM_EFFECTS",
                 "EM_UNSEEN_BLOCKS", "H160_PAIRS"):
        assert getattr(GRID, name) == getattr(JAX_GRID, name), name


def _recording(calls):
    def validate_many(variants):
        calls.append(copy.deepcopy(variants))
        return [(lb, {"esr": 0.25 + len(lb) / 1000, "l1": 1 / 3, "loss": 0.1}) for lb, _ in variants]

    return validate_many


def _present(monkeypatch, present=True):
    """Every regenerable corpus and checkpoint of the em-sim suite present
    (or absent), whatever this checkout holds."""
    real = {f: getattr(os.path, f) for f in ("exists", "isdir", "isfile")}

    def fake(name):
        def check(p):
            p = str(p)
            if p.startswith("data/sim_") or p.startswith("models/"):
                return present
            return real[name](p)
        return check

    for f in real:
        monkeypatch.setattr(os.path, f, fake(f))


@pytest.mark.parametrize("present", [True, False])
def test_em_sim_block_builders_equal_jax(present, monkeypatch):
    """The em-sim suite's four block builders give the JAX script's blocks
    and make the same validate_many calls with the same configs."""
    from mod_extraction_tpu.cli import load_yaml_with_includes as jload

    _present(monkeypatch, present)
    table = lambda m: f"TABLE({sorted(m.items())})"  # noqa: E731
    out = {}
    for mod, load in ((GRID, tcli.load_yaml_with_includes), (JAX_GRID, jload)):
        calls = []
        vm = _recording(calls)
        cfg = load("eval_em_sim.yml")
        blocks = (mod.build_em_sim_blocks(cfg, vm, table) + mod.build_gt_control_blocks(vm, table)
                  + mod.build_h160_capacity_blocks(vm, table) + mod.build_chorus3_s2_blocks(cfg, vm, table))
        out[mod] = blocks, calls
    assert out[GRID] == out[JAX_GRID]
    assert (len(out[GRID][1]) == 1 + 7 + 6 + 2 + 2) if present else not out[GRID][1]


def _fake_metrics(label):
    return {"loss": 0.1 + len(label) / 997, "l1": 1 / 3, "esr": 2.0 ** -len(label), "dc": 0.0}


def _fake_validate_many(fail_on=None):
    def validate_many(variants):
        if fail_on is not None and any(fail_on in lb for lb, _ in variants):
            raise RuntimeError(f"boom {fail_on}")
        return [(lb, _fake_metrics(lb or "bare")) for lb, _ in variants]

    return validate_many


def _blocks_without_tracebacks(text):
    """The archive with each traceback cut to its first and last lines."""
    out, skipping = [], False
    for line in text.split("\n"):
        if line.startswith("Traceback (most recent call last)"):
            skipping = True
            continue
        if skipping and (line.startswith("  ") or not line):
            continue
        skipping = False
        out.append(line)
    return out


ARCHIVE_RUNS = {
    "per_shape": (["--per-shape", "eval_lfo.yml", "eval_lfo_quasi.yml", "eval_lfo_combined.yml",
                   "eval_lfo_chorus_varying.yml"], None),
    "plain": (["eval_lfo_flanger.yml", "eval_lfo_rand.yml"], None),
    "rand_suite": (["--rand-suite"], None),
    "unseen_audio": (["--unseen-audio"], None),
    "em_sim": (["--em-sim"], None),
    "failed_group": (["--per-shape", "eval_lfo_distorted.yml"], " ch "),
    "failed_single": (["eval_lfo_varying.yml"], ""),
    "failed_em_sim": (["--em-sim"], "sim_phaser__rand"),
}


@pytest.mark.parametrize("run", sorted(ARCHIVE_RUNS))
def test_archives_equal_jax(run, tmp_path, monkeypatch):
    """`run_eval_grid_torch.py`'s files against `run_eval_grid.py`'s, the
    same fake metrics feeding both: the same files with the same blocks in
    the same order, byte for byte."""
    from mod_extraction_tpu import cli as jcli

    flags, fail_on = ARCHIVE_RUNS[run]
    mode = [f for f in flags if f.startswith("--")]
    configs = [f for f in flags if not f.startswith("--")]
    if run.endswith("em_sim"):
        _present(monkeypatch)
    monkeypatch.chdir(ROOT)  # the JAX script resolves `configs/...` from the working directory
    GRID.main(mode + [str(tmp_path / "port")] + configs, validate_many=_fake_validate_many(fail_on))
    monkeypatch.setattr(jcli, "validate_many", _fake_validate_many(fail_on))
    monkeypatch.setattr(sys, "argv", ["run_eval_grid.py"] + mode + [str(tmp_path / "jax")] + configs)
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "run_eval_grid.py"), run_name="__main__")
    except SystemExit as e:  # the unseen-audio sweep exits 0
        assert e.code == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        port = (tmp_path / "port" / name).read_text()
        jax_text = (tmp_path / "jax" / name).read_text()
        if fail_on is None:
            assert port == jax_text, name
            assert "FAILED" not in port and "┃" in port or run == "unseen_audio", name
        else:
            assert "FAILED" in port
            assert _blocks_without_tracebacks(port) == _blocks_without_tracebacks(jax_text), name


def test_em_unseen_stub_equals_jax(monkeypatch, tmp_path):
    """The unseen-effect stub: the 7 imported LSTM-64 checkpoints serve a
    forward pass through the port's `load_lstm_effect_model`; the archived
    text (output rms to 4 decimals) equals JAX's."""
    monkeypatch.chdir(ROOT)
    port = GRID.build_em_unseen_stub("cpu")
    jax_text = JAX_GRID.build_em_unseen_stub()
    assert port == jax_text
    assert port[0].count("forward OK") == 7


def test_grid_script_argv():
    assert GRID.split_argv(["--em-sim", "out", "--device", "cpu", "a.yml"]) == (
        "cpu", {"--em-sim"}, ["out", "a.yml"])
    assert GRID.split_argv([]) == ("cuda", set(), [])
    with pytest.raises(SystemExit, match="--device needs a value"):
        GRID.split_argv(["--device"])


# ---------------------------------------------------------- the hand-off


def test_spectral_2dcnn_converter_round_trips():
    """flax -> state_dict -> flax and state_dict -> flax -> state_dict are
    exact, on a shipped extractor and on a seeded port init."""
    from mod_extraction_tpu_torch.models.convert import (
        flax_to_state_dict,
        spectral_2dcnn_state_dict_to_flax,
    )
    from mod_extraction_tpu_torch.train.checkpoints import load_weights

    path = "models/lfo_2dcnn_io_sa_25_25_no_ch_ln__interwoven_idmt_all_live_r7.npz"
    shipped = load_weights(os.path.join(ROOT, path))
    back = spectral_2dcnn_state_dict_to_flax(flax_to_state_dict(os.path.join(ROOT, path)))
    assert back.keys() == shipped.keys()
    for layer in shipped:
        for leaf, v in shipped[layer].items():
            assert back[layer][leaf].dtype == np.float32
            np.testing.assert_array_equal(back[layer][leaf], v)
    model = tcli.build_model({"class_path": "Spectral2DCNN", "init_args": dict(TINY_EXTRACTOR)},
                             {"n_samples": N_TBPTT, "sr": SR}, 5)
    sd = model.state_dict()
    again = flax_to_state_dict(spectral_2dcnn_state_dict_to_flax(sd))
    assert again.keys() == sd.keys() and all(torch.equal(again[k], sd[k]) for k in sd)


def _jax_forward_cnn(tree, x, n_samples):
    import jax.numpy as jnp

    from mod_extraction_tpu.models import Spectral2DCNN

    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY_EXTRACTOR.items()}
    m = Spectral2DCNN(n_samples=n_samples, sr=SR, **cfg)
    mod_hat, latent = m.apply({"params": tree}, jnp.asarray(x))
    return np.asarray(mod_hat), np.asarray(latent)


def _jax_forward_lstm(tree, x, lat, hid):
    import jax.numpy as jnp

    from mod_extraction_tpu.models import LSTMEffectModel
    from mod_extraction_tpu.models.lstm import lstm_init_state

    m = LSTMEffectModel(in_ch=1, out_ch=1, n_hidden=hid, latent_dim=1)
    y, _ = m.apply({"params": tree}, jnp.asarray(x), jnp.asarray(lat), lstm_init_state(x.shape[0], hid))
    return np.asarray(y)


def test_weight_hand_off_between_stages(tmp_path, monkeypatch):
    """Stage 1 trains an extractor for an epoch on the CPU;
    `extract_torch_weights.py` turns its `best.pt` into an `.npz` that
    JAX's `load_weights` reads and whose JAX model gives the port model's
    output within 1e-5.  Stage 2 then trains an LSTM on that `.npz`
    (`lfo_model_weights_path`); its `effect_model` and `lfo_model` extract
    and load in both packages."""
    from mod_extraction_tpu.train.checkpoints import load_weights as jax_load_weights
    from mod_extraction_tpu_torch.models.convert import flax_to_state_dict, load_lstm_effect_model
    from mod_extraction_tpu_torch.models.lstm import lstm_init_state

    corpus, pairs = str(tmp_path / "corpus"), str(tmp_path / "pairs")
    write_corpus(corpus)
    write_corpus(pairs, n_files=(2, 1), dur_s=1.5, wet=True)
    w = port_weights(str(tmp_path), 9)

    # stage 1: the extractor's config at the TBPTT frame rate
    cfg = lfo_config(corpus, w["ext0"])
    cfg["model"]["init_args"]["model"]["init_args"] = dict(TINY_EXTRACTOR)
    task = tcli.fit(cfg, out_dir=str(tmp_path / "s1"), device="cpu")
    best = tmp_path / "s1" / "m__lfo_ckpts" / "best.pt"
    assert best.is_file()
    ext_npz = str(tmp_path / "extractor.npz")
    EXTRACT.main([str(best.parent), ext_npz])  # the checkpoint directory: its best.pt
    jtree = jax_load_weights(ext_npz)
    sd = task.trained_model.state_dict()
    got = flax_to_state_dict(jtree)
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k].cpu()) for k in sd)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 2, N_TBPTT)).astype(np.float32)
    model = task.trained_model.eval()
    with torch.no_grad():
        mod_hat, latent = model(torch.from_numpy(x))
    j_mod, j_latent = _jax_forward_cnn(jtree, x, N_TBPTT)
    np.testing.assert_allclose(mod_hat.numpy(), j_mod, atol=1e-5)
    np.testing.assert_allclose(latent.numpy(), j_latent, atol=1e-5)

    # stage 2 on the extracted extractor
    cfg2 = tbptt_config(pairs, w["lstm0"], ext_npz)
    task2 = tcli.fit(cfg2, out_dir=str(tmp_path / "s2"), device="cpu")
    ckpt = str(tmp_path / "s2" / "lstm__tbptt_ckpts" / "best.pt")
    lstm_npz, lfo_npz = str(tmp_path / "lstm.npz"), str(tmp_path / "lfo.npz")
    EXTRACT.main([ckpt, lstm_npz, "effect_model"])
    EXTRACT.main([ckpt, lfo_npz, "lfo_model"])
    assert EXTRACT.extract(ckpt, "model").keys() == EXTRACT.extract(ckpt, "effect_model").keys()
    with np.load(lfo_npz) as a, np.load(ext_npz) as b:  # the frozen extractor passes through
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    port_lstm = load_lstm_effect_model(lstm_npz, device="cpu")
    for k, v in task2.effect_model.state_dict().items():
        assert torch.equal(port_lstm.state_dict()[k], v.cpu())
    rng = np.random.default_rng(1)
    xs = rng.uniform(-0.5, 0.5, (2, 1, 700)).astype(np.float32)
    lat = rng.uniform(0, 1, (2, 1, 700)).astype(np.float32)
    with torch.no_grad():
        y, _ = port_lstm(torch.from_numpy(xs), torch.from_numpy(lat), lstm_init_state(2, 8))
    np.testing.assert_allclose(y.numpy(), _jax_forward_lstm(jax_load_weights(lstm_npz), xs, lat, 8), atol=1e-5)

    # the loader refuses a .pt and names the script that converts it
    with pytest.raises(NotImplementedError, match="extract_torch_weights.py"):
        tcli._load_lfo_weights(port_lstm, ckpt)
    with pytest.raises(SystemExit, match="no param_model"):
        EXTRACT.extract(ckpt, "param_model")
    _param_model_hand_off(tmp_path)
    with pytest.raises(SystemExit, match="no frozen extractor"):
        EXTRACT.extract(str(best), "lfo_model")


def _param_model_hand_off(tmp_path):
    """A TBPTT checkpoint that trains a SpectralDSTCN param model and its
    extractor ({effect, param, lfo}): `param_model` extracts to an `.npz`
    whose JAX SpectralDSTCN gives the port model's latent within 1e-5, and
    `lfo_model` / `effect_model` find the trained extractor and the LSTM."""
    import jax.numpy as jnp

    from mod_extraction_tpu.models.tcn import SpectralDSTCN as JSpectralDSTCN
    from mod_extraction_tpu.train.checkpoints import load_weights as jax_load_weights
    from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict
    from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN
    from mod_extraction_tpu_torch.models.tcn import SpectralDSTCN
    from mod_extraction_tpu_torch.train.render import RenderConfig
    from mod_extraction_tpu_torch.train.tbptt_task import TBPTTEffectModelingTask

    kw = dict(n_fft=256, hop_len=64, kernel_size=5, out_channels=(4, 4), dilations=(1, 2), strides=(2, 2),
              n_fc_units=8, latent_dim=2)
    render = RenderConfig(sr=SR, n_samples=N_TBPTT, effects=(2,), max_delay_samples=89)
    ext = Spectral2DCNN(n_samples=N_TBPTT, sr=SR, **{k: tuple(v) if isinstance(v, list) else v
                                                      for k, v in TINY_EXTRACTOR.items()})
    task = TBPTTEffectModelingTask(
        LSTMEffectModel(n_hidden=8, latent_dim=3), render, lfo_model=ext, freeze_lfo_model=False,
        param_model=SpectralDSTCN(n_samples=N_TBPTT, seed=4, **kw), device="cpu",
    )
    ckpt = str(tmp_path / "variants.pt")
    torch.save({"task": task.state_dict(), "step": 0}, ckpt)
    npz = str(tmp_path / "param.npz")
    EXTRACT.main([ckpt, npz, "param_model"])
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 1, 3000)).astype(np.float32)
    with torch.no_grad():
        want = task.param_model(torch.from_numpy(x)).numpy()
    got = JSpectralDSTCN(n_samples=3000, **kw).apply({"params": jax_load_weights(npz)}, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5)
    for attribute, convert, model in (("lfo_model", flax_to_state_dict, task.lfo_model),
                                      ("effect_model", flax_lstm_to_state_dict, task.effect_model)):
        sd = convert(EXTRACT.extract(ckpt, attribute))
        assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items()), attribute

