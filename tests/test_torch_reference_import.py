"""Reading the reference's `.pt` checkpoints in the port
(`mod_extraction_tpu_torch/models/torch_port.py`,
`scripts/import_reference_weights_torch.py`, the CLI's `.pt` weights)
against the JAX package on the CPU.

Tolerances:
* the seven layout functions, the import scripts' `.npz` files and every
  weight the CLI loads: equal, bit for bit, to the JAX package's;
* forwards against reference-architecture torch modules (the CNN and the
  LSTM of `chip_smoke.py`, the TCNs here) and against the JAX model holding
  JAX's ported parameters: 2e-6 for the LSTM (as
  `tests/test_reference_ckpt_parity.py`), 5e-5 for the CNN on the same Mel
  features and for the TCNs (as `tests/test_spectral2dcnn_port.py` and
  `tests/test_tcn_port.py`);
* the stage-1 eval table from a reference `.pt`: equal to the one from its
  `.npz`;
* streaming the egfx-phaser LSTM-64 imported from a reference-layout `.pt`:
  chunked within 1e-5 of one call (the JAX test of the reference's own
  checkpoint skips where it is not mounted).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn
import yaml

from mod_extraction_tpu.models import torch_port as jtp
from mod_extraction_tpu_torch import cli as tcli
from mod_extraction_tpu_torch.models import torch_port as tp
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, flax_to_state_dict
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel, lstm_init_state
from test_torch_eval_cuda import lfo_eval_config, port_weights
from test_torch_fit import lfo_config, tbptt_config, write_corpus
from chip_smoke import ReferenceCNN, ReferenceLSTM, reference_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGFX_PHASER = os.path.join(ROOT, "models", "lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz")
LSTM_ATOL, CNN_ATOL, STREAM_ATOL = 2e-6, 5e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the suite runs in
    several processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), path


def _numpy(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _seeded(module_cls, *args, seed=0, **kw):
    torch.manual_seed(seed)
    return module_cls(*args, **kw).eval()


class RefBlock(tnn.Module):
    """The reference's non-causal TCN block (`mod_extraction/tcn.py:103-232`):
    LayerNorm over (C, T), no affine -> dilated "same" Conv1d -> PReLU ->
    1x1 residual, center-cropped."""

    def __init__(self, in_ch, out_ch, k, dil, temporal_dim):
        super().__init__()
        self.ln = tnn.LayerNorm([in_ch, temporal_dim], elementwise_affine=False)
        self.conv = tnn.Conv1d(in_ch, out_ch, k, dilation=dil, padding=k // 2 * dil)
        self.act = tnn.PReLU(out_ch)
        self.res = tnn.Conv1d(in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        h = self.act(self.conv(self.ln(x)))
        res = self.res(x)
        extra = res.size(-1) - h.size(-1)
        if extra > 0:
            res = res[:, :, extra // 2 : extra // 2 + h.size(-1)]
        return h + res


class RefTCN(tnn.Module):
    def __init__(self, in_ch, chans, dils, k, temporal_dim):
        super().__init__()
        blocks, prev = [], in_ch
        for ch, d in zip(chans, dils):
            blocks.append(RefBlock(prev, ch, k, d, temporal_dim))
            prev = ch
        self.blocks = tnn.ModuleList(blocks)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class RefSpectralTCN(tnn.Module):
    """The reference's SpectralTCN head (`mod_extraction/models.py:72-125`):
    a TCN under `tcn`, a 1x1 Conv1d `output`, sigmoid, on the log
    spectrogram."""

    def __init__(self, n_bins, chans, dils, k, n_frames):
        super().__init__()
        self.tcn = RefTCN(n_bins, chans, dils, k, n_frames)
        self.output = tnn.Conv1d(chans[-1], 1, 1)

    def forward(self, log_spec):
        return torch.sigmoid(self.output(self.tcn(log_spec)))


def small_cnn(seed=0):
    """The reference CNN at 3 x 8 channels over 32 mels and 40 frames."""
    return _seeded(ReferenceCNN, seed=seed, in_ch=2, n_mels=32, n_frames=40, chans=(8, 8, 8), dils=(1, 2, 4))


# --------------------------------------------------- the seven layout functions


def _random_sds(rng) -> dict:
    """Reference state_dicts with random values (numpy), one per function."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cnn = _numpy(small_cnn().state_dict())
    cnn = {k: a(*v.shape) for k, v in cnn.items()}
    tcn = {f"blocks.{i}.{p}": a(*shape) for i in range(3) for p, shape in
           (("conv.weight", (8, 6 if i == 0 else 8, 5)), ("conv.bias", (8,)), ("act.weight", (8,)),
            ("res.weight", (8, 6 if i == 0 else 8, 1)))}
    del tcn["blocks.1.act.weight"], tcn["blocks.2.res.weight"]  # a block without PReLU, one without residual
    spectral_tcn = {f"tcn.{k}": v for k, v in tcn.items()}
    spectral_tcn.update({"output.weight": a(1, 8, 1), "output.bias": a(1)})
    lstm = {"lstm.weight_ih_l0": a(64, 2), "lstm.weight_hh_l0": a(64, 16), "lstm.bias_ih_l0": a(64),
            "lstm.bias_hh_l0": a(64), "fc.weight": a(1, 16), "fc.bias": a(1)}
    return dict(cnn=cnn, tcn=tcn, spectral_tcn=spectral_tcn, lstm=lstm)


LAYOUT_CASES = {
    "conv2d_kernel": lambda f, sds, a: f(a((4, 3, 5, 7))),
    "conv1d_kernel": lambda f, sds, a: f(a((4, 3, 5))),
    "linear_kernel": lambda f, sds, a: f(a((4, 3))),
    "port_lstm_effect_model": lambda f, sds, a: f(sds["lstm"]),
    "port_spectral_2dcnn": lambda f, sds, a: f(sds["cnn"], 3),
    "port_tcn": lambda f, sds, a: f(sds["tcn"], 3),
    "port_spectral_tcn": lambda f, sds, a: f(sds["spectral_tcn"], 3),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_layout_function_equals_jax(name):
    """The port's numpy copy of each JAX layout function gives the JAX
    function's output, keys, dtypes and values, on random reference
    state_dicts (extra keys such as the Mel frontend's buffers ignored)."""
    rng = np.random.default_rng(5)
    sds = _random_sds(rng)
    arrays = {}

    def a(shape):  # the same array for both calls
        return arrays.setdefault(shape, rng.standard_normal(shape).astype(np.float32))

    got = LAYOUT_CASES[name](getattr(tp, name), sds, a)
    want = LAYOUT_CASES[name](getattr(jtp, name), sds, a)
    _assert_trees_equal(got, want)


# ------------------------------------------------ reference modules, both packages


def test_lstm_from_a_reference_module():
    """LSTM(2, 16) + Linear + residual tanh, imported: the port's forward
    (K3's plain version) within 2e-6 of the module and of the JAX model
    holding JAX's ported parameters."""
    import jax.numpy as jnp

    from mod_extraction_tpu.models.lstm import LSTMEffectModel as JLSTM
    from mod_extraction_tpu.models.lstm import lstm_init_state as j_init

    ref = _seeded(ReferenceLSTM, 2, 16)
    model = LSTMEffectModel(n_hidden=16)
    model.load_state_dict(tp.reference_state_dict(ref.state_dict(), model))
    rng = np.random.default_rng(1)
    x = (0.2 * rng.standard_normal((3, 1, 400))).astype(np.float32)
    lat = rng.uniform(0, 1, (3, 1, 400)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x), torch.from_numpy(lat)).numpy()
        got, _ = model(torch.from_numpy(x), torch.from_numpy(lat), lstm_init_state(3, 16))
    params = jtp.port_lstm_effect_model(_numpy(ref.state_dict()))
    j, _ = JLSTM(in_ch=1, out_ch=1, n_hidden=16, latent_dim=1).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lat), j_init(3, 16))
    np.testing.assert_allclose(got.numpy(), want, atol=LSTM_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=LSTM_ATOL, rtol=0)


def test_cnn_from_a_reference_module():
    """The reference CNN (3 x 8 channels, kernel (5, 13), dilations 1/2/4,
    its Mel frontend's buffers in the state_dict), imported into the port's
    Spectral2DCNN: within 5e-5 of the module and of the JAX model on the
    same features, float32 convs."""
    import jax
    import jax.numpy as jnp

    from mod_extraction_tpu.models.spectral_2dcnn import Spectral2DCNN as JCNN
    from mod_extraction_tpu_torch.models.spectral_2dcnn import Spectral2DCNN

    in_ch, n_mels, n_frames, chans, dils = 2, 32, 40, (8, 8, 8), (1, 2, 4)
    ref = small_cnn()
    assert any(k.startswith("spectrogram.") for k in ref.state_dict())
    kw = dict(in_ch=in_ch, n_samples=n_frames * 256 - 256, sr=44100, n_mels=n_mels, out_channels=chans,
              bin_dilations=(1,) * 3, temp_dilations=dils, pool_size=(2, 1))
    model = Spectral2DCNN(**kw, compute_dtype="float32").eval()
    model.load_state_dict(tp.reference_state_dict(ref.state_dict(), model))
    spec = np.random.default_rng(2).uniform(0.0, 2.0, (3, in_ch, n_mels, n_frames)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(spec)).numpy()
        got, latent = model(torch.zeros(3, in_ch, 8), features=torch.from_numpy(spec))
    params = jtp.port_spectral_2dcnn(_numpy(ref.state_dict()), 3)
    with jax.default_matmul_precision("highest"):
        j, _ = JCNN(**kw).apply({"params": params}, jnp.zeros((3, in_ch, 8)), features=jnp.asarray(spec))
    assert latent.shape == (3, chans[-1], n_frames)
    np.testing.assert_allclose(got.numpy(), want, atol=CNN_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=CNN_ATOL, rtol=0)


def test_tcn_from_a_reference_module():
    """The reference's non-causal TCN (LN -> dilated "same" conv -> PReLU
    -> 1x1 residual), imported into the port's TCN: within 5e-5 of the
    module and of the JAX TCN."""
    import jax
    import jax.numpy as jnp

    from mod_extraction_tpu.models.tcn import TCN as JTCN
    from mod_extraction_tpu_torch.models.tcn import TCN

    in_ch, t, k, chans, dils = 6, 60, 5, [8, 8, 8], [1, 2, 4]
    ref = _seeded(RefTCN, in_ch, chans, dils, k, t)
    kw = dict(in_ch=in_ch, kernel_size=k, padding=None, use_ln=True, temporal_dims=[t] * 3, use_res=True,
              is_causal=False)
    model = TCN(chans, dils, **kw).eval()
    model.load_state_dict(tp.reference_state_dict(ref.state_dict(), model))
    x = np.random.default_rng(3).standard_normal((2, in_ch, t)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x)).numpy()
        got = model(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("highest"):
        j = JTCN(chans, dils, **kw).apply({"params": jtp.port_tcn(_numpy(ref.state_dict()), 3)}, jnp.asarray(x))
    np.testing.assert_allclose(got, want, atol=CNN_ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(j), atol=CNN_ATOL, rtol=0)


def test_spectral_tcn_from_a_reference_module():
    """A reference SpectralTCN head (a TCN under `tcn.`, a 1x1 Conv1d
    `output`), imported into the port's SpectralTCN: within 5e-5 of the
    module on the port's log spectrogram, and of the JAX SpectralTCN on the
    same audio."""
    import jax
    import jax.numpy as jnp

    from mod_extraction_tpu.models.tcn import SpectralTCN as JSpectralTCN
    from mod_extraction_tpu_torch.models.tcn import SpectralTCN
    from mod_extraction_tpu_torch.ops.stft import spectrogram

    n, n_fft, hop, k, chans, dils = 4000, 256, 64, 5, (8, 8), (1, 2)
    ref = _seeded(RefSpectralTCN, n_fft // 2 + 1, list(chans), list(dils), k, n // hop + 1)
    kw = dict(n_samples=n, n_fft=n_fft, hop_len=hop, kernel_size=k, out_channels=chans, dilations=dils)
    model = SpectralTCN(**kw).eval()
    model.load_state_dict(tp.reference_state_dict(ref.state_dict(), model))
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 1, n)).astype(np.float32)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
        log_spec = torch.log(torch.clamp(spectrogram(torch.from_numpy(x), n_fft, hop)[:, 0], min=1e-7))
        want = ref(log_spec).numpy()
    params = jtp.port_spectral_tcn(_numpy(ref.state_dict()), 2)
    with jax.default_matmul_precision("highest"):
        j, _ = JSpectralTCN(**kw).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), want, atol=CNN_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=CNN_ATOL, rtol=0)


def test_reference_state_dict_refuses_other_models():
    from mod_extraction_tpu_torch.models.random_lfo import RandomLFO

    with pytest.raises(ValueError, match="RandomLFO"):
        tp.reference_state_dict({}, RandomLFO(4000, 8000.0))


# ------------------------------------------------------------------- the scripts


def _run_script(name, *args):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", name), *args], cwd=ROOT,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("kind", ["lstm", "2dcnn"])
def test_import_script_writes_the_jax_scripts_npz(kind, tmp_path):
    """A reference `.pt` written with `torch.save` through both scripts as
    processes: the same keys and equal arrays (`lstm` by the default kind,
    `2dcnn` with its layer count inferred past the frontend's buffers)."""
    if kind == "lstm":
        sd, argv = _seeded(ReferenceLSTM, 2, 16).state_dict(), []
    else:
        sd, argv = small_cnn().state_dict(), [kind]
    pt = str(tmp_path / "ref.pt")
    torch.save(sd, pt)
    out = {}
    for script in ("import_reference_weights.py", "import_reference_weights_torch.py"):
        npz = str(tmp_path / f"{script}.npz")
        assert _run_script(script, pt, npz, *argv).strip().splitlines()[-1] == f"wrote {npz}"
        with np.load(npz) as f:
            out[script] = {k: f[k] for k in f.files}
    got, want = out["import_reference_weights_torch.py"], out["import_reference_weights.py"]
    assert got.keys() == want.keys()
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    n_params = 5 if kind == "lstm" else 3 * 3 + 2
    assert len(got) == n_params


# ------------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A riff corpus, dry/wet pairs, seeded `.npz` weights of the tiny CNN,
    extractor and LSTM, and reference-layout `.pt` files of the two CNNs
    (`chip_smoke.reference_layout`)."""
    root = str(tmp_path_factory.mktemp("reference"))
    write_corpus(os.path.join(root, "corpus"))
    write_corpus(os.path.join(root, "pairs"), n_files=(2, 1), dur_s=1.5, wet=True)
    w = port_weights(root, 21)
    for name in ("cnn0", "ext0"):
        pt = os.path.join(root, f"{name}.pt")
        torch.save(reference_layout(w[name]), pt)
        w[f"{name}_pt"] = pt
    return root, w


def _extractor_cfg(root, w, key):
    return tbptt_config(os.path.join(root, "pairs"), w["lstm0"], w[key])


def test_lfo_model_weights_path_reads_a_reference_pt(setup):
    """A reference `.pt` as `lfo_model_weights_path`: the port's RunConfig
    builds the extractor the JAX RunConfig builds from it, and its `.npz`
    twin, bit for bit."""
    from mod_extraction_tpu import cli as jcli

    root, w = setup
    cfg = _extractor_cfg(root, w, "ext0_pt")
    sd = tcli.RunConfig(copy.deepcopy(cfg), device="cpu").task.lfo_model.state_dict()
    want = flax_to_state_dict(jcli.RunConfig(copy.deepcopy(cfg)).task.lfo_params["params"])
    npz = tcli.RunConfig(_extractor_cfg(root, w, "ext0"), device="cpu").task.lfo_model.state_dict()
    assert sd.keys() == want.keys() == npz.keys()
    assert all(torch.equal(sd[k], want[k]) and torch.equal(sd[k], npz[k]) for k in sd)


class _TrainerStub:
    """Stands in for both CLIs' Trainer: `fit` returns the warm start's
    weights."""

    def __init__(self, task, data_module, **kw):
        self.warm_start = kw["warm_start_params"]

    def fit(self):
        return self.warm_start()


def test_stage1_init_weights_path_warm_starts_from_a_reference_pt(setup, tmp_path, monkeypatch):
    """Stage 1's `custom.init_weights_path` as a reference `.pt`: the port's
    warm start holds the weights the JAX CLI's does, and those of its
    `.npz` twin."""
    from mod_extraction_tpu import cli as jcli

    root, w = setup
    cfg = lfo_config(os.path.join(root, "corpus"), w["cnn0_pt"])
    monkeypatch.setattr(tcli, "Trainer", _TrainerStub)
    monkeypatch.setattr(jcli, "Trainer", _TrainerStub)
    got = tcli.fit(copy.deepcopy(cfg), out_dir=str(tmp_path), device="cpu")
    path = str(tmp_path / "lfo.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    want = flax_to_state_dict(jcli.fit(path, out_dir=str(tmp_path))["params"])
    npz = flax_to_state_dict(w["cnn0"])
    assert got.keys() == want.keys() == npz.keys()
    assert all(torch.equal(got[k], want[k]) and torch.equal(got[k], npz[k]) for k in got)


def test_tbptt_init_weights_path_refuses_a_pt(setup, tmp_path, monkeypatch):
    """A TBPTT task's `.pt` init weights: `ValueError` naming the port's
    import script, where the JAX CLI raises one naming its own."""
    from mod_extraction_tpu import cli as jcli

    root, w = setup
    cfg = _extractor_cfg(root, w, "ext0")
    cfg["custom"]["init_weights_path"] = w["cnn0_pt"]
    monkeypatch.setattr(tcli, "Trainer", _TrainerStub)
    with pytest.raises(ValueError, match="import_reference_weights_torch.py"):
        tcli.fit(copy.deepcopy(cfg), out_dir=str(tmp_path), device="cpu")
    path = str(tmp_path / "tbptt.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.setattr(jcli, "Trainer", _TrainerStub)
    with pytest.raises(ValueError, match="import_reference_weights.py"):
        jcli.fit(path, out_dir=str(tmp_path))


def test_ckpt_path_validates_from_a_reference_pt(setup, tmp_path, capsys):
    """`ckpt_path` as a reference `.pt` validates a stage-1 config to the
    table of its `.npz` twin, and a reference `.pt` on a TBPTT task raises
    `ValueError` naming the import script."""
    root, w = setup
    corpus = os.path.join(root, "corpus")
    tables, metrics = [], []
    for key in ("cnn0_pt", "cnn0"):
        metrics.append(tcli.validate(lfo_eval_config(corpus, w[key]), out_dir=str(tmp_path), device="cpu"))
        tables.append(capsys.readouterr().out)
    assert metrics[0] == metrics[1] and tables[0] == tables[1] and "val/loss" in tables[0]
    cfg = _extractor_cfg(root, w, "ext0")
    cfg["ckpt_path"] = w["ext0_pt"]
    with pytest.raises(ValueError, match="import_reference_weights_torch.py"):
        tcli.validate(cfg, out_dir=str(tmp_path), device="cpu")


def test_ckpt_path_restores_a_port_checkpoint(setup, tmp_path):
    """A checkpoint of the port as `ckpt_path` restores as before, and as
    bare weights it is refused with the message naming
    `scripts/extract_torch_weights.py`."""
    root, w = setup
    cfg = lfo_eval_config(os.path.join(root, "corpus"))
    run = tcli.RunConfig(copy.deepcopy(cfg), device="cpu")
    run.task.model.load_state_dict(flax_to_state_dict(w["cnn1"]))
    ckpt = str(tmp_path / "state.pt")
    torch.save({"task": run.task.state_dict(), "step": 5}, ckpt)
    assert tp.load_pt(ckpt)[0] == tp.CHECKPOINT
    fresh = tcli.RunConfig(copy.deepcopy(cfg), device="cpu")
    trainer = tcli.Trainer(fresh.task, fresh.data_module, out_dir=str(tmp_path), run_name="r")
    tcli._load_eval_state(fresh, trainer, ckpt)
    want = flax_to_state_dict(w["cnn1"])
    assert all(torch.equal(v, want[k]) for k, v in fresh.task.model.state_dict().items())
    with pytest.raises(NotImplementedError, match="extract_torch_weights.py"):
        tcli._load_lfo_weights(fresh.task.model, ckpt)


@pytest.mark.parametrize("content", ["list", "mapping_of_numbers", "empty"])
def test_a_pt_of_neither_kind_names_both(content, setup, tmp_path):
    """A `.pt` that is neither a flat mapping of tensors nor a port
    checkpoint: the loader, the CLI and the import script refuse it naming
    both kinds."""
    root, w = setup
    obj = {"list": [torch.zeros(3)], "mapping_of_numbers": {"cnn.1.weight": 1.0}, "empty": {}}[content]
    pt = str(tmp_path / "odd.pt")
    torch.save(obj, pt)
    match = "reference state_dict.*checkpoint of the port"
    with pytest.raises(ValueError, match=match):
        tp.load_pt(pt)
    with pytest.raises(ValueError, match=match):
        tcli._load_lfo_weights(tcli.RunConfig(lfo_eval_config(os.path.join(root, "corpus")), "cpu").task.model, pt)
    script = os.path.join(ROOT, "scripts", "import_reference_weights_torch.py")
    proc = subprocess.run([sys.executable, script, pt, str(tmp_path / "out.npz"), "2dcnn"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "checkpoint of the port" in proc.stderr


_RAN = []


def _ran():
    _RAN.append(1)


class _Payload:
    """Pickles as a call of `_ran`: loading it runs code."""

    def __reduce__(self):
        return (_ran, ())


def test_weights_only_refuses_pickled_objects(tmp_path):
    """`.pt` files load with `weights_only=True`, a deliberate difference
    from the JAX package's `weights_only=False`: a pickled non-tensor object
    is refused and its code does not run, where `weights_only=False` runs
    it; a bare state_dict loads the same either way."""
    pt = str(tmp_path / "payload.pt")
    torch.save({"cnn.1.weight": torch.zeros(2), "extra": _Payload()}, pt)
    with pytest.raises(ValueError, match="weights_only=True"):
        tp.load_pt(pt)
    assert _RAN == []
    torch.load(pt, weights_only=False)
    assert _RAN == [1]
    _RAN.clear()
    sd = _seeded(ReferenceLSTM, 2, 8).state_dict()
    torch.save(sd, pt)
    kind, got = tp.load_pt(pt)
    full = torch.load(pt, weights_only=False)
    assert kind == tp.REFERENCE and got.keys() == full.keys() == sd.keys()
    assert all(torch.equal(got[k], full[k]) for k in sd)


# --------------------------------------------------------------------- streaming


def test_imported_egfx_phaser_lstm_streams(tmp_path):
    """The shipped egfx-phaser LSTM-64 as a reference-layout `.pt`, imported
    (its weights bit for bit the `.npz`'s), within 2e-6 of the reference
    module, and through `StreamingEffectModel` on the CPU: stereo chunked
    at random buffers of 37-516 within 1e-5 of one call."""
    from mod_extraction_tpu_torch.export.streaming import StreamingEffectModel

    pt = str(tmp_path / "egfx_ph.pt")
    torch.save(reference_layout(EGFX_PHASER), pt)
    kind, sd = tp.load_pt(pt)
    assert kind == tp.REFERENCE
    model = LSTMEffectModel(n_hidden=64)
    model.load_state_dict(tp.reference_state_dict(sd, model))
    npz = flax_lstm_to_state_dict(EGFX_PHASER)
    assert all(torch.equal(v, npz[k]) for k, v in model.state_dict().items())

    ref = ReferenceLSTM().eval()
    ref.load_state_dict(sd)
    rng = np.random.default_rng(6)
    x = (0.2 * rng.standard_normal((2, 1, 400))).astype(np.float32)
    lat = rng.uniform(0, 1, (2, 1, 400)).astype(np.float32)
    with torch.no_grad():
        y, _ = model(torch.from_numpy(x), torch.from_numpy(lat), lstm_init_state(2, 64))
        want = ref(torch.from_numpy(x), torch.from_numpy(lat))
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=LSTM_ATOL, rtol=0)

    sm = StreamingEffectModel(model, n_channels=2, device="cpu")
    total = 2048
    audio = rng.uniform(-0.4, 0.4, (2, total)).astype(np.float32)
    y_full, _ = sm.process_np(sm.init_state(), audio)
    state, outs, i = sm.init_state(), [], 0
    while i < total:
        n = min(int(rng.integers(37, 517)), total - i)
        y, state = sm.process_np(state, audio[:, i : i + n])
        outs.append(y)
        i += n
    np.testing.assert_allclose(np.concatenate(outs, -1), y_full, atol=STREAM_ATOL, rtol=0)
