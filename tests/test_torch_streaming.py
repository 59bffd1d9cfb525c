"""The port's streaming export against the JAX package on the CPU.

The same numpy-seeded audio, knobs (rate 1.3 Hz, depth 0.9, stereo offset
0.5) and uneven buffers over 4096 samples go through the JAX
`StreamingEffectModel(lstm_impl="scan")` and the port's
`StreamingEffectModel(device="cpu")` (K3's operator, plain version), for
the shipped `egfx_ph_2_peak` LSTM-64 and random H 8 weights (as
`tests/test_export_artifact.py` makes them).  Weights files cross between
the two packages both ways, and the port's `torch.export` artifact is held
against its live path, as `tests/test_export_artifact.py` holds the
StableHLO one.

Tolerances: y and h within 1e-5 max-abs of JAX (float32, the LSTM's sums
in another order); c within 1e-5 plus 1e-6 of its magnitude (the shipped
model's cell state grows to |c| ~ 30 over 4096 samples, where a float32 ulp
is 1.9e-6, and the reordered sums drift there by a few ulps); the carried
LFO phase within 1e-6 (the same float32 operations in the same order);
the port chunked against the port full within 1e-6 (c: plus 1e-6 of its
magnitude, as above), and the artifact against the live path within 1e-5.
`PYTHONPATH=. python tests/test_torch_streaming.py` prints the cell-state
differences behind that relative term."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mod_extraction_tpu.export import streaming as jstream
from mod_extraction_tpu.models.lstm import LSTMEffectModel as JLSTM
from mod_extraction_tpu.models.lstm import lstm_init_state as jlstm_init_state
from mod_extraction_tpu.train.checkpoints import load_weights as jload_weights
from mod_extraction_tpu.train.checkpoints import save_weights as jsave_weights
from mod_extraction_tpu_torch.export import streaming as tstream
from mod_extraction_tpu_torch.models.convert import flax_lstm_to_state_dict, lstm_state_dict_to_flax
from mod_extraction_tpu_torch.models.lstm import LSTMEffectModel
from mod_extraction_tpu_torch.ops import lstm_kernels
from mod_extraction_tpu_torch.train.checkpoints import load_weights, save_weights
from mod_extraction_tpu_torch.utils import spans
from test_torch_streaming_cuda import eager, random_knobs, same_state, snapshot, span_counts

EGFX = "models/lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz"
KNOBS = dict(lfo_rate=1.3, lfo_depth=0.9, stereo_offset=0.5)
TOTAL = 4096
ATOL = 1e-5
C_RTOL = 1e-6
PHASE_ATOL = 1e-6


def _random_params(n_hidden=8):
    model = JLSTM(in_ch=1, out_ch=1, n_hidden=n_hidden, latent_dim=1)
    x = jnp.zeros((2, 1, 16))
    state = jlstm_init_state(2, n_hidden)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), x, x, state))


def _buffers(seed=0, total=TOTAL, lo=64, hi=1024, first=None):
    """Uneven buffer lengths covering `total` samples."""
    rng = np.random.default_rng(seed)
    sizes = [] if first is None else [first]
    while sum(sizes) < total:
        sizes.append(min(int(rng.integers(lo, hi)), total - sum(sizes)))
    return sizes


def _audio(n_channels, seed=1, total=TOTAL):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n_channels, total)).astype(np.float32)


def _stream(proc, x, sizes, **knobs):
    """Drive `proc` buffer by buffer; (y, final state as numpy)."""
    state, outs, i = proc.init_state(), [], 0
    for n in sizes:
        y, state = proc.process_np(state, x[:, i : i + n], **knobs)
        outs.append(y)
        i += n
    return np.concatenate(outs, axis=-1), {k: np.asarray(v) for k, v in state.items()}


WEIGHTS = {"egfx_ph_2_peak": lambda: {"params": jload_weights(EGFX)}, "random_h8": _random_params}


@pytest.fixture(scope="module", params=list(WEIGHTS))
def case(request):
    """(params, n_hidden, the JAX stream of the stereo input, its buffers)."""
    params = WEIGHTS[request.param]()
    hid = params["params"]["w_hh"].shape[0]
    jm = jstream.StreamingEffectModel(params, n_hidden=hid, lstm_impl="scan")
    sizes = _buffers()
    return params, hid, _stream(jm, _audio(2), sizes, **KNOBS), sizes


def test_stream_matches_jax(case):
    params, _, (y_j, s_j), sizes = case
    tm = tstream.StreamingEffectModel(params, device="cpu")
    y_t, s_t = _stream(tm, _audio(2), sizes, **KNOBS)
    assert y_t.shape == y_j.shape == (2, TOTAL)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_t["h"], s_j["h"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_t["c"], s_j["c"], atol=ATOL, rtol=C_RTOL)
    np.testing.assert_allclose(s_t["phase"], s_j["phase"], atol=PHASE_ATOL, rtol=0)


def test_chunked_matches_full(case):
    params = case[0]
    tm = tstream.StreamingEffectModel(params, device="cpu")
    x = _audio(2)
    y_full, s_full = _stream(tm, x, [TOTAL], **KNOBS)
    y_chunk, s_chunk = _stream(tm, x, _buffers(seed=5, lo=1, hi=700, first=1), **KNOBS)
    np.testing.assert_allclose(y_chunk, y_full, atol=1e-6, rtol=0)
    for k in s_full:
        np.testing.assert_allclose(s_chunk[k], s_full[k], atol=1e-6, rtol=C_RTOL if k == "c" else 0)


def test_mono_matches_jax(case):
    params, hid = case[0], case[1]
    sizes = _buffers(seed=2)
    jm = jstream.StreamingEffectModel(params, n_hidden=hid, n_channels=1, lstm_impl="scan")
    tm = tstream.StreamingEffectModel(params, n_channels=1, device="cpu")
    y_j, s_j = _stream(jm, _audio(1), sizes, **KNOBS)
    y_t, s_t = _stream(tm, _audio(1), sizes, **KNOBS)
    assert y_t.shape == (1, TOTAL)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_t["h"], s_j["h"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_t["c"], s_j["c"], atol=ATOL, rtol=C_RTOL)
    np.testing.assert_allclose(s_t["phase"], s_j["phase"], atol=PHASE_ATOL, rtol=0)


def test_processor_runs_k3_operator(case, monkeypatch):
    """Every buffer is one call of K3's operator, whose CPU implementation
    is the plain version; the parameters are frozen, so no training
    kernel is reached."""
    calls = []
    plain = lstm_kernels.lstm_forward_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(lstm_kernels, "lstm_forward_plain", counted)
    tm = tstream.StreamingEffectModel(case[0], device="cpu")
    assert not any(p.requires_grad for p in tm.parameters())
    sizes = [1, 5, 300]
    _stream(tm, _audio(2, total=306), sizes, **KNOBS)
    assert [s[-1] for s in calls] == sizes and all(s[0] == 2 for s in calls)


@pytest.mark.parametrize(
    "knobs",
    [{}, {"lfo_rate": 0.0, "lfo_depth": 1.0, "lfo_stereo_phase_offset": 1.0},
     {"lfo_rate": 0.37, "lfo_depth": 0.25, "lfo_stereo_phase_offset": 0.5}],
)
def test_knob_to_params_equal(knobs):
    assert tstream.knob_to_params(knobs) == jstream.knob_to_params(knobs)


def test_metadata_matches_jax(tmp_path):
    """The same metadata keys and values as the JAX export, apart from the
    artifact's name and platforms."""
    params = _random_params()
    assert tstream.DEFAULT_METADATA == jstream.DEFAULT_METADATA
    j_dir = jstream.export_streaming_model(params, str(tmp_path / "jax"), "m", n_hidden=8)
    t_dir = tstream.export_streaming_model(params, str(tmp_path / "torch"), "m")
    j_meta = json.loads((tmp_path / "jax" / "m" / "metadata.json").read_text())
    t_meta = json.loads((tmp_path / "torch" / "m" / "metadata.json").read_text())
    assert set(t_meta) == set(j_meta)
    differ = {k for k in j_meta if t_meta[k] != j_meta[k]}
    assert differ == {"compiled_artifact", "compiled_artifact_platforms"}
    assert t_meta["compiled_artifact"] == tstream.ARTIFACT_NAME == "processor.pt2"
    assert t_meta["compiled_artifact_platforms"] == ["cpu", "cuda"]
    assert j_dir.endswith("m") and t_dir.endswith("m")


def test_port_export_streams_in_jax(tmp_path, case):
    """A `weights.npz` written by the port loads in the JAX package's
    `load_streaming_model` (and `load_weights`) and streams as the port does."""
    params, _, _, sizes = case
    target = tstream.export_streaming_model(params, str(tmp_path), "m", with_artifact=False)
    jm = jstream.load_streaming_model(target)
    jm.lstm_impl = "scan"
    tm = tstream.load_streaming_model(target, device="cpu")
    y_j, _ = _stream(jm, _audio(2), sizes, **KNOBS)
    y_t, _ = _stream(tm, _audio(2), sizes, **KNOBS)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=0)
    on_disk = jload_weights(f"{target}/weights.npz")
    for k, v in flax_lstm_to_state_dict(params).items():
        np.testing.assert_array_equal(flax_lstm_to_state_dict(on_disk)[k].numpy(), v.numpy())


def test_jax_export_streams_in_port(tmp_path, case):
    """A JAX export directory loads in the port's `load_streaming_model`
    and streams as JAX does."""
    params, hid, (y_j, _), sizes = case
    target = jstream.export_streaming_model(params, str(tmp_path), "m", n_hidden=hid,
                                            with_artifact=False)
    tm = tstream.load_streaming_model(target, device="cpu")
    assert tm.n_hidden == hid and tm.n_channels == 2
    y_t, _ = _stream(tm, _audio(2), sizes, **KNOBS)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_channels", [2, 1], ids=["stereo", "mono"])
def test_artifact_matches_live_path(tmp_path, n_channels):
    """The reloaded `.pt2` against the live processor over uneven buffers,
    a single sample among them, without the model code on its path."""
    params = _random_params()
    target = tstream.export_streaming_model(
        params, str(tmp_path), "m", metadata_overrides={"is_input_mono": n_channels == 1})
    live = tstream.load_streaming_model(target, device="cpu")
    compiled = tstream.load_compiled_processor(target, device="cpu")
    assert compiled.n_channels == live.n_channels == n_channels
    x = _audio(n_channels, total=2048)
    y_live, s_live = _stream(live, x, [2048], **KNOBS)
    sizes = _buffers(seed=4, total=2048, lo=48, hi=600, first=1)
    y_art, s_art = _stream(compiled, x, sizes, **KNOBS)
    np.testing.assert_allclose(y_art, y_live, atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_art["h"], s_live["h"], atol=ATOL, rtol=0)


def test_artifact_has_one_symbolic_dimension(tmp_path):
    """One symbolic dimension, the buffer length of x; the weights inside
    the program; K3 as one node of its graph."""
    target = tstream.export_streaming_model(_random_params(), str(tmp_path), "m")
    ep = tstream.load_compiled_processor(target, device="cpu").exported
    assert len(ep.range_constraints) == 1
    dims = [d for n in ep.graph.nodes if n.op == "placeholder" for d in n.meta["val"].shape
            if not isinstance(d, int)]
    assert len(dims) == 1
    assert {k.split(".")[-1] for k in ep.state_dict} == {"w_ih", "w_hh", "b_gates", "fc_kernel", "fc_bias"}
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.mod_extraction_tpu_torch.lstm_forward.default) == 1


def test_weights_files_cross_between_packages(tmp_path):
    """`save_weights` / `load_weights` of the two packages read each other's
    files, and `lstm_state_dict_to_flax` inverts `flax_lstm_to_state_dict`."""
    params = jload_weights(EGFX)
    sd = flax_lstm_to_state_dict(params)
    tree = lstm_state_dict_to_flax(sd)
    assert set(tree) == set(params) and set(tree["fc"]) == {"kernel", "bias"}
    save_weights(str(tmp_path / "t.npz"), {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                           for k, v in tree.items()})
    jsave_weights(str(tmp_path / "j.npz"), params)
    for a, b in ((jload_weights(str(tmp_path / "t.npz")), params),
                 (load_weights(str(tmp_path / "j.npz")), params), (tree, params)):
        fa, fb = flax_lstm_to_state_dict(a), flax_lstm_to_state_dict(b)
        assert all(torch.equal(fa[k], fb[k]) for k in fb)
    with np.load(EGFX) as shipped, np.load(tmp_path / "t.npz") as ours:
        assert sorted(shipped.files) == sorted(ours.files)


def _script(name):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_script_matches_jax_script():
    """`scripts/export_torch_models.py` exports the JAX script's models and
    its self-check holds the port's processor (CPU here)."""
    ours, theirs = _script("export_torch_models"), _script("export_neutone_models")
    assert ours.MODEL_NAMES == theirs.MODEL_NAMES
    err = ours.streaming_self_check(tstream.StreamingEffectModel(EGFX, device="cpu"))
    assert err <= 1e-5


def test_streaming_bench_times_k3_at_the_processor_shapes(monkeypatch):
    """`scripts/bench_torch_streaming.py` times K3 on the arguments the
    processor gives it for one buffer."""
    seen = []
    plain = lstm_kernels.lstm_forward_plain
    monkeypatch.setattr(lstm_kernels, "lstm_forward_plain",
                        lambda *a: seen.append([x.shape for x in a]) or plain(*a))
    tm = tstream.StreamingEffectModel(EGFX, device="cpu")
    _stream(tm, _audio(2, total=128), [128], **KNOBS)
    bts = _script("bench_torch_streaming")
    args = bts.k3_args(tm, _audio(2, total=128), np.random.default_rng(0))
    lstm_kernels.lstm_forward(*args)
    assert seen[0] == seen[1]


# -- the loaded artifact's `process_np`: eager on the CPU, a CUDA graph replay
#    on the card; either way a state a caller holds keeps its values


@pytest.fixture(scope="module", params=[2, 1], ids=["stereo", "mono"])
def artifact_dir(request, tmp_path_factory):
    """An exported H 8 processor (the port's seeded init), stereo or mono."""
    model = LSTMEffectModel(n_hidden=8, generator=torch.Generator().manual_seed(5))
    return tstream.export_streaming_model(model, str(tmp_path_factory.mktemp("art")), "m",
                                          metadata_overrides={"is_input_mono": request.param == 1})


def test_compiled_process_np_is_eager_on_cpu(artifact_dir):
    """On the CPU `process_np` runs the eager program, bit for bit `process`
    over buffers of three sizes and changing knobs, and captures nothing: no
    graph kept, no `processor.capture` or `processor.replay` span."""
    proc = tstream.load_compiled_processor(artifact_dir, device="cpu")
    rng = np.random.default_rng(7)
    x = _audio(proc.n_channels, total=64 + 128 + 130)
    s_np = s_eager = proc.init_state()
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        i = 0
        for n in (64, 128, 130):
            knobs = random_knobs(rng)
            y_np, s_np = proc.process_np(s_np, x[:, i:i + n], **knobs)
            y_eager, s_eager = eager(proc, s_eager, x[:, i:i + n], **knobs)
            assert np.array_equal(y_np, y_eager) and same_state(s_np, s_eager)
            i += n
    assert span_counts(("processor.call", "processor.capture", "processor.replay")) == [3, 0, 0]
    assert proc.graphs.keys() == []
    spans.clear()


@pytest.mark.parametrize("n", [64, 128, 130])
def test_held_state_reruns_the_same(artifact_dir, n):
    """A state `process_np` returned gives the same output and state when it
    is passed again after two later calls, and keeps its values meanwhile."""
    proc = tstream.load_compiled_processor(artifact_dir, device="cpu")
    x = _audio(proc.n_channels, total=3 * n)
    _, state = proc.process_np(proc.init_state(), x[:, :n], **KNOBS)
    held = snapshot(state)
    y1, s1 = proc.process_np(state, x[:, n:2 * n], **KNOBS)
    proc.process_np(s1, x[:, 2 * n:], **KNOBS)
    assert same_state(state, held)
    y1_again, s1_again = proc.process_np(state, x[:, n:2 * n], **KNOBS)
    assert np.array_equal(y1_again, y1) and same_state(s1_again, s1)


def c_report():
    """The carried cell state against JAX for the cases above: for each,
    the largest |dc|, |c| at that element, and the largest share of the
    limit ATOL + C_RTOL |c| that any element uses."""
    for name, make in WEIGHTS.items():
        params = make()
        hid = params["params"]["w_hh"].shape[0]
        for n_ch, sizes in ((2, _buffers()), (1, _buffers(seed=2))):
            jm = jstream.StreamingEffectModel(params, n_hidden=hid, n_channels=n_ch, lstm_impl="scan")
            tm = tstream.StreamingEffectModel(params, n_channels=n_ch, device="cpu")
            c_j = _stream(jm, _audio(n_ch), sizes, **KNOBS)[1]["c"]
            c_t = _stream(tm, _audio(n_ch), sizes, **KNOBS)[1]["c"]
            d, mag = np.abs(c_t - c_j), np.abs(c_j)
            i = np.unravel_index(d.argmax(), d.shape)
            print(f"{name}, {n_ch} channel(s): max |dc| {d[i]:.3e} at |c| {mag[i]:.3f} "
                  f"({d[i] / mag[i]:.3e} of it), share of the limit {(d / (ATOL + C_RTOL * mag)).max():.3f}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_streaming.py: the numbers behind C_RTOL
    jax.config.update("jax_platforms", "cpu")
    c_report()
