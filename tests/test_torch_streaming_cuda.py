"""The loaded processor artifact's `process_np` on the card: a buffer shape
seen before replays the program as a CUDA graph, captured at the shape's
second call, and every call equals the eager program (`process`) bit for
bit: output, h, c and phase.  Also the helpers
`tests/test_torch_streaming.py` uses for its CPU cases of the same API.
This file imports torch, numpy and the port only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_streaming_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from mod_extraction_tpu_torch.export import streaming as tstream
from mod_extraction_tpu_torch.ops import lstm_kernels
from mod_extraction_tpu_torch.utils import spans

EGFX = "models/lstm_64__lfo_2dcnn_io_sa_25_25_no_ch_ln__egfx_ph_2_peak.npz"
CHORUS_H160 = "models/lstm_160__lfo_2dcnn_r6__sim_chorus.npz"
KNOBS = dict(lfo_rate=1.3, lfo_depth=0.9, stereo_offset=0.5)


def audio(n_channels, total, seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n_channels, total)).astype(np.float32)


def random_knobs(rng):
    """Knobs anywhere in their ranges (`knob_to_params`)."""
    u = rng.uniform(0, 1, 3)
    return dict(lfo_rate=0.1 + 4.9 * u[0], lfo_depth=1.5 * u[1], stereo_offset=2 * math.pi * u[2])


def eager(proc, state, x, lfo_rate, lfo_depth, stereo_offset):
    """The tensor API `process`, the eager program: (y as numpy, state)."""
    knobs = tstream.knob_tensors(proc.device, lfo_rate, lfo_depth, stereo_offset)
    with torch.no_grad():
        y, state = proc.process(state, torch.as_tensor(x, device=proc.device), *knobs)
    return y.cpu().numpy(), state


def same_state(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("h", "c", "phase"))


def snapshot(state):
    return {k: v.clone() for k, v in state.items()}


def span_counts(names):
    found = spans.summary()
    return [found[n]["count"] if n in found else 0 for n in names]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph replays a CUDA kernel; the CPU runs eagerly)")


@pytest.fixture(scope="module")
def shipped_dirs(tmp_path_factory):
    """Stereo exports of the shipped egfx LSTM-64 (K3's register-resident
    forward) and sim_chorus LSTM-160 (its cluster forward)."""
    _need_cuda()
    tmp = str(tmp_path_factory.mktemp("shipped"))
    return {64: tstream.export_streaming_model(EGFX, tmp, "h64"),
            160: tstream.export_streaming_model(CHORUS_H160, tmp, "h160")}


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 160])
def test_replay_matches_eager_on_card(shipped_dirs, hid):
    """200 calls of `process_np` against the eager `process` on one loaded
    processor, bit for bit (output, h, c, phase): knobs changing every call,
    buffers of 128, then 64, then 128 samples, a fresh `init_state()` at
    call 100, and at call 150 the state held from call 140 passed again;
    the held state keeps its values throughout."""
    _need_cuda()
    proc = tstream.load_compiled_processor(shipped_dirs[hid], device="cuda")
    rng = np.random.default_rng(hid)
    sizes = [128] * 70 + [64] * 60 + [128] * 70
    x = (0.5 * rng.standard_normal((2, sum(sizes)))).astype(np.float32)
    s_rep = s_eager = proc.init_state()
    i = 0
    for k, n in enumerate(sizes):
        if k == 100:
            s_rep = s_eager = proc.init_state()
        if k == 140:
            held_rep, held_eager, held_copy = s_rep, s_eager, snapshot(s_rep)
        if k == 150:
            s_rep, s_eager = held_rep, held_eager
        knobs = random_knobs(rng)
        y_rep, s_rep = proc.process_np(s_rep, x[:, i:i + n], **knobs)
        y_eager, s_eager = eager(proc, s_eager, x[:, i:i + n], **knobs)
        assert np.array_equal(y_rep, y_eager), f"call {k}: output differs"
        assert same_state(s_rep, s_eager), f"call {k}: state differs"
        i += n
    assert same_state(held_rep, held_copy)
    assert set(proc.graphs.keys()) == set(proc.graphs.captured()) == {(2, 128), (2, 64)}


@pytest.mark.cuda
def test_replay_shape_cache_is_bounded(shipped_dirs):
    """Twelve buffer shapes two calls each, then the first again twice: at
    most `graphs.size` (8) shapes kept, the least recently used gone, a
    graph for each shape called twice, and every call equal to the eager
    program.  A state of another shape is refused; a buffer of another
    channel count, a 1-d one and an empty one run the eager program, which
    refuses them, and leave the cache as it was."""
    _need_cuda()
    proc = tstream.load_compiled_processor(shipped_dirs[64], device="cuda")
    rng = np.random.default_rng(3)
    sizes = [n for n in range(60, 72) for _ in range(2)] + [60, 60]
    x = (0.5 * rng.standard_normal((2, sum(sizes)))).astype(np.float32)
    s_rep = s_eager = proc.init_state()
    i = 0
    for n in sizes:
        y_rep, s_rep = proc.process_np(s_rep, x[:, i:i + n], **KNOBS)
        y_eager, s_eager = eager(proc, s_eager, x[:, i:i + n], **KNOBS)
        assert np.array_equal(y_rep, y_eager) and same_state(s_rep, s_eager)
        assert len(proc.graphs.keys()) <= proc.graphs.size == 8
        i += n
    kept = [(2, n) for n in range(65, 72)] + [(2, 60)]
    assert proc.graphs.keys() == proc.graphs.captured() == kept
    with pytest.raises(ValueError, match="expected h and c"):
        proc.process_np({k: v[:1] if v.ndim else v for k, v in s_rep.items()}, x[:, :60], **KNOBS)
    for bad in (x[:1, :60], x[0, :60], x[:, :0]):
        with pytest.raises(Exception):
            proc.process_np(s_rep, bad, **KNOBS)
    assert proc.graphs.keys() == kept


@pytest.mark.cuda
def test_replay_spans_count_captures_and_replays(shipped_dirs):
    """Under the profiler: a shape's first call eager, `processor.capture`
    at its second, `processor.replay` at it and at every later; K3's Python
    launch counter ticks in an eager call and in a capture (the captured
    call), not in a replay."""
    _need_cuda()
    proc = tstream.load_compiled_processor(shipped_dirs[160], device="cuda")
    x = audio(2, total=5 * (128 + 64 + 130))
    state, i = proc.init_state(), 0
    lstm_kernels.reset_launch_counts()
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for n in [128] * 5 + [64] * 5 + [130] * 5:
            _, state = proc.process_np(state, x[:, i:i + n], **KNOBS)
            i += n
    names = ("processor.call", "processor.capture", "processor.replay", "processor.run")
    assert span_counts(names) == [15, 3, 12, 15]
    assert lstm_kernels.LAUNCHES["lstm_forward"] == 3 + 3
    spans.clear()
