"""`bench_torch.py`, the port's bench, against `bench.py` on the CPU: the
same analytic FLOPs, JSON lines that hold every key of `bench.py`'s, and no
CPU fallback (the timing itself is meaningful only on the card)."""

import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _load("bench")
BENCH_TORCH = _load("bench_torch")


@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize(
    "kwargs",
    [{}, {"channels": (2, 32, 32, 32), "kernel": (3, 9)}, {"n_samples": 44100, "n_mels": 128, "pool_h": 3},
     {"hop_len": 512, "n_fft": 2048}],
    ids=["paper", "narrow", "short", "wide_fft"],
)
def test_model_flops_equal_bench(batch, kwargs):
    assert BENCH_TORCH.train_step_model_flops(batch, **kwargs) == BENCH.train_step_model_flops(batch, **kwargs)


def _bench_lines(monkeypatch):
    """bench.py's two JSON lines, its measurements stubbed out."""
    monkeypatch.setattr(BENCH, "bench_ours", lambda **k: 100.0)
    monkeypatch.setattr(BENCH, "bench_reference_torch_cpu", lambda n=5: 10.0)
    monkeypatch.setattr(BENCH, "bench_tbptt", lambda: 50.0)
    monkeypatch.setattr(BENCH, "bench_tbptt_reference_torch_cpu", lambda: 5.0)
    lines = {}
    for argv in (["bench.py"], ["bench.py", "--tbptt"]):
        monkeypatch.setattr(BENCH.sys, "argv", argv)
        out = io.StringIO()
        with redirect_stdout(out):
            BENCH.main()
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        lines[line["metric"]] = line
    return lines


def test_json_lines_hold_bench_keys(monkeypatch):
    ref = _bench_lines(monkeypatch)
    profiled = {"step_ms": 12.0, "busy_ms": 9.0, "idle_share": 0.25}
    opts = dict(conv_impl="lax", wgrad_impl="xla", stft_impl="auto", act_io_dtype="float32")
    ours = {
        "lfo_train_throughput": BENCH_TORCH.lfo_line(1.0, 0.1, 32, profiled, "card, 700.00 W", opts),
        "tbptt_train_throughput": BENCH_TORCH.tbptt_line(1.0, 32, 83, profiled, "card, 700.00 W"),
    }
    assert set(ours) == set(ref)
    for metric, line in ours.items():
        assert set(ref[metric]) <= set(line), set(ref[metric]) - set(line)
        assert line["unit"] == ref[metric]["unit"]
        assert line["vs_baseline"] is None and line["baseline_value"] is None
        assert {"step_ms", "busy_ms", "idle_share", "card"} <= set(line)
        json.dumps(line)


@pytest.mark.parametrize("mode", ["lfo", "tbptt"])
def test_bench_raises_without_a_card(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = BENCH_TORCH.bench_lfo if mode == "lfo" else BENCH_TORCH.bench_tbptt
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(batch_size=2, n_steps=1)


def test_defaults_follow_bench():
    """Batch 256 (stage 1) and 32 (TBPTT); lax / xla / auto / float32."""
    args = BENCH_TORCH.parse_args([])
    assert (args.conv_impl, args.wgrad_impl, args.stft_impl, args.act_io) == ("lax", "xla", "auto", "float32")
    import inspect

    sig = inspect.signature(BENCH_TORCH.bench_lfo).parameters
    assert sig["batch_size"].default == 256
    assert inspect.signature(BENCH_TORCH.bench_tbptt).parameters["batch_size"].default == 32
    assert BENCH_TORCH.PEAK_FLOPS == 989e12 or "BENCH_PEAK_TFLOPS" in os.environ
