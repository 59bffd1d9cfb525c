"""The yardstick's copied counts equal their sources and the numbers the
issue that defined the benchmark quotes."""

import importlib.util

import pytest

from benchmark.harness import counts
from benchmark.harness.common import ROOT, load_json


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_src_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage1_flops():
    assert counts.train_step_model_flops(99) == pytest.approx(14.129e12, rel=1e-3)
    assert counts.train_step_model_flops(99) == _load("bench_torch").train_step_model_flops(99)


@pytest.mark.parametrize("hid,gflop", [(64, 3.412), (160, 20.610)])
def test_lstm_chunk(hid, gflop):
    f = counts.lstm_ops_bytes(32, 1024, hid, 2, 1, save_states=True)[0]
    b = counts.lstm_ops_bytes(32, 1024, hid, 2, 1, backward=True)[0]
    assert (f + b) / 1e9 == pytest.approx(gflop, rel=1e-3)


def test_lstm_ops_bytes_is_chip_smokes():
    src = (ROOT / "chip_smoke.py").read_text()
    start = src.index("def lstm_ops_bytes(")
    end = src.index("\n\n\n", start)
    ns = {}
    exec(src[start:end], ns)  # the function alone: chip_smoke.py's imports need a card
    for args in [(32, 1024, 64, 2, 1), (32, 1024, 160, 2, 1), (2, 128, 160, 2, 1)]:
        for kw in ({}, {"save_states": True}, {"backward": True}):
            assert counts.lstm_ops_bytes(*args, **kw) == ns["lstm_ops_bytes"](*args, **kw)


def test_extractor_split_sums_to_the_step():
    ex = load_json(ROOT / "benchmark/configs/pipeline_h64.json")["extractor"]
    bf16, f32 = counts.extractor_flops(99, ex, 88200, backward=True)
    assert bf16 + f32 == pytest.approx(counts.train_step_model_flops(99))
    assert counts.least_seconds(bf16, f32) * 1e3 == pytest.approx(16.5, rel=0.02)


def test_tbptt_step_least_time():
    ex = load_json(ROOT / "benchmark/configs/pipeline_h64.json")["extractor"]
    bf16, f32 = counts.tbptt_step_flops(32, 88200, ex, 64, 1024, 1024, 83)
    assert counts.least_seconds(bf16, f32) * 1e3 == pytest.approx(6.5, rel=0.05)


def test_render_bytes():
    assert counts.render_bytes(99, 88200, 882) == 99 * (88200 * 10 + 2 * 882 * 4)
